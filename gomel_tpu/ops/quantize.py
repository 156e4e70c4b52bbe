"""Device-side PNG quantization — fuse the image quantizer into the encoder.

The file-level encode path (Phase.to_phase_wav) historically read the full
float32 spectrogram back to host ([F, num_freqs, 2] — ~14 MB for 30 s at
the CLI config) and quantized there (io/imagecodec.save_phase_image). The
quantizer is pure elementwise work plus a global per-channel min/max — an
ideal device fusion: running it inside the same jit as the encoder cuts
host<->device traffic 4x (8-bit: two uint8 planes instead of two float32
channels) and removes the host-side normalize/trunc pass entirely.

Byte parity: the host path quantizes in float64, this path in float32 (device
native). trunc(max_val * norm) can flip by one quantization step when the
f32 vs f64 rounding of norm straddles an integer boundary — measured rate
~1e-5 of pixels (tests/test_device_quantize.py asserts <=1 step, rare).
The B (conjugate-hint) channel and metadata bytes are assembled HOST-side
from the returned planes/extrema, byte-identically to the host quantizer:
B = (-v0) & max_val needs only the quantized v0 because trunc is odd
(trunc(-x) == -trunc(x); /root/reference/phase/impl.go:229,256).

Reference quantizer semantics reproduced (phase/impl.go:168-278):
truncation toward zero, clip to [0, max_val], degenerate-range channels
pinned at norm = 0.5, asinh IHS passes applied pre-quantization.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def quantize_planes(spec2: jax.Array, max_val: int, ihs_passes: int = 0
                    ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Quantize a phase spectrogram [F, nf, 2] to image planes on device.

    Returns (img2 [nf, F, 2] uint8|uint16 in image (row=bin) layout,
    maxs [2] f32, mins [2] f32). maxs/mins are the PRE-normalization
    per-channel extrema after IHS — exactly what the PNG metadata stores
    (phase/impl.go:198-222).
    """
    for _ in range(ihs_passes):
        spec2 = jnp.arcsinh(spec2)
    maxs = spec2.max(axis=(0, 1))
    mins = spec2.min(axis=(0, 1))
    rng = maxs - mins
    norm = jnp.where(rng > 0,
                     (spec2 - mins) / jnp.where(rng > 0, rng, 1.0), 0.5)
    q = jnp.clip(jnp.trunc(max_val * norm), 0, max_val)
    dtype = jnp.uint16 if max_val > 255 else jnp.uint8
    return q.transpose(1, 0, 2).astype(dtype), maxs, mins


def dequantize_planes(img2: jax.Array, maxs: jax.Array, mins: jax.Array,
                      max_val: int, ihs_passes: int = 0) -> jax.Array:
    """Inverse of :func:`quantize_planes` for the decode fast path: integer
    image planes [nf, F, 2] -> spectrogram [F, nf, 2] float32 (rescale per
    channel + sinh IHS undo, phase/impl.go:109-147), on device."""
    spec = img2.astype(jnp.float32).transpose(1, 0, 2) / float(max_val)
    spec = spec * (maxs - mins).astype(jnp.float32) + mins.astype(jnp.float32)
    for _ in range(ihs_passes):
        spec = jnp.sinh(spec)
    return spec


def quantize_mel_plane(spec2: jax.Array, max_val: int = 255
                       ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Mel variant: GLOBAL (not per-channel) min/max (mel/impl.go:138-152).

    Returns (img2 [mels, F, 2] uint8, mgc_max scalar, mgc_min scalar).
    Degenerate range pins norm at 0.5 like the host writer."""
    mgc_max = spec2.max()
    mgc_min = spec2.min()
    rng = mgc_max - mgc_min
    norm = jnp.where(rng > 0,
                     (spec2 - mgc_min) / jnp.where(rng > 0, rng, 1.0), 0.5)
    q = jnp.clip(jnp.trunc(max_val * norm), 0, max_val)
    return q.transpose(1, 0, 2).astype(jnp.uint8), mgc_max, mgc_min


def dequantize_mel_plane(img2: jax.Array, mgc_max: jax.Array,
                         mgc_min: jax.Array, max_val: int = 255) -> jax.Array:
    """Inverse of :func:`quantize_mel_plane` for the mel decode fast path:
    integer planes [mels, F, 2] -> log-mel [F, mels, 2] float32 via the
    GLOBAL min/max rescale (mel/impl.go:109-116), on device."""
    spec = img2.astype(jnp.float32).transpose(1, 0, 2) / float(max_val)
    return spec * (mgc_max - mgc_min).astype(jnp.float32) \
        + mgc_min.astype(jnp.float32)


def dequantize_raw(img, maxs, mins, max_val: int, ihs_passes: int = 0,
                   boost: float = 0.0, dtype=jnp.float32) -> jax.Array:
    """Layout-agnostic de-quantization core: rescale by extrema (broadcast
    against ``img``'s trailing axes — per-channel [2] for phase planes,
    scalars for mel), sinh IHS undo, then an additive log-domain boost.
    The single source of the rescale math for the fused file-decode
    programs (pipelines and the sharded long-form variants alike)."""
    s = img.astype(dtype) / float(max_val)
    s = s * (jnp.asarray(maxs) - jnp.asarray(mins)).astype(dtype) \
        + jnp.asarray(mins).astype(dtype)
    for _ in range(ihs_passes):
        s = jnp.sinh(s)
    if boost != 0.0:
        s = s + jnp.asarray(boost, s.dtype)
    return s


def pcm16_ingest(pcm: jax.Array, dtype, scale: float, pad_to: int = 0,
                 zp: int = 0, zs: int = 0) -> jax.Array:
    """Shared device prologue of the raw-PCM fused encode programs:
    int16 -> float (exact: ``scale`` is a power of two), stereo mean
    ([L, 2] input; exact — the f32 sum of two int16 is exact), zero-stuff
    upsample, reference padding. Bit-identical to the host float prep
    (pinned by tests/test_device_quantize.py)."""
    from .resample import zero_stuff_upsample
    x = pcm.astype(dtype)
    if x.ndim == 2:
        x = x.mean(axis=1)
    x = x / float(scale)
    if zp > 0:
        x = zero_stuff_upsample(x, zp, zs)
    if pad_to > x.shape[0]:
        x = jnp.pad(x, (0, pad_to - x.shape[0]))
    return x


def pcm16_encode(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Float audio -> (int16 PCM, all-finite flag): the io.audio.save_wav
    conversion (clip to [-1, 1], rint of x*32768, saturate) run ON DEVICE,
    so file-decode paths read back 2-byte samples instead of 4-byte floats
    (halves the decode readback).

    Bit-identical to the host conversion of the same f32 wave: *32768 is a
    power-of-two scale (exact in both f32 and f64), so rint sees the same
    value either way. The finite flag rides back in the same transfer —
    the host checks it before writing (save_wav's NaN/Inf error contract).
    """
    finite = jnp.isfinite(x).all()
    x = jnp.clip(x, -1.0, 1.0)
    pcm = jnp.clip(jnp.rint(x * 32768.0), -32768.0, 32767.0)
    return pcm.astype(jnp.int16), finite


# -- batched variants (per-ROW extrema: each batch row is its own image) ----
#
# Batches are length-bucketed (parallel/batch.py): rows share a padded frame
# count but differ in TRUE frame count. The extrema that define each row's
# quantization grid must come from the row's REAL frames only (the host path
# slices to the true count before quantizing, cli/batch.py) — so the batch
# quantizers take an optional per-row ``frames`` vector and mask the padding
# frames out of the max/min. Quantized values in the padding region are
# meaningless and are sliced off host-side before the PNG write.

def _masked_extrema(spec2: jax.Array, n_frames, axes):
    """Per-channel (or global, axes=None) extrema over the first n_frames
    frames of [F, ..., 2]."""
    mask = (jnp.arange(spec2.shape[0]) < n_frames).reshape(
        (-1,) + (1,) * (spec2.ndim - 1))
    big = jnp.asarray(jnp.finfo(spec2.dtype).max, spec2.dtype)
    mx = jnp.where(mask, spec2, -big)
    mn = jnp.where(mask, spec2, big)
    if axes is None:
        return mx.max(), mn.min()
    return mx.max(axis=axes), mn.min(axis=axes)


def _quantize_planes_masked(spec2, n_frames, max_val, ihs_passes):
    for _ in range(ihs_passes):
        spec2 = jnp.arcsinh(spec2)
    maxs, mins = _masked_extrema(spec2, n_frames, (0, 1))
    rng = maxs - mins
    norm = jnp.where(rng > 0,
                     (spec2 - mins) / jnp.where(rng > 0, rng, 1.0), 0.5)
    q = jnp.clip(jnp.trunc(max_val * norm), 0, max_val)
    dtype = jnp.uint16 if max_val > 255 else jnp.uint8
    return q.transpose(1, 0, 2).astype(dtype), maxs, mins


def _quantize_mel_masked(spec2, n_frames, max_val):
    mgc_max, mgc_min = _masked_extrema(spec2, n_frames, None)
    rng = mgc_max - mgc_min
    norm = jnp.where(rng > 0,
                     (spec2 - mgc_min) / jnp.where(rng > 0, rng, 1.0), 0.5)
    q = jnp.clip(jnp.trunc(max_val * norm), 0, max_val)
    return q.transpose(1, 0, 2).astype(jnp.uint8), mgc_max, mgc_min


def quantize_planes_batch(spec2b: jax.Array, max_val: int,
                          ihs_passes: int = 0, frames: jax.Array | None = None
                          ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Batched :func:`quantize_planes`: [B, F, nf, 2] -> (img2 [B, nf, F, 2],
    maxs [B, 2], mins [B, 2]). Each row gets its OWN per-channel extrema —
    rows are independent files, exactly as if quantized one at a time
    (phase/impl.go:198-222 per invocation). ``frames`` [B]: per-row true
    frame counts for length-bucketed batches (extrema exclude pad frames)."""
    if frames is None:
        return jax.vmap(
            lambda s: quantize_planes(s, max_val, ihs_passes))(spec2b)
    return jax.vmap(
        lambda s, n: _quantize_planes_masked(s, n, max_val, ihs_passes)
    )(spec2b, jnp.asarray(frames))


def dequantize_planes_batch(img2b: jax.Array, maxs: jax.Array,
                            mins: jax.Array, max_val: int,
                            ihs_passes: int = 0) -> jax.Array:
    """Batched :func:`dequantize_planes`: [B, nf, F, 2] + [B, 2]-extrema ->
    [B, F, nf, 2] float32."""
    return jax.vmap(
        lambda i, mx, mn: dequantize_planes(i, mx, mn, max_val, ihs_passes)
    )(img2b, maxs, mins)


def quantize_mel_plane_batch(spec2b: jax.Array, max_val: int = 255,
                             frames: jax.Array | None = None
                             ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Batched :func:`quantize_mel_plane`: [B, F, mels, 2] ->
    (img2 [B, mels, F, 2] uint8, mgc_max [B], mgc_min [B]) with per-row
    GLOBAL extrema (one file per row, mel/impl.go:138-152). ``frames`` [B]:
    per-row true frame counts (extrema exclude pad frames)."""
    if frames is None:
        return jax.vmap(lambda s: quantize_mel_plane(s, max_val))(spec2b)
    return jax.vmap(
        lambda s, n: _quantize_mel_masked(s, n, max_val)
    )(spec2b, jnp.asarray(frames))


def dequantize_mel_plane_batch(img2b: jax.Array, mgc_max: jax.Array,
                               mgc_min: jax.Array,
                               max_val: int = 255) -> jax.Array:
    """Batched :func:`dequantize_mel_plane`: [B, mels, F, 2] + [B] extrema ->
    [B, F, mels, 2] float32."""
    return jax.vmap(
        lambda i, mx, mn: dequantize_mel_plane(i, mx, mn, max_val)
    )(img2b, mgc_max, mgc_min)
