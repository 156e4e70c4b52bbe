"""AOT serving artifacts: portable pre-compiled codec functions.

Production deployments want the codec WITHOUT tracing/compiling at process
start and WITHOUT shipping the framework's Python graph-building code to the
serving fleet. ``jax.export`` gives exactly that: trace + lower once at
build time, serialize the StableHLO artifact, and ``call`` it from any
process (the serving binary only needs jax + the artifact bytes).

This module packages the four codec entry points (mel/phase x encode/decode)
as export builders with the framework's weights and config BAKED INTO the
artifact as constants — a serving artifact is self-contained and immutable:

    from gomel_tpu import serving, MelConfig
    exp = serving.export_mel_encoder(MelConfig.cli_default(), seconds=30.0,
                                     sample_rate=48000, batch=None)
    serving.save_exported(exp, "mel_enc_b_n1440000.jaxexp")
    # ... on the serving host:
    enc = serving.load_exported("mel_enc_b_n1440000.jaxexp")
    logmel = enc.call(audio_batch)          # [B, 1440000] -> [B, F, 192, 2]

Design decisions:
- **Static audio length per artifact** (``seconds`` / ``n_frames``): frame
  math must be static for XLA; serving fleets bucket by length anyway
  (parallel/batch.py uses the same bucketing). The length is rounded up to
  the reference padding grid (core/framing.pad_length) and recorded in the
  artifact's input shape.
- **Symbolic batch dimension by default** (``batch=None``): one artifact
  serves every batch size; pass an int to pin it (pinned batch lets XLA
  specialize tiling and is what bench.py measures).
- **Lowered for CUDA and the CPU** by default (``DEFAULT_PLATFORMS``): one
  artifact built on any host runs on the GPU fleet and on CPU test hosts.
  Every transform is an exact f32 ``jnp.fft`` (cuFFT on the GPU), so the
  artifact computes the same program as the live jit on each platform.
- **PRNG keys are inputs, not baked**: the mel decoder takes a per-example
  ``[B, 2] uint32`` key array (Griffin-Lim init noise, ops/griffinlim.py),
  so reproducibility stays in the caller's hands.

Loaded artifacts compose: ``exp.call`` can be used INSIDE a larger
``jax.jit`` program (tested). ``jax.vmap`` over an artifact is not supported
upstream (no batching rule for ``call_exported``) — export with a symbolic
batch dimension instead, which serves any batch size.

The SHARDED long-form programs export too (``export_longform_*``): the
artifact records the mesh size and in/out shardings; run it with
``call_longform`` on any mesh with the same device count — including
multi-process pods (inputs go through mesh.host_to_global).

Reference scope note: the reference (Go CLI + Python port) has no AOT story
— every process pays full JIT. This module is framework-native added value.
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax import export as jax_export

from .core.config import MelConfig, PhaseConfig
from .core.filterbank import inverse_mel_weights, mel_weights
from .core.framing import pad_length
from .ops.mel_ops import mel_decode, mel_encode, mel_encode_batch
from .ops.phase_ops import phase_decode, phase_encode
from .ops.quantize import (dequantize_mel_plane, dequantize_planes,
                           pcm16_encode, quantize_mel_plane,
                           quantize_planes)
from .ops.stft import hann_window

DEFAULT_PLATFORMS = ("cuda", "cpu")


# -- shape helpers -----------------------------------------------------------

def _batch_dim(batch):
    """int -> that size; None -> a fresh symbolic dimension ``b``."""
    if batch is None:
        return jax_export.symbolic_shape("b")[0]
    if int(batch) <= 0:
        raise ValueError(f"batch must be positive or None, got {batch}")
    return int(batch)


def padded_samples(seconds: float, sample_rate: int, hop: int) -> int:
    """Audio length an artifact accepts: ``seconds`` rounded up to the
    reference padding grid (the minus-one multiple-of-hop scheme,
    core/framing.pad_length)."""
    return pad_length(int(round(seconds * sample_rate)), hop)


def _n_frames(n_samples: int, frame_len: int, hop: int) -> int:
    return (n_samples - frame_len) // hop + 1


# -- builders ----------------------------------------------------------------

def export_mel_encoder(config: MelConfig, *, seconds: float,
                       sample_rate: int, batch=None,
                       dtype=jnp.float32,
                       platforms=DEFAULT_PLATFORMS) -> jax_export.Exported:
    """[B, n_samples] audio -> [B, F, num_mels, 2] log-mel.

    ``n_samples = padded_samples(seconds, sample_rate, config.window)`` —
    callers pad with zeros to the artifact's input shape (exactly the
    reference padding content, mel/impl.go:429-455).
    """
    c = config
    n = padded_samples(seconds, sample_rate, c.window)
    fwd = jnp.asarray(mel_weights(c.n_bins, c.num_mels, c.mel_fmin,
                                  c.mel_fmax), dtype)
    win = jnp.asarray(hann_window(c.resolut), dtype)

    fn = jax.jit(lambda xb: mel_encode_batch(
        xb, c.num_mels, c.resolut, c.window, fwd, win))
    b = _batch_dim(batch)
    spec = jax.ShapeDtypeStruct((b, n), dtype)
    return jax_export.export(fn, platforms=list(platforms))(spec)


def export_mel_decoder(config: MelConfig, *, n_frames: int, batch=None,
                       dtype=jnp.float32,
                       momentum: float = 0.0,
                       platforms=DEFAULT_PLATFORMS) -> jax_export.Exported:
    """([B, F, num_mels, 2] log-mel, [B, 2] uint32 keys) -> [B, L] audio.

    L = resolut + (F-1)*window; Griffin-Lim with the config's iteration
    count. Keys seed the per-example init noise; ``momentum`` > 0 bakes the
    fast-GL update into the artifact (ops/griffinlim.py).

    Serving recommendation (equal-quality pairs,
    ops.griffinlim.recommended_gl): for a plain-GL(n) quality target at
    n >= 16, export with ``momentum=0.99`` and ``griffin_lim_iterations``
    from ``recommended_gl(n)`` — e.g. momentum-24 matches plain-64 in 2.7x
    fewer iterations; at the reference default n=2 keep the config as is.
    """
    c = config
    inv = jnp.asarray(inverse_mel_weights(c.n_bins, c.num_mels, c.mel_fmin,
                                          c.mel_fmax), dtype)

    def decode_one(logmel, key):
        return mel_decode(logmel, c.resolut, c.window, inv,
                          c.griffin_lim_iterations, key,
                          c.tune_mul, c.tune_add, None, momentum=momentum)

    fn = jax.jit(jax.vmap(decode_one))
    b = _batch_dim(batch)
    spec = jax.ShapeDtypeStruct((b, n_frames, c.num_mels, 2), dtype)
    kspec = jax.ShapeDtypeStruct((b, 2), jnp.uint32)
    return jax_export.export(fn, platforms=list(platforms))(spec, kspec)


def export_phase_encoder(config: PhaseConfig, *, seconds: float,
                         sample_rate: int = 0, batch=None,
                         dtype=jnp.float32,
                         platforms=DEFAULT_PLATFORMS) -> jax_export.Exported:
    """[B, n_samples] audio -> [B, F, num_freqs, 2] phase spectrogram.

    ``sample_rate`` (falling back to ``config.sample_rate``) converts
    ``seconds`` to the input sample count — required explicitly for configs
    that leave the rate unset, e.g. ``PhaseConfig.cli_default()``.
    """
    c = config
    sr = int(sample_rate) or c.sample_rate
    if sr <= 0:
        raise ValueError("sample_rate must be set (argument or config) to "
                         "size the artifact's audio input")
    n = padded_samples(seconds, sr, c.window)
    win = jnp.asarray(hann_window(c.resolut), dtype)

    def encode_one(x):
        return phase_encode(x, c.num_freqs, c.resolut, c.window, win)

    fn = jax.jit(jax.vmap(encode_one))
    b = _batch_dim(batch)
    spec = jax.ShapeDtypeStruct((b, n), dtype)
    return jax_export.export(fn, platforms=list(platforms))(spec)


def export_phase_decoder(config: PhaseConfig, *, n_frames: int, batch=None,
                         dtype=jnp.float32,
                         platforms=DEFAULT_PLATFORMS) -> jax_export.Exported:
    """[B, F, num_freqs, 2] phase spectrogram -> [B, L] audio.

    Direct iSTFT (exact inversion).
    """
    c = config

    def decode_one(spec2):
        return phase_decode(spec2, c.resolut, c.window, c.volume_boost, None)

    fn = jax.jit(jax.vmap(decode_one))
    b = _batch_dim(batch)
    spec = jax.ShapeDtypeStruct((b, n_frames, c.num_freqs, 2), dtype)
    return jax_export.export(fn, platforms=list(platforms))(spec)


def export_phase_roundtrip(config: PhaseConfig, *, seconds: float,
                           sample_rate: int = 0, batch=None,
                           dtype=jnp.float32,
                           platforms=DEFAULT_PLATFORMS
                           ) -> jax_export.Exported:
    """[B, n_samples] audio -> [B, L] audio: ONE fused encode->decode
    program (the codec round trip as a single dispatch — the spectrogram
    never crosses a program boundary). Reference semantics: ToPhase ->
    FromPhase (phase/phase.go:41-153)."""
    c = config
    sr = int(sample_rate) or c.sample_rate
    if sr <= 0:
        raise ValueError("sample_rate must be set (argument or config) to "
                         "size the artifact's audio input")
    n = padded_samples(seconds, sr, c.window)
    win = jnp.asarray(hann_window(c.resolut), dtype)

    def roundtrip_one(x):
        spec2 = phase_encode(x, c.num_freqs, c.resolut, c.window, win)
        return phase_decode(spec2, c.resolut, c.window, c.volume_boost, None)

    fn = jax.jit(jax.vmap(roundtrip_one))
    b = _batch_dim(batch)
    spec = jax.ShapeDtypeStruct((b, n), dtype)
    return jax_export.export(fn, platforms=list(platforms))(spec)


def export_phase_encoder_quantized(config: PhaseConfig, *, seconds: float,
                                   sample_rate: int = 0, batch=None,
                                   dtype=jnp.float32,
                                   platforms=DEFAULT_PLATFORMS
                                   ) -> jax_export.Exported:
    """[B, n_samples] audio -> (planes [B, nf, F, 2] uint8|uint16,
    maxs [B, 2], mins [B, 2]): the file-ingest serving program — encode
    with the PNG quantizer (incl. IHS) fused in, per-row extrema (each row
    an independent stream). The artifact's output boundary carries only
    integer planes + extrema, like the live file paths (docs/DESIGN.md
    §11)."""
    c = config
    sr = int(sample_rate) or c.sample_rate
    if sr <= 0:
        raise ValueError("sample_rate must be set (argument or config) to "
                         "size the artifact's audio input")
    n = padded_samples(seconds, sr, c.window)
    win = jnp.asarray(hann_window(c.resolut), dtype)
    max_val = 65535 if c.hdr else 255

    def enc_one(x):
        spec = phase_encode(x, c.num_freqs, c.resolut, c.window, win)
        return quantize_planes(spec, max_val, c.ihs_passes)

    fn = jax.jit(jax.vmap(enc_one))
    b = _batch_dim(batch)
    spec = jax.ShapeDtypeStruct((b, n), dtype)
    return jax_export.export(fn, platforms=list(platforms))(spec)


def export_phase_decoder_quantized(config: PhaseConfig, *, n_frames: int,
                                   batch=None, dtype=jnp.float32,
                                   platforms=DEFAULT_PLATFORMS
                                   ) -> jax_export.Exported:
    """(planes [B, nf, F, 2] uint8|uint16, maxs [B, 2], mins [B, 2]) ->
    (int16 PCM [B, L], finite [B]): the file-decode serving program —
    fused dequantize (+sinh undo) + direct iSTFT + the bit-exact save_wav
    PCM-16 conversion. Integer planes in, int16 samples out."""
    c = config
    max_val = 65535 if c.hdr else 255

    def dec_one(planes, mx, mn):
        spec = dequantize_planes(planes, mx, mn, max_val, c.ihs_passes)
        return pcm16_encode(phase_decode(spec, c.resolut, c.window,
                                         c.volume_boost, None))

    fn = jax.jit(jax.vmap(dec_one))
    b = _batch_dim(batch)
    pdt = jnp.uint16 if c.hdr else jnp.uint8
    pspec = jax.ShapeDtypeStruct((b, c.num_freqs, n_frames, 2), pdt)
    espec = jax.ShapeDtypeStruct((b, 2), jnp.float32)
    return jax_export.export(fn, platforms=list(platforms))(pspec, espec,
                                                            espec)


def export_mel_encoder_quantized(config: MelConfig, *, seconds: float,
                                 sample_rate: int, batch=None,
                                 dtype=jnp.float32,
                                 platforms=DEFAULT_PLATFORMS
                                 ) -> jax_export.Exported:
    """[B, n_samples] audio -> (planes [B, mels, F, 2] uint8, mgc_max [B],
    mgc_min [B]): mel file-ingest serving program (GLOBAL per-row extrema,
    mel/impl.go:138-152)."""
    c = config
    n = padded_samples(seconds, int(sample_rate), c.window)
    fwd = jnp.asarray(mel_weights(c.n_bins, c.num_mels, c.mel_fmin,
                                  c.mel_fmax), dtype)
    win = jnp.asarray(hann_window(c.resolut), dtype)

    def enc_one(x):
        spec = mel_encode(x, c.num_mels, c.resolut, c.window, fwd, win)
        return quantize_mel_plane(spec, 255)

    fn = jax.jit(jax.vmap(enc_one))
    b = _batch_dim(batch)
    spec = jax.ShapeDtypeStruct((b, n), dtype)
    return jax_export.export(fn, platforms=list(platforms))(spec)


def export_mel_decoder_quantized(config: MelConfig, *, n_frames: int,
                                 batch=None, dtype=jnp.float32,
                                 momentum: float = 0.0,
                                 platforms=DEFAULT_PLATFORMS
                                 ) -> jax_export.Exported:
    """(planes [B, mels, F, 2] uint8, mgc_max [B], mgc_min [B],
    keys [B, 2] uint32) -> (int16 PCM [B, L], finite [B]): fused
    dequantize + VolumeBoost + Griffin-Lim + PCM-16 conversion."""
    c = config
    inv = jnp.asarray(inverse_mel_weights(c.n_bins, c.num_mels, c.mel_fmin,
                                          c.mel_fmax), dtype)
    boost = float(c.volume_boost)

    def dec_one(planes, mx, mn, key):
        lm = dequantize_mel_plane(planes, mx, mn, 255)
        if boost != 0.0:
            lm = lm + jnp.asarray(boost, lm.dtype)
        wave = mel_decode(lm, c.resolut, c.window, inv,
                          c.griffin_lim_iterations, key,
                          c.tune_mul, c.tune_add, None, momentum=momentum)
        return pcm16_encode(wave)

    fn = jax.jit(jax.vmap(dec_one))
    b = _batch_dim(batch)
    pspec = jax.ShapeDtypeStruct((b, c.num_mels, n_frames, 2), jnp.uint8)
    escpec = jax.ShapeDtypeStruct((b,), jnp.float32)
    kspec = jax.ShapeDtypeStruct((b, 2), jnp.uint32)
    return jax_export.export(fn, platforms=list(platforms))(pspec, escpec,
                                                            escpec, kspec)


# -- sharded long-form exports ------------------------------------------------
#
# The scale-out product (pipelines/longform.py: shard_map halo-exchange
# programs over a ('data','frame') mesh) EXPORTS: jax.export records the
# mesh size (``Exported.nr_devices``) and the input/output shardings, and a
# deserialized artifact runs on any mesh with the same device count — call
# it under jit with inputs sharded like the originals (``call_longform``
# below does this). Verified on the 8-virtual-device CPU mesh
# (tests/test_serving.py::test_longform_*). Build hosts without the target
# chip count can trace against virtual CPU devices
# (``--xla_force_host_platform_device_count``), exactly like the test suite.


def _longform_batch(batch, mesh) -> int:
    from .parallel.mesh import DATA_AXIS
    n_data = mesh.shape[DATA_AXIS]
    b = n_data if batch is None else int(batch)
    if b % n_data != 0:
        raise ValueError(f"batch {b} must be a multiple of the mesh's "
                         f"data axis ({n_data}); shard_map needs even rows")
    return b


def export_longform_mel_encoder(config: MelConfig, mesh, *, n_frames: int,
                                batch=None, dtype=jnp.float32,
                                platforms=DEFAULT_PLATFORMS
                                ) -> jax_export.Exported:
    """Frame-sharded [B, F_pad*hop] audio -> [B, F_pad, num_mels, 2] log-mel
    over ``mesh`` (parallel/sharded.sharded_mel_encode_fn). ``n_frames`` is
    the REAL frame count; input length and padded frame count come from the
    sharding plan (``longform_plan``).

    The mel filterbank weights are baked into the artifact as a replicated
    HLO CONSTANT: the artifact is ~1.5-3 MB larger and its weights are
    IMMUTABLE — to serve a different filterbank, export a new artifact."""
    from .parallel import sharded as sh
    from .parallel.mesh import FRAME_AXIS
    c = config
    plan = sh.plan_frame_sharding(n_frames, c.resolut, c.window,
                                  mesh.shape[FRAME_AXIS])
    fwd = mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax)
    fn = sh.sharded_mel_encode_fn(mesh, plan, c.num_mels, fwd, dtype)
    b = _longform_batch(batch, mesh)
    spec = jax.ShapeDtypeStruct((b, plan.sharded_signal_len), dtype)
    return jax_export.export(fn, platforms=list(platforms))(spec)


def export_longform_mel_decoder(config: MelConfig, mesh, *, n_frames: int,
                                batch=None, dtype=jnp.float32,
                                momentum: float = 0.0,
                                platforms=DEFAULT_PLATFORMS
                                ) -> jax_export.Exported:
    """Frame-sharded Griffin-Lim decode: ([B, F_pad, num_mels, 2] log-mel,
    [2] uint32 key) -> [B, F_pad*hop] audio. Init noise is drawn per shard
    inside the artifact (fold_in of the mesh axis indices).

    Serving recommendation for the long-form GL-64 class: export with
    ``momentum=0.99`` and ``griffin_lim_iterations=24``
    (ops.griffinlim.recommended_gl(64)) — matches-or-beats plain GL-64
    convergence in 2.7x fewer iterations on tonal, speech-like, and
    5-minute long-form inputs (benchmarks/exp_gl_frontier.py)."""
    from .parallel import sharded as sh
    from .parallel.mesh import FRAME_AXIS
    c = config
    plan = sh.plan_frame_sharding(n_frames, c.resolut, c.window,
                                  mesh.shape[FRAME_AXIS])
    inv = inverse_mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax)
    fn = sh.sharded_mel_decode_fn(mesh, plan, inv, c.griffin_lim_iterations,
                                  c.tune_mul, c.tune_add, dtype,
                                  momentum=momentum)
    b = _longform_batch(batch, mesh)
    spec = jax.ShapeDtypeStruct((b, plan.n_frames_padded, c.num_mels, 2),
                                dtype)
    kspec = jax.ShapeDtypeStruct((2,), jnp.uint32)
    return jax_export.export(fn, platforms=list(platforms))(spec, kspec)


def export_longform_phase_encoder(config: PhaseConfig, mesh, *,
                                  n_frames: int, batch=None,
                                  dtype=jnp.float32,
                                  platforms=DEFAULT_PLATFORMS
                                  ) -> jax_export.Exported:
    """Frame-sharded [B, F_pad*hop] audio -> [B, F_pad, num_freqs, 2]."""
    from .parallel import sharded as sh
    from .parallel.mesh import FRAME_AXIS
    c = config
    plan = sh.plan_frame_sharding(n_frames, c.resolut, c.window,
                                  mesh.shape[FRAME_AXIS])
    fn = sh.sharded_phase_encode_fn(mesh, plan, c.num_freqs, dtype)
    b = _longform_batch(batch, mesh)
    spec = jax.ShapeDtypeStruct((b, plan.sharded_signal_len), dtype)
    return jax_export.export(fn, platforms=list(platforms))(spec)


def export_longform_phase_decoder(config: PhaseConfig, mesh, *,
                                  n_frames: int, batch=None,
                                  dtype=jnp.float32,
                                  platforms=DEFAULT_PLATFORMS
                                  ) -> jax_export.Exported:
    """Frame-sharded direct iSTFT: [B, F_pad, num_freqs, 2] ->
    [B, F_pad*hop] audio (global window-sum pmax inside the artifact)."""
    from .parallel import sharded as sh
    from .parallel.mesh import FRAME_AXIS
    c = config
    plan = sh.plan_frame_sharding(n_frames, c.resolut, c.window,
                                  mesh.shape[FRAME_AXIS])
    fn = sh.sharded_phase_decode_fn(mesh, plan, float(c.volume_boost), dtype)
    b = _longform_batch(batch, mesh)
    spec = jax.ShapeDtypeStruct((b, plan.n_frames_padded, c.num_freqs, 2),
                                dtype)
    return jax_export.export(fn, platforms=list(platforms))(spec)


def longform_plan(config, mesh, n_frames: int):
    """The FrameShardPlan an exported longform artifact was built with —
    callers use it to pad inputs (pad_signal_for_plan / pad_frames_for_plan)
    and trim outputs (plan.n_frames / plan.out_len)."""
    from .parallel import sharded as sh
    from .parallel.mesh import FRAME_AXIS
    return sh.plan_frame_sharding(n_frames, config.resolut, config.window,
                                  mesh.shape[FRAME_AXIS])


# jitted-call cache: jax.jit caches per WRAPPER identity, so re-wrapping
# exp.call every invocation would re-trace (and worst-case recompile) the
# artifact per request. Keyed by id(exp) with a strong ref — a process holds
# a handful of artifacts, each multi-MB anyway.
_CALL_CACHE: dict = {}


def call_longform(exp: jax_export.Exported, mesh, *args) -> jax.Array:
    """Run a longform artifact on ``mesh``: shard each host input the way
    the artifact expects (rank-2 floats = [B, signal] over (data, frame);
    rank>=3 = [B, frames, ...]; rank-1 = replicated key) and invoke
    ``exp.call`` under a cached jit (compiled once per artifact). Works on
    multi-process meshes — inputs go through mesh.host_to_global."""
    from jax.sharding import PartitionSpec as P
    from .parallel.mesh import DATA_AXIS, FRAME_AXIS, host_to_global
    if len(mesh.devices.flatten()) != exp.nr_devices:
        raise ValueError(f"artifact was exported for {exp.nr_devices} "
                         f"devices; mesh has {mesh.devices.size}")
    if len(args) != len(exp.in_avals):
        raise ValueError(f"artifact takes {len(exp.in_avals)} inputs "
                         f"{[tuple(a.shape) for a in exp.in_avals]}, "
                         f"got {len(args)}")
    sharded = []
    for aval, a in zip(exp.in_avals, args):
        if aval.ndim >= 3:
            spec = P(DATA_AXIS, FRAME_AXIS, *([None] * (aval.ndim - 2)))
        elif aval.ndim == 2:
            spec = P(DATA_AXIS, FRAME_AXIS)
        else:
            spec = P()
        sharded.append(host_to_global(np.asarray(a), mesh, spec))
    if id(exp) not in _CALL_CACHE:
        _CALL_CACHE[id(exp)] = (exp, jax.jit(exp.call))
    return _CALL_CACHE[id(exp)][1](*sharded)


# -- persistence -------------------------------------------------------------

def _require_flatbuffers() -> None:
    """jax.export (de)serialization imports ``flatbuffers``; fall back to the
    vendored pure-Python runtime (gomel_tpu/_vendor) on hosts without it."""
    try:
        import flatbuffers  # noqa: F401
    except ImportError:
        sys.path.append(os.path.join(os.path.dirname(__file__), "_vendor"))


_MAGIC_V1 = b"GMTPUEXP1\n"
_MAGIC = b"GMTPUEXP2\n"


def artifact_meta(exp: jax_export.Exported, config=None, kind: str = "",
                  **extra) -> dict:
    """Self-description header for :func:`save_exported`: everything a
    serving fleet needs to route inputs without parsing filenames."""
    import dataclasses
    meta = {
        "kind": kind,
        "platforms": list(exp.platforms),
        "nr_devices": exp.nr_devices,
        "in_shapes": [[str(d) for d in av.shape] for av in exp.in_avals],
        "in_dtypes": [str(av.dtype) for av in exp.in_avals],
        "out_shapes": [[str(d) for d in av.shape] for av in exp.out_avals],
    }
    if config is not None:
        meta["config"] = {k: v for k, v in
                          dataclasses.asdict(config).items()}
        meta["config_class"] = type(config).__name__
    meta.update(extra)
    return meta


def save_exported(exp: jax_export.Exported, path: str,
                  meta: dict | None = None) -> None:
    """Serialize an export artifact: magic + JSON self-description header
    (length-prefixed) + StableHLO blob. Pass ``meta=artifact_meta(exp,
    config, kind=...)`` so the artifact records its own config (n_frames,
    mels, GL iterations, momentum, ...) instead of relying on filename
    conventions."""
    import json
    import struct
    _require_flatbuffers()
    header = json.dumps(meta if meta is not None else {}).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(exp.serialize())


def _read_artifact(path: str, with_blob: bool) -> tuple[dict, bytes | None]:
    """Parse an artifact file. ``with_blob=False`` reads ONLY the header —
    no full-file read for multi-hundred-MB pod artifacts. Malformed/truncated
    files always raise ValueError (the module's error contract)."""
    import json
    import struct
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _MAGIC:
            lenb = f.read(4)
            if len(lenb) < 4:
                raise ValueError(f"{path}: truncated artifact header")
            (hlen,) = struct.unpack("<I", lenb)
            hdr = f.read(hlen)
            if len(hdr) < hlen:
                raise ValueError(f"{path}: truncated artifact header")
            try:
                header = json.loads(hdr or b"{}")
            except ValueError as e:
                raise ValueError(f"{path}: corrupt artifact header ({e})"
                                 ) from None
            return header, (f.read() if with_blob else None)
        if magic == _MAGIC_V1:  # round-2 artifacts: no header
            return {}, (f.read() if with_blob else None)
    raise ValueError(f"{path} is not a gomel_tpu serving artifact")


def load_exported(path: str) -> jax_export.Exported:
    """Load an artifact written by :func:`save_exported`; ``.call(*args)``
    runs it (compiling for the local platform on first call)."""
    _require_flatbuffers()
    return jax_export.deserialize(_read_artifact(path, with_blob=True)[1])


def read_artifact_meta(path: str) -> dict:
    """The JSON self-description header (empty dict for round-2 v1
    artifacts) — reads only the header bytes, never the StableHLO blob."""
    return _read_artifact(path, with_blob=False)[0]
