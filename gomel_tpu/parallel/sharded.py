"""Frame-sharded STFT / overlap-add / Griffin-Lim — the halo-exchange layer.

The reference processes whole files on one CPU core; frames are independent in
analysis and couple only ±1 analysis-window length in synthesis
(/root/reference/phase/phase.go:102-112, mel/mel.go:111-125). That locality is
exactly what makes long-form audio frame-shardable across chips (SURVEY.md
§2.6, §5): each device owns a contiguous run of STFT frames, and the only
communication is a one-frame-length halo at shard boundaries:

- analysis (STFT): device d needs the first ``frame_len - hop`` samples of
  device d+1's signal chunk  → one ``ppermute`` toward the LEFT neighbor.
- synthesis (overlap-add): device d's last frames spill ``frame_len - hop``
  output samples into device d+1's span → one ``ppermute`` toward the RIGHT
  neighbor, added into the head.
- the iSTFT window-sum stability threshold is GLOBAL (0.5 * max over the whole
  signal, phase/phase.go:117); it depends only on the window, the hop and
  the real frame count, so it is a host-side constant (ops/istft
  ``window_sum_max``) and needs no collective.

Everything runs under ``shard_map`` on a ``('data','frame')`` mesh: utterance
batch over 'data', frames over 'frame'. Griffin-Lim keeps its signal carry
shard-resident in device memory across ``fori_loop`` iterations; each
iteration does the two halo exchanges and no other collective.

Sharding plan (host-side math): with F real frames, K = ceil(frame_len/hop),
the frame axis is padded to F_pad — a multiple of n_shards with
F_pad >= F + K - 1 and per-shard frame count F_loc >= K - 1 — so that (a) all
real signal lives inside the F_pad*hop-sample sharded buffer, (b) halos never
span more than one neighbor. Fake frames are masked out of window sums and
carry zero magnitude, so they contribute nothing.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.fftbackend import irfft_planes, rfft_planes
from ..ops.griffinlim import griffin_lim_magnitudes
from ..ops.istft import normalize_by_window_sum, overlap_add, window_sum_max
from ..ops.mel_ops import _mel_from_mags, mel_to_linear
from ..ops.phase_ops import grow_half_planes
from ..ops.stft import frame_signal, hann_window
from .mesh import DATA_AXIS, FRAME_AXIS


# ---------------------------------------------------------------------------
# Host-side sharding plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FrameShardPlan:
    """Static geometry of a frame-sharded run."""
    frame_len: int
    hop: int
    n_shards: int
    n_frames: int        # real frames F
    n_frames_padded: int # F_pad (multiple of n_shards)
    out_len: int         # real output length frame_len + (F-1)*hop

    @property
    def halo(self) -> int:
        return self.frame_len - self.hop

    @property
    def frames_per_shard(self) -> int:
        return self.n_frames_padded // self.n_shards

    @property
    def chunk(self) -> int:
        """Signal samples owned per shard."""
        return self.frames_per_shard * self.hop

    @property
    def sharded_signal_len(self) -> int:
        return self.n_frames_padded * self.hop


def plan_frame_sharding(n_frames: int, frame_len: int, hop: int,
                        n_shards: int) -> FrameShardPlan:
    """Compute the padded frame count for an even, halo-local sharding."""
    if n_frames <= 0:
        raise ValueError("need at least one frame")
    k = -(-frame_len // hop)  # ceil
    min_frames = max(n_frames + k - 1, n_shards * (k - 1), n_shards)
    f_pad = -(-min_frames // n_shards) * n_shards
    return FrameShardPlan(
        frame_len=frame_len, hop=hop, n_shards=n_shards,
        n_frames=n_frames, n_frames_padded=f_pad,
        out_len=frame_len + (n_frames - 1) * hop,
    )


def pad_signal_for_plan(x, plan: FrameShardPlan):
    """Zero-pad (or tail-truncate) a [..., L] signal to the sharded buffer.

    Samples past ``(n_frames-1)*hop + frame_len`` are read by no frame — the
    reference's pad-to-multiple-minus-one scheme (mel/impl.go:437-446) leaves
    up to hop-1 such samples — so truncating to the buffer is lossless;
    anything beyond that is an inconsistent plan. Type-preserving: numpy in,
    numpy out (multi-process callers must keep prep host-side).
    """
    L = x.shape[-1]
    target = plan.sharded_signal_len
    if L > target:
        if L > target + plan.hop - 1 or L > plan.out_len + plan.hop - 1:
            raise ValueError(
                f"signal length {L} inconsistent with plan (buffer {target})")
        return x[..., :target]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, target - L)]
    xp = np if isinstance(x, np.ndarray) else jnp
    return xp.pad(x, pad)


def pad_frames_for_plan(spec, plan: FrameShardPlan, axis: int = 1):
    """Zero-pad the frame axis of a spectrogram to n_frames_padded
    (type-preserving, like pad_signal_for_plan)."""
    f = spec.shape[axis]
    pad = [(0, 0)] * spec.ndim
    pad[axis] = (0, plan.n_frames_padded - f)
    xp = np if isinstance(spec, np.ndarray) else jnp
    return xp.pad(spec, pad)


# ---------------------------------------------------------------------------
# Halo-exchange primitives (inside shard_map, axis=FRAME_AXIS)
# ---------------------------------------------------------------------------

def _pull_right_halo(x_loc: jax.Array, halo: int, n: int,
                     axis_name: str) -> jax.Array:
    """Fetch the first ``halo`` samples (last axis) of the RIGHT neighbor's
    chunk; the last shard receives zeros (open boundary)."""
    head = x_loc[..., :halo]
    if n == 1:
        return jnp.zeros_like(head)
    return jax.lax.ppermute(head, axis_name,
                            [(i, i - 1) for i in range(1, n)])


def _push_tail_right(tail: jax.Array, n: int, axis_name: str) -> jax.Array:
    """Send the overlap-add tail to the RIGHT neighbor; shard 0 receives
    zeros (open boundary)."""
    if n == 1:
        return jnp.zeros_like(tail)
    return jax.lax.ppermute(tail, axis_name,
                            [(i, i + 1) for i in range(n - 1)])


def _local_frame_mask(f_loc: int, n_frames: int, axis_name: str) -> jax.Array:
    """[f_loc] bool mask: which local frames are real (global index < F)."""
    shard = jax.lax.axis_index(axis_name)
    gidx = shard * f_loc + jnp.arange(f_loc)
    return gidx < n_frames


# ---------------------------------------------------------------------------
# Shard-local kernels (operate on one device's [B_loc, ...] block)
# ---------------------------------------------------------------------------

def _local_signal_ext(x_loc, plan: FrameShardPlan):
    """[B, chunk] local signal -> [B, chunk + halo] with the right
    neighbor's head pulled in — the extended signal every analysis path
    frames from (single definition of the halo protocol)."""
    halo = _pull_right_halo(x_loc, plan.halo, plan.n_shards, FRAME_AXIS)
    return jnp.concatenate([x_loc, halo], axis=-1)


def _local_frames(x_loc, window, plan: FrameShardPlan):
    """[B, chunk] local signal -> [B, F_loc, N] windowed frames (halo pull)."""
    frames = jax.vmap(
        lambda s: frame_signal(s, plan.frame_len, plan.hop))(
        _local_signal_ext(x_loc, plan))
    return frames * window


def _local_stft_planes(x_loc, window, plan: FrameShardPlan):
    """[B, chunk] -> (re, im) local rfft frame planes [B, F_loc, N/2+1]."""
    return rfft_planes(_local_frames(x_loc, window, plan))


def _local_irfft_windowed(re, im, window_np, plan: FrameShardPlan, dtype):
    """irfft(re, im) * window for the decode side (exact f32)."""
    frames = irfft_planes(re, im, plan.frame_len).astype(dtype)
    return frames * jnp.asarray(window_np, dtype)


def _local_stft(x_loc, window, plan: FrameShardPlan):
    """[B, chunk] local signal -> [B, F_loc, N/2+1] local rfft frames."""
    re, im = _local_stft_planes(x_loc, window, plan)
    return jax.lax.complex(re, im)


def _local_overlap_add(frames_windowed, plan: FrameShardPlan):
    """[B, F_loc, N] windowed frames -> [B, chunk] with right-halo exchange."""
    sig_ext = jax.vmap(lambda f: overlap_add(f, plan.hop))(frames_windowed)
    body, tail = sig_ext[..., : plan.chunk], sig_ext[..., plan.chunk:]
    recv = _push_tail_right(tail, plan.n_shards, FRAME_AXIS)
    return body.at[..., : plan.halo].add(recv)


def _threshold(plan: FrameShardPlan, dtype) -> jax.Array:
    """The global stability threshold 0.5*max(window_sum) of the plan's
    real frames (phase/phase.go:117), computed on the host."""
    return jnp.asarray(0.5 * window_sum_max(hann_window(plan.frame_len),
                                            plan.n_frames, plan.hop), dtype)


def _local_window_sum(window, mask, plan: FrameShardPlan):
    """[chunk] window-square sum over REAL local frames, halo-exchanged."""
    w2 = jnp.where(mask[:, None], (window * window)[None, :], 0.0)
    sig_ext = overlap_add(w2, plan.hop)
    body, tail = sig_ext[: plan.chunk], sig_ext[plan.chunk:]
    recv = _push_tail_right(tail, plan.n_shards, FRAME_AXIS)
    return body.at[: plan.halo].add(recv)


# ---------------------------------------------------------------------------
# Sharded pipelines (shard_map entry points)
# ---------------------------------------------------------------------------

def _specs(mesh: Mesh):
    sig = P(DATA_AXIS, FRAME_AXIS)          # [B, L] signal
    spec = P(DATA_AXIS, FRAME_AXIS, None)   # [B, F, bins(, ch)]
    return sig, spec


def sharded_stft_fn(mesh: Mesh, plan: FrameShardPlan, dtype=jnp.float32):
    """Build a jitted [B, F_pad*hop] -> (re, im) sharded STFT, each plane
    [B, F_pad, N/2+1] (real/imag planes, like the sibling kernels)."""
    window = jnp.asarray(hann_window(plan.frame_len), dtype=dtype)
    sig_spec, spec_spec = _specs(mesh)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(sig_spec,),
        out_specs=(P(DATA_AXIS, FRAME_AXIS, None),) * 2)
    def _fn(x):
        return _local_stft_planes(x, window, plan)

    return jax.jit(_fn)


def sharded_istft_fn(mesh: Mesh, plan: FrameShardPlan, dtype=jnp.float32):
    """Build a jitted sharded direct iSTFT with GLOBAL window-sum threshold:
    [B, F_pad, N/2+1] complex -> [B, F_pad*hop] real.

    Parity target: phase/phase.go:93-133 (the 0.5*max stability threshold
    is global: a host-side constant of the plan)."""
    window = jnp.asarray(hann_window(plan.frame_len), dtype=dtype)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(DATA_AXIS, FRAME_AXIS, None),),
        out_specs=P(DATA_AXIS, FRAME_AXIS))
    def _fn(half_spec):
        mask = _local_frame_mask(plan.frames_per_shard, plan.n_frames,
                                 FRAME_AXIS)
        # masking whole frames commutes with the windowing
        frames_w = _local_irfft_windowed(
            jnp.real(half_spec), jnp.imag(half_spec),
            hann_window(plan.frame_len), plan, window.dtype)
        frames_w = jnp.where(mask[None, :, None], frames_w, 0.0)
        sig = _local_overlap_add(frames_w, plan)
        wsum = _local_window_sum(window, mask, plan)
        return normalize_by_window_sum(sig, wsum[None, :],
                                       _threshold(plan, window.dtype))

    return jax.jit(_fn)


def _shard_noise(key, plan: FrameShardPlan, b_loc: int, dtype):
    """Per-shard uniform Griffin-Lim init (inside shard_map): fold both mesh
    axis indices into the key. SINGLE definition shared by the fused
    noise_init path and the standalone generator — decode_resumable's
    bit-equality with decode depends on them never drifting."""
    shard_id = (jax.lax.axis_index(DATA_AXIS) * plan.n_shards
                + jax.lax.axis_index(FRAME_AXIS))
    return jax.random.uniform(jax.random.fold_in(key, shard_id),
                              (b_loc, plan.chunk), dtype=dtype)


def sharded_gl_noise_fn(mesh: Mesh, plan: FrameShardPlan, batch: int,
                        dtype=jnp.float32):
    """key -> [batch, F_pad*hop] per-shard uniform Griffin-Lim init, drawn
    inside shard_map with the SAME fold_in scheme as
    ``sharded_griffin_lim_fn(noise_init=True)`` — so a segmented/resumable
    run starting from this noise reproduces the one-call run bit-for-bit."""
    n_data = mesh.shape[DATA_AXIS]
    if batch % n_data != 0:
        raise ValueError(f"batch {batch} must be a multiple of the data "
                         f"axis ({n_data})")
    b_loc = batch // n_data

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(),),
                       out_specs=P(DATA_AXIS, FRAME_AXIS))
    def _fn(key):
        return _shard_noise(key, plan, b_loc, dtype)

    return jax.jit(_fn)


def sharded_griffin_lim_fn(mesh: Mesh, plan: FrameShardPlan, n_iter: int,
                           dtype=jnp.float32, momentum: float = 0.0,
                           noise_init: bool = False,
                           final_iteration: bool = True):
    """Build a jitted sharded Griffin-Lim:
    (mag [B, F_pad, N/2+1], sig0 [B, F_pad*hop]) -> [B, F_pad*hop].

    The signal carry stays shard-resident across the ``fori_loop``;
    per iteration: left-halo pull (analysis) + right-halo push (synthesis).
    Un-normalized overlap-add, matching /root/reference/mel/mel.go:111-135.

    ``momentum`` > 0 enables the fast-Griffin-Lim extrapolation (see
    ops/griffinlim.py) — it is a pointwise axpy on the shard-local signal
    carry, so it adds NO collectives and no halo traffic; ~2-4x fewer
    iterations for equal convergence makes it the preferred way to run the
    long-form GL-64 class of workloads (ops/griffinlim.recommended_gl).

    ``noise_init=True`` replaces the second input with a (replicated) PRNG
    key: each shard draws its own ``[B_loc, chunk]`` uniform init inside the
    shard_map body (``fold_in`` of both mesh axis indices), so no
    full-signal ``[B, F_pad*hop]`` staging tensor is ever materialized
    outside the mesh — at hour-scale signal lengths that tensor is GB-class
    and is also the host-global-array pattern that breaks multi-process
    meshes. Any uniform init is parity-valid: the reference seeds from
    unseeded ``math/rand`` noise (mel/mel.go:81-83).

    ``final_iteration=False`` runs all ``n_iter`` iterations inside the
    loop and none after it — the building block for segmented/resumable
    runs (pipelines.longform.LongFormMel.decode_resumable): only the run's
    very last segment sets it True, so the concatenation of segments
    executes the identical iteration sequence as one n_total call.
    """
    window = jnp.asarray(hann_window(plan.frame_len), dtype=dtype)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(DATA_AXIS, FRAME_AXIS, None),
                  P() if noise_init else P(DATA_AXIS, FRAME_AXIS)),
        out_specs=P(DATA_AXIS, FRAME_AXIS))
    def _fn(mag_loc, sig0):
        if noise_init:
            sig0 = _shard_noise(sig0, plan, mag_loc.shape[0], dtype)
        mask = _local_frame_mask(plan.frames_per_shard, plan.n_frames,
                                 FRAME_AXIS)
        mag = jnp.where(mask[None, :, None], mag_loc, 0.0)

        wnp = hann_window(plan.frame_len)

        def body(sig):
            re, im = _local_stft_planes(sig, window, plan)
            a = jnp.sqrt(re * re + im * im)
            inv = jnp.where(a > 0, 1.0 / jnp.where(a > 0, a, 1.0), 0.0)
            unit_re = jnp.where(a > 0, re * inv, 1.0)
            unit_im = im * inv
            rec_w = _local_irfft_windowed(mag * unit_re, mag * unit_im,
                                          wnp, plan, window.dtype)
            return _local_overlap_add(rec_w, plan)

        mom = float(momentum)
        n_interior = n_iter if not final_iteration else max(n_iter - 1, 0)
        if mom != 0.0:
            def accel(_, carry):
                c, t_prev = carry
                t = body(c)
                return t + mom * (t - t_prev), t

            sig, _ = jax.lax.fori_loop(0, n_interior, accel, (sig0, sig0))
        else:
            sig = jax.lax.fori_loop(0, n_interior,
                                    lambda _, s: body(s), sig0)
        if final_iteration and n_iter >= 1:
            sig = body(sig)
        return sig

    return jax.jit(_fn)


# ---------------------------------------------------------------------------
# Codec-level sharded pipelines
# ---------------------------------------------------------------------------

def sharded_phase_encode_fn(mesh: Mesh, plan: FrameShardPlan, num_freqs: int,
                            dtype=jnp.float32):
    """[B, F_pad*hop] audio -> [B, F_pad, num_freqs, 2] phase spectrogram
    (parity: phase/phase.go:41-70 — see ops/phase_ops.py)."""
    window = jnp.asarray(hann_window(plan.frame_len), dtype=dtype)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(DATA_AXIS, FRAME_AXIS),),
        out_specs=P(DATA_AXIS, FRAME_AXIS, None, None))
    def _fn(x):
        re, im = _local_stft_planes(x, window, plan)
        return jnp.stack([im[..., 1:num_freqs + 1],
                          re[..., 1:num_freqs + 1]], axis=-1)

    return jax.jit(_fn)


def sharded_phase_decode_fn(mesh: Mesh, plan: FrameShardPlan,
                            volume_boost: float = 0.0, dtype=jnp.float32):
    """[B, F_pad, num_freqs, 2] -> [B, F_pad*hop] audio
    (parity: phase/phase.go:136-153)."""
    window = jnp.asarray(hann_window(plan.frame_len), dtype=dtype)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(DATA_AXIS, FRAME_AXIS, None, None),),
        out_specs=P(DATA_AXIS, FRAME_AXIS))
    def _fn(spec2):
        mask = _local_frame_mask(plan.frames_per_shard, plan.n_frames,
                                 FRAME_AXIS)
        re, im = jax.vmap(
            lambda s: grow_half_planes(s, plan.frame_len // 2))(spec2)
        frames_w = _local_irfft_windowed(
            re, im, hann_window(plan.frame_len), plan, window.dtype)
        frames_w = jnp.where(mask[None, :, None], frames_w, 0.0)
        sig = _local_overlap_add(frames_w, plan)
        wsum = _local_window_sum(window, mask, plan)
        out = normalize_by_window_sum(sig, wsum[None, :],
                                      _threshold(plan, window.dtype))
        if volume_boost != 0.0:
            out = out * jnp.asarray(volume_boost, out.dtype)
        return out

    return jax.jit(_fn)


def sharded_mel_encode_fn(mesh: Mesh, plan: FrameShardPlan, num_mels: int,
                          fwd_weights: jax.Array, dtype=jnp.float32):
    """[B, F_pad*hop] audio -> [B, F_pad, num_mels, 2] log-mel
    (parity: mel/mel.go:46-74). The filterbank matmul is replicated per
    shard — frames are the sharded axis, the weight matrix is small and
    lives on every device."""
    window = jnp.asarray(hann_window(plan.frame_len), dtype=dtype)
    # Keep the weights a host-side CONSTANT closed over the shard_map body
    # (replicated automatically): threading them as an operand makes
    # _mel_from_mags see a tracer, which blocks the extended-weight
    # single-matmul tail.
    fwd = np.asarray(fwd_weights, dtype=dtype)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(DATA_AXIS, FRAME_AXIS),),
        out_specs=P(DATA_AXIS, FRAME_AXIS, None, None))
    def _fn(x):
        re, im = _local_stft_planes(x, window, plan)
        return _mel_from_mags(jnp.sqrt(re * re + im * im), fwd)

    return jax.jit(_fn)


def sharded_mel_decode_fn(mesh: Mesh, plan: FrameShardPlan,
                          inv_weights: jax.Array, n_iter: int,
                          tune_mul: float = 1.0, tune_add: float = 0.0,
                          dtype=jnp.float32, momentum: float = 0.0):
    """[B, F_pad, num_mels, 2] log-mel + PRNG key -> [B, F_pad*hop] audio via
    sharded Griffin-Lim (parity: mel/mel.go:142-152; ``momentum`` > 0 =
    opt-in fast-GL, ops/griffinlim.py)."""
    inv = jnp.asarray(inv_weights, dtype=dtype)
    gl = sharded_griffin_lim_fn(mesh, plan, n_iter, dtype=dtype,
                                momentum=momentum, noise_init=True)

    @jax.jit
    def _fn(logmel, key):
        # mel->linear is frame-local (no collectives); the GL init noise is
        # drawn per shard INSIDE the shard_map (noise_init) so nothing
        # signal-length is staged outside the mesh.
        lin = jax.vmap(lambda s: mel_to_linear(s, inv, tune_mul, tune_add)
                       )(logmel.astype(dtype))
        mag = jax.vmap(griffin_lim_magnitudes)(lin)
        return gl(mag, key)

    return _fn
