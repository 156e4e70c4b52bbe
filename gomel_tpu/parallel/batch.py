"""Length-bucketed batching + data-parallel pipelines.

The reference processes one file at a time (SURVEY.md §3); this build runs
utterance batches under one jit. XLA needs static shapes, so variable-length
audio is grouped into length buckets (each bucket = one compiled program) and
padded with the reference's own padding scheme (mel/impl.go:429-455), which
already defines the exact trim-back logic (``is_padded``). True lengths ride
along as a mask source, mirroring how the PNG metadata's ``samples_in_mel``
encodes recoverable length (SURVEY.md §5).

Batches are sharded over the mesh 'data' axis. On a REAL multi-process mesh
(``jax.process_count() > 1``) the pipelines construct process-global arrays —
either from an identical replicated host batch or from each process's own
rows (``input_mode="process_local"``, fed by
``io.dataset.shard_files_for_process``) — never ``jax.device_put`` of a
host-global array, which cannot address other processes' devices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import MelConfig, PhaseConfig
from ..core.framing import pad_length
from ..core.filterbank import mel_weights, inverse_mel_weights
from ..ops.mel_ops import mel_decode, mel_encode_batch
from ..ops.phase_ops import phase_decode, phase_encode
from ..ops.quantize import (dequantize_mel_plane, dequantize_planes,
                            pcm16_encode, pcm16_ingest,
                            quantize_mel_plane_batch, quantize_planes_batch)
from ..ops.stft import hann_window
from .mesh import (DATA_AXIS, host_to_global, local_rows_to_global,
                   process_local_batch_multiple)


# ---------------------------------------------------------------------------
# Length-bucketed batcher
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Bucket:
    """One fixed-shape batch: [B, padded_len] plus true lengths."""
    audio: np.ndarray            # [B, L_pad] float32
    lengths: np.ndarray          # [B] original sample counts
    indices: np.ndarray          # [B] positions in the input sequence
    padded_len: int


def make_buckets(utterances: Sequence[np.ndarray], hop: int,
                 max_batch: int = 64,
                 bucket_boundaries: Optional[Sequence[int]] = None,
                 dtype=np.float32) -> List[Bucket]:
    """Group variable-length utterances into fixed-shape padded batches.

    Each utterance is first padded with the reference formula
    (``pad_length``); utterances mapping to the same bucket boundary are
    stacked. Default boundaries: powers-of-two multiples of ``15*hop``.
    ``dtype``: bucket storage dtype — np.int16 for the raw-PCM ingest
    (device converts), default float32.
    """
    if bucket_boundaries is None:
        base = pad_length(1, hop)
        bucket_boundaries = [base]
        longest = max((len(u) for u in utterances), default=base)
        while bucket_boundaries[-1] < longest:
            bucket_boundaries.append(
                pad_length(bucket_boundaries[-1] * 2, hop))
    else:
        bucket_boundaries = sorted(bucket_boundaries)
    groups: dict[int, list[int]] = {}
    for i, u in enumerate(utterances):
        ref_len = pad_length(len(u), hop)
        b = next((bb for bb in bucket_boundaries if bb >= ref_len), ref_len)
        groups.setdefault(b, []).append(i)

    buckets: List[Bucket] = []
    for b, idxs in sorted(groups.items()):
        for s in range(0, len(idxs), max_batch):
            chunk = idxs[s:s + max_batch]
            audio = np.zeros((len(chunk), b), dtype=dtype)
            lengths = np.zeros(len(chunk), dtype=np.int64)
            for row, i in enumerate(chunk):
                u = np.asarray(utterances[i], dtype=dtype)
                audio[row, :len(u)] = u
                lengths[row] = len(u)
            buckets.append(Bucket(audio=audio, lengths=lengths,
                                  indices=np.asarray(chunk), padded_len=b))
    return buckets


def pad_batch_to_multiple(bucket: Bucket, multiple: int) -> Bucket:
    """Pad the batch dimension up to a multiple (for even 'data' sharding);
    padded rows have length 0 and index -1."""
    b = bucket.audio.shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return bucket
    pad = target - b
    return Bucket(
        audio=np.pad(bucket.audio, ((0, pad), (0, 0))),
        lengths=np.pad(bucket.lengths, (0, pad)),
        indices=np.pad(bucket.indices, (0, pad), constant_values=-1),
        padded_len=bucket.padded_len)


# ---------------------------------------------------------------------------
# Data-parallel codec pipelines
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=1)
def _take_rows(a, n):
    """jitted leading-axis trim — works on non-fully-addressable global
    arrays (eager slicing of those is forbidden on multi-process meshes)."""
    return a[:n]


def local_rows(global_arr, n_rows: int | None = None) -> np.ndarray:
    """Extract THIS process's batch rows from a data-sharded global array.

    Inverse of the ``input_mode="process_local"`` ingest: concatenates the
    process's addressable shards in data-axis order (deduplicating replicas
    along other mesh axes) and optionally trims to the process's true row
    count. On a single process this is just ``np.asarray(arr)[:n_rows]``.
    """
    by_start: dict[int, np.ndarray] = {}
    for s in global_arr.addressable_shards:
        start = s.index[0].start or 0
        if start not in by_start:
            by_start[start] = np.asarray(s.data)
    rows = np.concatenate([by_start[k] for k in sorted(by_start)], axis=0)
    return rows if n_rows is None else rows[:n_rows]


class _BatchedBase:
    """Shared mesh/batch plumbing for the data-parallel codec pipelines.

    ``input_mode`` picks the multi-process ingest model (irrelevant when
    ``jax.process_count() == 1``, where both reduce to ``jax.device_put``):

    - ``"replicated"``: every process passes the identical global batch;
      each contributes only the shards its devices own.
    - ``"process_local"``: every process passes its OWN rows (same count
      everywhere — SPMD needs one global shape); the global batch is their
      process-order concatenation (``jax.make_array_from_process_local_data``).
      Results come back as global arrays — use :func:`local_rows` to read
      this process's slice. Feed it with
      ``io.dataset.shard_files_for_process``.
    """

    def __init__(self, mesh: Mesh | None, dtype, input_mode: str):
        if input_mode not in ("replicated", "process_local"):
            raise ValueError(f"unknown input_mode {input_mode!r}")
        self.mesh = mesh
        self.dtype = dtype
        self.input_mode = input_mode
        self._multiproc = jax.process_count() > 1
        if input_mode == "process_local":
            if mesh is None:
                raise ValueError("input_mode='process_local' requires a mesh")
            self._row_multiple = process_local_batch_multiple(mesh)
        elif mesh is not None:
            self._row_multiple = mesh.shape[DATA_AXIS]
        else:
            self._row_multiple = 1

    def _pad_rows(self, arr, dtype=None):
        """Pad the batch dim to the row multiple; return (arr, true_rows).
        Host-side numpy on multi-process meshes (no device staging)."""
        host = self._multiproc
        dtype = self.dtype if dtype is None else dtype
        arr = (np.asarray(arr, dtype=dtype) if host
               else jnp.asarray(arr, dtype=dtype))
        b = arr.shape[0]
        target = -(-b // self._row_multiple) * self._row_multiple
        if target != b:
            pad = ((0, target - b),) + ((0, 0),) * (arr.ndim - 1)
            arr = np.pad(arr, pad) if host else jnp.pad(arr, pad)
        return arr, b

    def _shard(self, arr):
        if self.mesh is None:
            return arr
        if self.input_mode == "process_local":
            return local_rows_to_global(arr, self.mesh, P(DATA_AXIS))
        return host_to_global(arr, self.mesh, P(DATA_AXIS))

    def _ingest(self, arr, dtype=None):
        """Host batch -> (sharded array, true_rows). An already-global array
        (e.g. this object's encode result on a pod) passes through."""
        if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
            return arr, arr.shape[0]
        arr, b = self._pad_rows(arr, dtype=dtype)
        return self._shard(arr), b

    def _row_keys(self, n_global: int, seed: int):
        """Per-row PRNG keys split by GLOBAL row index, so a batch decodes
        identically regardless of process count/layout. Every process can
        compute the full key table, so the replicated model applies even
        under process_local data ingest."""
        keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed),
                                           n_global))
        if self.mesh is None:
            return jnp.asarray(keys)
        return host_to_global(keys, self.mesh, P(DATA_AXIS))

    def _trim(self, result, b):
        """Drop padding rows. In process_local mode the per-process padding
        rows are interleaved in the global batch (not a suffix), so the
        global result is returned untrimmed — read it with local_rows()."""
        if self.input_mode == "process_local" and self._multiproc:
            return result
        if result.shape[0] == b:
            return result
        return _take_rows(result, b) if self._multiproc else result[:b]


class BatchedMel(_BatchedBase):
    """Data-parallel batched mel codec over a mesh's 'data' axis.

    One compiled program per (batch, length) shape; weights replicated.
    Parity: per-utterance results equal pipelines.mel.Mel (same kernels).
    """

    def __init__(self, config: MelConfig | None = None,
                 mesh: Mesh | None = None, dtype=jnp.float32,
                 gl_momentum: float = 0.0, input_mode: str = "replicated"):
        # gl_momentum > 0 opts into fast-GL for every decode from this
        # instance (ops/griffinlim.py); 0.0 = exact reference behavior
        super().__init__(mesh, dtype, input_mode)
        self.config = config or MelConfig()
        c = self.config
        self._fwd = jnp.asarray(
            mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax), dtype)
        self._inv = jnp.asarray(
            inverse_mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax),
            dtype)
        self._window = jnp.asarray(hann_window(c.resolut), dtype)
        # batch-explicit encode with constant weights (ops/mel_ops.py)
        self._encode = jax.jit(
            lambda xb: mel_encode_batch(xb, c.num_mels, c.resolut, c.window,
                                        self._fwd, self._window))
        self._decode = jax.jit(jax.vmap(
            lambda m, k: mel_decode(m, c.resolut, c.window, self._inv,
                                    c.griffin_lim_iterations, k,
                                    c.tune_mul, c.tune_add, None,
                                    momentum=float(gl_momentum))))
        self._gl_momentum = float(gl_momentum)
        # device-quantize fast paths (built lazily on first use)
        self._encode_q = None
        self._encode_q_pcm = None
        self._decode_q: dict = {}

    def encode(self, audio_batch) -> jax.Array:
        """[B, L_pad] -> [B, F, num_mels, 2] log-mel (any B: padded
        internally to the mesh's data-axis multiple)."""
        xg, b = self._ingest(audio_batch)
        return self._trim(self._encode(xg), b)

    def encode_quantized(self, audio_batch, frames, scales=None):
        """[B, L_pad] + per-row TRUE frame counts [B] -> (img2 [B, mels,
        F_pad, 2] uint8, mgc_max [B], mgc_min [B]): batched encode with the
        PNG quantizer fused in (ops/quantize.quantize_mel_plane_batch).
        Each row's extrema come from its real frames only — identical grid
        to quantizing the file alone (mel/impl.go:138-152); slice each
        row's planes to [:, :frames[i]] before writing.

        RAW-PCM ingest: an int16 ``audio_batch`` uploads as int16 (half
        the bytes) and converts on device; ``scales`` [B] then gives each
        row's divisor (32768 WAV / 65536 mel-FLAC, io.dataset.pcm_scale_for
        — powers of two, so the device conversion is exact)."""
        is_pcm = np.asarray(audio_batch).dtype == np.int16 \
            if not isinstance(audio_batch, jax.Array) \
            else audio_batch.dtype == jnp.int16
        if is_pcm and scales is None:
            raise ValueError("int16 audio_batch requires per-row scales")
        c = self.config
        if is_pcm:
            if self._encode_q_pcm is None:
                self._encode_q_pcm = jax.jit(
                    lambda xb, sc, fr: quantize_mel_plane_batch(
                        mel_encode_batch(
                            xb.astype(self.dtype) * sc[:, None],
                            c.num_mels, c.resolut, c.window,
                            self._fwd, self._window),
                        255, frames=fr))
            xg, b = self._ingest(audio_batch, dtype=np.int16)
            if np.asarray(scales).shape[0] != b:
                raise ValueError(
                    f"scales has {np.asarray(scales).shape[0]} rows for a "
                    f"{b}-row batch")
            # multiply by the exact reciprocal of the power-of-two divisor
            recip = (1.0 / np.asarray(scales, np.float64)).astype(np.float32)
            scg, _ = self._ingest(recip, dtype=np.float32)
        else:
            if self._encode_q is None:
                self._encode_q = jax.jit(
                    lambda xb, fr: quantize_mel_plane_batch(
                        mel_encode_batch(xb, c.num_mels, c.resolut,
                                         c.window, self._fwd, self._window),
                        255, frames=fr))
            xg, b = self._ingest(audio_batch)
        if np.asarray(frames).shape[0] != b:
            raise ValueError(
                f"frames has {np.asarray(frames).shape[0]} rows for a "
                f"{b}-row batch")
        fg, _ = self._ingest(frames, dtype=np.int32)
        if is_pcm:
            img2, mx, mn = self._encode_q_pcm(xg, scg, fg)
        else:
            img2, mx, mn = self._encode_q(xg, fg)
        return (self._trim(img2, b), self._trim(mx, b), self._trim(mn, b))

    def decode(self, logmel_batch, seed: int = 0) -> jax.Array:
        """[B, F, num_mels, 2] -> [B, out_len] via Griffin-Lim (per-row PRNG
        streams keyed by global row index)."""
        mg, b = self._ingest(logmel_batch)
        return self._trim(
            self._decode(mg, self._row_keys(mg.shape[0], seed)), b)

    def decode_quantized(self, img2_batch, mgc_max, mgc_min, seed: int = 0,
                         boost: float = 0.0, pcm16: bool = False):
        """Integer PNG plane batch [B, mels, F, 2] uint8 + per-row extrema
        [B] -> [B, out_len]: fused dequantize (+log-domain VolumeBoost,
        mel/mel.go:218-221) + Griffin-Lim — only integer planes cross the
        host boundary (imagecodec.load_mel_image_raw feeds this).
        ``pcm16=True`` additionally fuses the save_wav PCM-16 conversion
        (bit-identical, ops/quantize.pcm16_encode) and returns
        (int16 [B, out_len], PER-ROW finite flags [B]) — half the
        readback, and one bad row doesn't poison its batch."""
        key = (float(boost), bool(pcm16))
        if key not in self._decode_q:
            c = self.config

            def fn(i, mx, mn, k):
                lm = dequantize_mel_plane(i, mx, mn, 255)
                if boost != 0.0:
                    lm = lm + jnp.asarray(boost, lm.dtype)
                wave = mel_decode(lm, c.resolut, c.window, self._inv,
                                  c.griffin_lim_iterations, k,
                                  c.tune_mul, c.tune_add, None,
                                  momentum=self._gl_momentum)
                return pcm16_encode(wave) if pcm16 else wave
            self._decode_q[key] = jax.jit(jax.vmap(fn))
        ig, b = self._ingest(img2_batch, dtype=np.uint8)
        mxg, _ = self._ingest(mgc_max, dtype=np.float32)
        mng, _ = self._ingest(mgc_min, dtype=np.float32)
        out = self._decode_q[key](ig, mxg, mng,
                                  self._row_keys(ig.shape[0], seed))
        if pcm16:
            pcm, finite = out
            return self._trim(pcm, b), self._trim(finite, b)
        return self._trim(out, b)

    def encode_buckets(self, utterances: Sequence[np.ndarray],
                       max_batch: int = 64):
        """Variable-length utterances -> generator of (bucket, logmel),
        one device batch in flight at a time; input order is recoverable via
        bucket.indices."""
        for bucket in make_buckets(utterances, self.config.window, max_batch):
            yield bucket, self.encode(bucket.audio)


class BatchedPhase(_BatchedBase):
    """Data-parallel batched phase codec over a mesh's 'data' axis."""

    def __init__(self, config: PhaseConfig | None = None,
                 mesh: Mesh | None = None, dtype=jnp.float32,
                 input_mode: str = "replicated"):
        super().__init__(mesh, dtype, input_mode)
        self.config = config or PhaseConfig()
        c = self.config
        self._window = jnp.asarray(hann_window(c.resolut), dtype)
        # vmap form: the phase tail is slice+stack, no matmul to batch
        self._encode = jax.jit(jax.vmap(
            lambda x: phase_encode(x, c.num_freqs, c.resolut, c.window,
                                   self._window)))
        self._decode = jax.jit(jax.vmap(
            lambda s: phase_decode(s, c.resolut, c.window,
                                   float(c.volume_boost), None)))
        # device-quantize fast paths (built lazily on first use)
        self._encode_q = None
        self._encode_q_pcm = None
        self._decode_q = None

    def encode(self, audio_batch) -> jax.Array:
        """[B, L_pad] -> [B, F, num_freqs, 2] (any B: padded internally to
        the mesh's data-axis multiple)."""
        xg, b = self._ingest(audio_batch)
        return self._trim(self._encode(xg), b)

    def encode_quantized(self, audio_batch, frames):
        """[B, L_pad] + per-row TRUE frame counts [B] -> (img2 [B, nf,
        F_pad, 2] uint8|uint16, maxs [B, 2], mins [B, 2]): batched encode
        with the PNG quantizer (incl. IHS passes) fused in
        (ops/quantize.quantize_planes_batch). Per-row extrema come from the
        row's real frames only — identical grid to quantizing each file
        alone (phase/impl.go:198-222); slice planes to [:, :frames[i]]
        before writing.

        An int16 ``audio_batch`` (already-upsampled-or-zp=0 rows) uploads
        raw and converts on device at the phase 1/32768 scaling — exact,
        half the bytes."""
        c = self.config
        is_pcm = np.asarray(audio_batch).dtype == np.int16 \
            if not isinstance(audio_batch, jax.Array) \
            else audio_batch.dtype == jnp.int16
        max_val = 65535 if c.hdr else 255
        if is_pcm:
            if self._encode_q_pcm is None:
                self._encode_q_pcm = jax.jit(
                    lambda xb, fr: quantize_planes_batch(
                        jax.vmap(lambda x: phase_encode(
                            pcm16_ingest(x, self.dtype, 32768.0),
                            c.num_freqs, c.resolut, c.window,
                            self._window))(xb),
                        max_val, c.ihs_passes, frames=fr))
            xg, b = self._ingest(audio_batch, dtype=np.int16)
        else:
            if self._encode_q is None:
                self._encode_q = jax.jit(
                    lambda xb, fr: quantize_planes_batch(
                        jax.vmap(lambda x: phase_encode(
                            x, c.num_freqs, c.resolut, c.window,
                            self._window))(xb),
                        max_val, c.ihs_passes, frames=fr))
            xg, b = self._ingest(audio_batch)
        if np.asarray(frames).shape[0] != b:
            raise ValueError(
                f"frames has {np.asarray(frames).shape[0]} rows for a "
                f"{b}-row batch")
        fg, _ = self._ingest(frames, dtype=np.int32)
        fn = self._encode_q_pcm if is_pcm else self._encode_q
        img2, maxs, mins = fn(xg, fg)
        return (self._trim(img2, b), self._trim(maxs, b),
                self._trim(mins, b))

    def decode(self, spec_batch) -> jax.Array:
        """[B, F, num_freqs, 2] -> [B, out_len]."""
        sg, b = self._ingest(spec_batch)
        return self._trim(self._decode(sg), b)

    def decode_quantized(self, img2_batch, maxs, mins, pcm16: bool = False):
        """Integer PNG plane batch [B, nf, F, 2] + per-row extrema [B, 2]
        -> [B, out_len]: fused dequantize (+sinh IHS undo) + decode — only
        integer planes cross the host boundary
        (imagecodec.load_phase_image_raw feeds this). ``pcm16=True`` fuses
        the save_wav PCM-16 conversion (bit-identical) and returns
        (int16 [B, out_len], PER-ROW finite flags [B]) — half the
        readback, and one bad row doesn't poison its batch."""
        c = self.config
        if self._decode_q is None:
            self._decode_q = {}
        key = bool(pcm16)
        if key not in self._decode_q:
            max_val = 65535 if c.hdr else 255

            def fn(i, mx, mn):
                wave = phase_decode(
                    dequantize_planes(i, mx, mn, max_val, c.ihs_passes),
                    c.resolut, c.window, float(c.volume_boost), None)
                return pcm16_encode(wave) if pcm16 else wave
            self._decode_q[key] = jax.jit(jax.vmap(fn))
        ig, b = self._ingest(
            img2_batch, dtype=np.uint16 if c.hdr else np.uint8)
        mxg, _ = self._ingest(maxs, dtype=np.float32)
        mng, _ = self._ingest(mins, dtype=np.float32)
        out = self._decode_q[key](ig, mxg, mng)
        if pcm16:
            pcm, finite = out
            return self._trim(pcm, b), self._trim(finite, b)
        return self._trim(out, b)

    def encode_buckets(self, utterances: Sequence[np.ndarray],
                       max_batch: int = 64):
        """Variable-length utterances -> generator of (bucket, spec)."""
        for bucket in make_buckets(utterances, self.config.window, max_batch):
            yield bucket, self.encode(bucket.audio)
