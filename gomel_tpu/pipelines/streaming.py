"""Streaming (bounded-memory) codec pipelines for a single chip.

The reference loads whole files into memory; the multi-chip path
(pipelines/longform.py) shards frames across devices. This module covers the
third regime: arbitrarily long audio on ONE chip in O(chunk) memory, using
the same overlap-carry algebra as the halo exchange — a chunk's overlap-add
tail (frame_len - hop samples) is carried into the next chunk instead of
ppermuted to a neighbor.

Chunks are fixed-shape, so each stream compiles exactly two programs
(interior chunk + the reused flush path). Streaming results equal the batch
pipelines exactly for EVERY stream length: the iSTFT's global 0.5*max
window-sum threshold uses the periodic-interior maximum — exact whenever the
stream spans >= K = ceil(frame_len/hop) frames, which the constructor's
``chunk_frames >= K`` requirement guarantees for multi-chunk streams — and
single-block streams below that get the exact per-length threshold instead
(tests/test_streaming.py::test_short_stream_threshold_boundary).

Parity targets: phase/phase.go:41-153 buffer semantics, chunked.

Relation to the one-dispatch codecs (Mel/Phase/LongForm*): those keep the
whole signal and its frames in device memory; this module chunks at the HOST
boundary for O(chunk) total memory — pick streaming when the audio doesn't
fit device memory at all.
"""
from __future__ import annotations

from typing import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import MelConfig, PhaseConfig
from ..core.filterbank import mel_weights
from ..core.framing import pad_length
from ..ops.istft import normalize_by_window_sum, overlap_add
from ..ops.mel_ops import mel_encode
from ..ops.phase_ops import grow_half_planes, phase_encode
from ..ops.fftbackend import irfft_planes
from ..ops.stft import hann_window


def _stream_encode(samples, enc, chunk_samples, halo, frame_len, hop,
                   dtype, pad):
    """Shared chunked-encode driver: O(1) buffer handling (parts accumulate
    in a list, one concatenate per chunk) and a multi-chunk final flush (the
    reference padding can push the tail past one chunk when
    frame_len % hop != 0)."""
    need = chunk_samples + halo
    parts: list = []
    buffered = 0   # total samples across parts
    offset = 0     # consumed samples within parts[0]
    total = 0

    def drain(k):
        nonlocal parts, buffered, offset
        out = np.empty(k, dtype=np.float64)
        got = 0
        while got < k:
            head = np.asarray(parts[0], dtype=np.float64).reshape(-1)
            avail = len(head) - offset
            take = min(avail, k - got)
            out[got:got + take] = head[offset:offset + take]
            got += take
            offset += take
            if offset == len(head):
                parts.pop(0)
                offset = 0
        buffered -= k
        return out

    def peek(k):
        # copy of the first k samples without consuming
        saved = (list(parts), buffered, offset)
        nonlocal_backup = drain(k)
        restore(saved)
        return nonlocal_backup

    def restore(saved):
        nonlocal parts, buffered, offset
        parts, buffered, offset = list(saved[0]), saved[1], saved[2]

    for part in samples:
        part = np.asarray(part, dtype=np.float64).reshape(-1)
        if len(part) == 0:
            continue
        total += len(part)
        parts.append(part)
        buffered += len(part)
        while buffered >= need:
            window = peek(need)
            yield np.asarray(enc(jnp.asarray(window, dtype=dtype)))
            drain(chunk_samples)
    extra = (pad_length(total, hop) - total) if pad else 0
    tail = np.concatenate(
        [drain(buffered) if buffered else np.zeros(0), np.zeros(extra)])
    while len(tail) >= need:
        yield np.asarray(enc(jnp.asarray(tail[:need], dtype=dtype)))
        tail = tail[chunk_samples:]
    n_frames = (len(tail) - frame_len) // hop + 1
    if n_frames > 0:
        x = np.zeros(need)
        x[: len(tail)] = tail
        out = np.asarray(enc(jnp.asarray(x, dtype=dtype)))
        yield out[:n_frames]


class StreamingPhase:
    """Chunked phase codec: encode/decode arbitrarily long audio in fixed
    memory. ``chunk_frames`` frames are processed per device call."""

    def __init__(self, config: PhaseConfig | None = None,
                 chunk_frames: int = 512, dtype=jnp.float32):
        self.config = config or PhaseConfig()
        c = self.config
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be >= 1")
        self.chunk_frames = chunk_frames
        self.dtype = dtype
        self._hop = c.window
        self._frame_len = c.resolut
        self._halo = c.resolut - c.window
        self._window = jnp.asarray(hann_window(c.resolut), dtype)
        self._chunk_samples = chunk_frames * self._hop
        # The interior window-sum maximum equals the whole-signal maximum
        # exactly when the signal spans >= K = ceil(frame_len/hop) frames
        # (verified numerically for the Hann window: equality from F = K on,
        # tests/test_streaming.py::test_short_stream_threshold_boundary).
        # Single-block streams below that get an exact per-length threshold
        # in decode; multi-block streams are guaranteed F > chunk_frames, so
        # requiring chunk_frames >= K makes the interior threshold exact for
        # every stream this class can produce.
        k = -(-self._frame_len // self._hop)
        if chunk_frames < k:
            raise ValueError(
                f"chunk_frames must be >= ceil(resolut/window) = {k} so the "
                f"periodic-interior window-sum threshold is exact for "
                f"multi-chunk streams (got {chunk_frames})")

        cf, fl, hop = chunk_frames, self._frame_len, self._hop

        @jax.jit
        def _enc(x):
            # x: [cf*hop + frame_len - hop] -> [cf, num_freqs, 2]
            return phase_encode(x, c.num_freqs, fl, hop, self._window)

        @jax.jit
        def _dec(spec2):
            # spec2: [cf, num_freqs, 2] -> overlap-add extension
            # [cf*hop + halo] (un-normalized)
            re, im = grow_half_planes(spec2, fl // 2)
            frames = irfft_planes(re, im, fl).astype(self._window.dtype)
            return overlap_add(frames * self._window, hop)

        self._enc = _enc
        self._dec = _dec
        # window-sum of one interior chunk (constant across chunks)
        self._wsum_ext = self._np_window_sum(cf)
        # global threshold: periodic-interior maximum (== whole-signal max
        # for any stream of >= K frames; shorter single-block streams get an
        # exact per-length threshold in decode)
        self._threshold = 0.5 * float(
            self._np_window_sum(4 * (-(-fl // hop))).max())

    def _np_window_sum(self, n_frames: int) -> np.ndarray:
        """float64 overlap-added squared-window sum for n_frames frames."""
        w2 = hann_window(self._frame_len) ** 2
        out = np.zeros(self._frame_len + (n_frames - 1) * self._hop)
        for i in range(n_frames):
            out[i * self._hop: i * self._hop + self._frame_len] += w2
        return out

    # -- encode ------------------------------------------------------------

    def encode_iter(self, samples: Iterable[np.ndarray],
                    pad: bool = True) -> Iterator[np.ndarray]:
        """Stream of sample arrays -> stream of [<=chunk_frames, nf, 2].

        With ``pad=True`` the reference padding (pad to >=15*hop, then to a
        multiple-of-hop minus one) is applied to the TOTAL stream, matching
        the batch encoder on the concatenated signal.
        """
        yield from _stream_encode(samples, self._enc, self._chunk_samples,
                                  self._halo, self._frame_len, self._hop,
                                  self.dtype, pad)

    def encode(self, audio: np.ndarray) -> np.ndarray:
        """Whole-array convenience wrapper (still chunked device calls)."""
        return np.concatenate(list(self.encode_iter([audio])), axis=0)

    # -- decode ------------------------------------------------------------

    def decode_iter(self, specs: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Stream of [F_i, nf, 2] chunks -> stream of audio arrays.

        Concatenated output equals the batch ``phase_decode`` of the
        concatenated spectrogram (same overlap-add, window-sum normalization,
        and threshold semantics), emitted with one-chunk latency.
        """
        cf = self.chunk_frames
        carry_sig = np.zeros(self._halo)
        carry_w = np.zeros(self._halo)
        pending = np.zeros((0, self.config.num_freqs, 2))
        started = False

        def flush_block(block, last: bool):
            nonlocal carry_sig, carry_w
            f = block.shape[0]
            x = np.zeros((cf, self.config.num_freqs, 2))
            x[:f] = block
            sig_ext = np.asarray(self._dec(jnp.asarray(x, dtype=self.dtype)),
                                 dtype=np.float64)
            sig_ext = sig_ext[: f * self._hop + self._halo]
            # the window-sum tail depends on the block's REAL frame count
            wsum_ext = (self._wsum_ext.copy() if f == cf
                        else self._np_window_sum(f))
            sig_ext[: self._halo] += carry_sig
            wsum_ext[: self._halo] += carry_w
            body_n = f * self._hop
            out_sig, carry_sig = sig_ext[:body_n], sig_ext[body_n:].copy()
            out_w, carry_w = wsum_ext[:body_n], wsum_ext[body_n:].copy()
            if last:
                out_sig = np.concatenate([out_sig, carry_sig])
                out_w = np.concatenate([out_w, carry_w])
            # single-block stream: the interior threshold can overestimate
            # for F < K frames — use the exact whole-signal threshold (the
            # batch decoder's 0.5*max rule, phase/phase.go:118-121)
            threshold = self._threshold
            if last and not started:
                threshold = 0.5 * float(self._np_window_sum(max(f, 1)).max())
            out = np.asarray(normalize_by_window_sum(
                jnp.asarray(out_sig), jnp.asarray(out_w), threshold))
            if self.config.volume_boost != 0.0:
                out = out * self.config.volume_boost
            return out

        for spec in specs:
            spec = np.asarray(spec, dtype=np.float64)
            if spec.ndim == 2:
                spec = spec.reshape(-1, self.config.num_freqs, 2)
            pending = np.concatenate([pending, spec], axis=0)
            while pending.shape[0] >= cf:
                yield flush_block(pending[:cf], last=False)
                pending = pending[cf:]
                started = True
        if pending.shape[0] > 0 or started:
            yield flush_block(pending, last=True)

    def decode(self, spec: np.ndarray) -> np.ndarray:
        """Whole-array convenience wrapper (still chunked device calls)."""
        return np.concatenate(list(self.decode_iter([spec])))


class StreamingMel:
    """Chunked mel ENCODER: log-mel features for arbitrarily long audio in
    O(chunk) memory (the feature-extraction side of the mel codec;
    Griffin-Lim decoding is inherently whole-signal-iterative — use
    pipelines.longform.LongFormMel to scale decoding instead)."""

    def __init__(self, config: MelConfig | None = None,
                 chunk_frames: int = 512, dtype=jnp.float32):
        self.config = config or MelConfig()
        c = self.config
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be >= 1")
        self.chunk_frames = chunk_frames
        self.dtype = dtype
        self._hop = c.window
        self._frame_len = c.resolut
        self._halo = c.resolut - c.window
        self._chunk_samples = chunk_frames * self._hop
        window = jnp.asarray(hann_window(c.resolut), dtype)
        fwd = jnp.asarray(
            mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax), dtype)

        @jax.jit
        def _enc(x):
            return mel_encode(x, c.num_mels, c.resolut, c.window, fwd, window)

        self._enc = _enc

    def encode_iter(self, samples: Iterable[np.ndarray],
                    pad: bool = True) -> Iterator[np.ndarray]:
        """Stream of sample arrays -> stream of [<=chunk_frames, M, 2]
        log-mel chunks; concatenation equals the batch encoder."""
        yield from _stream_encode(samples, self._enc, self._chunk_samples,
                                  self._halo, self._frame_len, self._hop,
                                  self.dtype, pad)

    def encode(self, audio: np.ndarray) -> np.ndarray:
        return np.concatenate(list(self.encode_iter([audio])), axis=0)
