"""Overlap-add iSTFT.

Vectorized replacement for the reference's per-sample overlap-add loops:
- direct iSTFT with window-sum normalization: /root/reference/phase/phase.go:93-133
  (port: /root/reference/phase.py:184-213)
- un-normalized overlap-add inside Griffin-Lim: /root/reference/mel/mel.go:111-135

Design notes:
- Overlap-add is computed as K shifted elementwise adds over hop-aligned chunks
  (K = ceil(N/hop), static) — no scatter, no serial loop; XLA fuses the adds.
- The window-sum normalization including the reference's 0.5*max stability
  threshold and proportional edge fade is pure elementwise ``jnp.where``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .fftbackend import irfft_planes


def overlap_add(frames: jax.Array, hop: int) -> jax.Array:
    """Sum overlapping frames: [F, N] -> [N + (F-1)*hop].

    out[i*hop + j] += frames[i, j], vectorized as K shifted adds of hop-chunks.
    """
    F, N = frames.shape
    K = -(-N // hop)  # ceil
    pad_n = K * hop - N
    fp = jnp.pad(frames, ((0, 0), (0, pad_n))).reshape(F, K, hop)
    # out viewed as hop-rows: out_rows[i + k] += fp[i, k]
    # Compute as sum over k of fp[:, k, :] placed at row offset k within
    # a (F + K - 1)-row output: implemented with static pads (pure elementwise).
    rows_out = F + K - 1
    acc = jnp.zeros((rows_out, hop), dtype=frames.dtype)
    for k in range(K):
        acc = acc + jnp.pad(fp[:, k, :], ((k, rows_out - F - k), (0, 0)))
    return acc.reshape(-1)[: N + (F - 1) * hop]


def window_sum(window: jax.Array, n_frames: int, hop: int) -> jax.Array:
    """Overlap-added sum of squared windows (reference: phase/phase.go:109).

    All frames contribute the SAME squared window, so instead of
    overlap-adding n_frames identical rows (O(F*N) traffic), build the result
    from the K = ceil(N/hop) distinct hop-row patterns: with prefix sums S[k]
    of the hop-reshaped w^2 over k, output hop-row i is
    S[min(i, K-1)] - S[i - F] (second term 0 for i < F). O(K*hop) compute,
    one broadcast for the periodic interior.
    """
    w2 = window * window
    N = w2.shape[0]
    K = -(-N // hop)
    F = n_frames
    rows = jnp.pad(w2, (0, K * hop - N)).reshape(K, hop)
    prefix = jnp.cumsum(rows, axis=0)          # S[k] = sum_{j<=k} rows[j]
    full = prefix[-1]
    rows_out = F + K - 1
    if rows_out <= 2 * (K - 1):
        # short signal: direct formula per row
        idx = jnp.arange(rows_out)
        top = prefix[jnp.minimum(idx, K - 1)]
        sub_idx = idx - F
        sub = jnp.where((sub_idx >= 0)[:, None],
                        prefix[jnp.clip(sub_idx, 0, K - 1)], 0.0)
        out = top - sub
    else:
        head = prefix[: K - 1]                                   # rows 0..K-2
        mid = jnp.broadcast_to(full, (rows_out - 2 * (K - 1), hop))
        tail = full - prefix[: K - 1]                            # suffix sums
        out = jnp.concatenate([head, mid, tail], axis=0)
    return out.reshape(-1)[: N + (F - 1) * hop]


def window_sum_max(window, n_frames: int, hop: int):
    """``max(window_sum(window, n_frames, hop))`` from the K = ceil(N/hop)
    distinct hop-row patterns alone, never the signal-length sum: a host
    float for a numpy window, a device scalar otherwise. (Reducing the
    signal-length sum let XLA constant-fold a 28.8M-element reduction, a
    minute of compile time at 10 minutes of 48 kHz audio.)"""
    xp = np if isinstance(window, np.ndarray) else jnp
    w2 = xp.asarray(window) ** 2
    K = -(-w2.shape[0] // hop)
    rows = xp.pad(w2, (0, K * hop - w2.shape[0])).reshape(K, hop)
    prefix = xp.cumsum(rows, axis=0)
    rows_out = n_frames + K - 1
    idx = np.arange(rows_out) if rows_out <= 2 * (K - 1) else np.concatenate(
        [np.arange(K - 1), [K - 1], np.arange(rows_out - K + 1, rows_out)])
    # window_sum's rows, restricted to one row of each distinct pattern
    sub = idx - n_frames
    top = prefix[np.minimum(idx, K - 1)]
    low = xp.where((sub >= 0)[:, None], prefix[np.clip(sub, 0, K - 1)], 0.0)
    m = xp.max(top - low)
    return float(m) if xp is np else m


def istft_direct_planes(re: jax.Array, im: jax.Array, hop: int,
                        window) -> jax.Array:
    """Direct (0-iteration) iSTFT with window-sum normalization.

    (re, im): real/imag planes of the [F, N//2+1] rfft-layout spectrum.
    Returns real signal [N + (F-1)*hop].

    Reproduces /root/reference/phase/phase.go:93-133: overlap-add of
    real(IFFT(frame)) * window with window-square accumulation, then
    normalization where window_sum > 0.5*max, proportional fade where
    1e-21 < window_sum <= threshold.

    The inverse is an exact f32 irfft (cuFFT on the GPU), so decode has
    no reduced-precision caveat on any platform.

    ``window``: np.ndarray (the threshold is then a host-side constant,
    ``window_sum_max``) or device array.
    """
    F = re.shape[0]
    N = (re.shape[1] - 1) * 2
    dtype = re.dtype
    window_arr = (jnp.asarray(window, dtype)
                  if isinstance(window, np.ndarray) else window)
    frames = irfft_planes(re, im, N)
    sig = overlap_add(frames.astype(window_arr.dtype) * window_arr, hop)
    wsum = window_sum(window_arr, F, hop)
    threshold = 0.5 * window_sum_max(window, F, hop)
    return normalize_by_window_sum(sig, wsum, jnp.asarray(threshold, dtype))


def istft_direct(half_spec: jax.Array, hop: int,
                 window: jax.Array) -> jax.Array:
    """Complex-input convenience wrapper over ``istft_direct_planes``."""
    return istft_direct_planes(jnp.real(half_spec), jnp.imag(half_spec),
                               hop, window)


def normalize_by_window_sum(sig: jax.Array, wsum: jax.Array,
                            threshold: jax.Array) -> jax.Array:
    """Stability-thresholded window-sum normalization
    (reference: phase/phase.go:121-130, port: phase.py:207-213).

    - wsum >  threshold: sig / wsum
    - 1e-21 < wsum <= threshold: sig / wsum * (wsum / threshold) == sig / threshold
    - wsum <= 1e-21: untouched

    The fade branch is computed directly as ``sig / threshold`` — identical
    algebra, but the reference's two-step form routes through an
    intermediate up to ~1e4x the result, which costs float32 three digits.
    """
    safe = jnp.where(wsum > 1e-21, wsum, 1.0)
    normalized = sig / safe
    faded = sig / threshold
    out = jnp.where(wsum > threshold, normalized,
                    jnp.where(wsum > 1e-21, faded, sig))
    return out
