"""Mel spectrogram codec — device ops.

Re-design of the reference mel codec:
- encode: /root/reference/mel/mel.go:46-74 (STFT -> channel extraction ->
  ``domel`` filterbank -> log-normalize)
- decode: /root/reference/mel/mel.go:142-152 (denormalize -> ``undomel`` ->
  ``undospectrum`` -> Griffin-Lim)

Channel-extraction equivalence (mel/mel.go:54-66): for real input,
``|S[j]|`` (ch0) and ``|S[N-j-1]| = |S[j+1]|`` (ch1) for j in [0, N/2) — i.e.
the two channels are the rfft magnitude vector offset by one bin. The filterbank
is a precomputed matrix (core/filterbank.py) applied as one matmul over all
frames and both channels at once.

Layout: [frames, num_mels, 2] channel-last.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .stft import frame_signal, hann_window
from .fftbackend import rfft_mag
from .griffinlim import griffin_lim, griffin_lim_magnitudes


# Extended-weight rearrangement cache: id(weights) -> (pinned source, [N/2+1, 2M]).
# The source array is pinned in the value so its id can't be recycled; entries
# are tiny (one per distinct filterbank config) and the cache is bounded.
_EXT_WEIGHT_CACHE: dict[int, tuple[object, np.ndarray]] = {}
_EXT_WEIGHT_CACHE_MAX = 16


def _extended_weights(fwd_weights) -> np.ndarray | None:
    """Concrete [M, N/2] weights -> memoized [N/2+1, 2M] extended matrix.

    Returns None when ``fwd_weights`` is not concrete (a tracer) — the caller
    falls back to the stack+einsum form that needs no host-side values. Uses
    ``np.asarray`` + the public TracerArrayConversionError instead of touching
    jax.core internals, and caches the rearrangement so device-resident weight
    arrays are pulled to host at most once, not per trace."""
    entry = _EXT_WEIGHT_CACHE.get(id(fwd_weights))
    if entry is not None and entry[0] is fwd_weights:
        return entry[1]
    try:
        w = np.asarray(fwd_weights)
    except jax.errors.TracerArrayConversionError:
        return None
    num_mels, n_bins = w.shape
    we = np.zeros((n_bins + 1, 2 * num_mels), dtype=w.dtype)
    we[:-1, 0::2] = w.T  # ch0 = bins j   (j in [0, N/2))
    we[1:, 1::2] = w.T   # ch1 = bins j+1 (== |S[N-j-1]|, see module doc)
    if len(_EXT_WEIGHT_CACHE) >= _EXT_WEIGHT_CACHE_MAX:
        _EXT_WEIGHT_CACHE.clear()
    _EXT_WEIGHT_CACHE[id(fwd_weights)] = (fwd_weights, we)
    return we


def spectral_normalize(x: jax.Array) -> jax.Array:
    """clamp below at 1e-5, then natural log (reference: mel/impl.go:410-419)."""
    return jnp.log(jnp.maximum(x, 1e-5))


def spectral_denormalize(x: jax.Array) -> jax.Array:
    """exp (reference: mel/impl.go:421-427)."""
    return jnp.exp(x)


def mel_encode(x_padded: jax.Array, num_mels: int, frame_len: int, hop: int,
               fwd_weights: jax.Array,
               window: jax.Array | None = None) -> jax.Array:
    """Audio -> log-mel spectrogram [F, num_mels, 2].

    fwd_weights: [num_mels, N/2] filterbank matrix (core.filterbank.mel_weights).
    """
    if window is None:
        window = jnp.asarray(hann_window(frame_len), dtype=x_padded.dtype)
    frames = frame_signal(x_padded, frame_len, hop)
    mags = rfft_mag(frames * window)  # [F, N/2+1]
    return _mel_from_mags(mags, fwd_weights)


def _mel_from_mags(mags: jax.Array, fwd_weights: jax.Array) -> jax.Array:
    """|rfft| [..., N/2+1] -> log-mel [..., num_mels, 2] (channel pair =
    adjacent-bin magnitudes, filterbank as one matmul).

    Constant weights take the extended-weight single-matmul form: one
    [N/2+1, 2*num_mels] matrix whose interleaved column pairs hold the ch0
    weights and the same weights shifted one bin down (ch1), so the whole
    tail is ``mags @ We`` + reshape — no [.., N/2, 2] channel-stack copy.
    Non-concrete weights (the documented slower runtime-arg case) keep the
    stack+einsum form, which needs no host-side weight rearrangement.
    """
    we = _extended_weights(fwd_weights)
    if we is None:  # tracer-valued weights: no host values available
        ch = jnp.stack([mags[..., :-1], mags[..., 1:]], axis=-1)
        mel = jnp.einsum("...bc,mb->...mc", ch, fwd_weights.astype(ch.dtype),
                         preferred_element_type=ch.dtype)
        return spectral_normalize(mel)
    num_mels = we.shape[1] // 2
    y = jnp.einsum("...n,nk->...k", mags, jnp.asarray(we, mags.dtype),
                   preferred_element_type=mags.dtype)
    mel = y.reshape(*y.shape[:-1], num_mels, 2)
    return spectral_normalize(mel)


def mel_encode_batch(xb: jax.Array, num_mels: int, frame_len: int, hop: int,
                     fwd_weights: jax.Array,
                     window: jax.Array | None = None) -> jax.Array:
    """Batched audio [B, L] -> log-mel [B, F, num_mels, 2].

    Same numerics as ``jax.vmap(mel_encode)`` but written batch-explicitly —
    one rfft over the whole [B, F, N] frame block and one einsum, with the
    filterbank weights as a compile-time constant.
    """
    if window is None:
        window = jnp.asarray(hann_window(frame_len), dtype=xb.dtype)
    frames = jax.vmap(lambda s: frame_signal(s, frame_len, hop))(xb)
    mags = rfft_mag(frames * window)
    return _mel_from_mags(mags, fwd_weights)


def mel_to_linear(logmel: jax.Array, inv_weights: jax.Array,
                  tune_mul: float = 1.0, tune_add: float = 0.0) -> jax.Array:
    """log-mel [F, num_mels, 2] -> linear 2-channel spectrum [F, N/2, 2].

    denormalize (exp) -> ``undomel`` matmul -> TuneMul/TuneAdd undo
    (reference: mel/mel.go:142-147, mel/impl.go:386-408: (v - TuneAdd)/TuneMul).
    """
    mel = spectral_denormalize(logmel)
    lin = jnp.einsum("fmc,bm->fbc", mel, inv_weights.astype(mel.dtype),
                     preferred_element_type=mel.dtype)
    if tune_add != 0.0 or tune_mul != 1.0:
        lin = (lin - jnp.asarray(tune_add, lin.dtype)) / jnp.asarray(tune_mul, lin.dtype)
    return lin


def mel_decode(logmel: jax.Array, frame_len: int, hop: int,
               inv_weights: jax.Array, n_iter: int, key: jax.Array,
               tune_mul: float = 1.0, tune_add: float = 0.0,
               window: jax.Array | None = None,
               momentum: float = 0.0) -> jax.Array:
    """log-mel [F, num_mels, 2] -> audio via Griffin-Lim (reference:
    mel/mel.go:142-152). Output length N + (F-1)*hop, un-normalized overlap-add
    amplitude exactly like the reference (window-sum division is commented out
    there, mel/mel.go:127-132). ``momentum`` > 0 opts into the accelerated
    fast-Griffin-Lim update (see ops/griffinlim.py); 0.0 is exact reference
    behavior."""
    lin = mel_to_linear(logmel, inv_weights, tune_mul, tune_add)
    mag = griffin_lim_magnitudes(lin)
    return griffin_lim(mag, hop, n_iter, key, window, momentum=momentum)
