"""Mel filterbank weight construction.

The reference computes the mel projection with per-bin scalar loops
(``domel``: /root/reference/mel/impl.go:310-345, ``undomel``: mel/impl.go:347-384).
Both mappings are linear in the spectrum, so this design precomputes them
once (host-side, float64) as dense matrices and applies them on-device as a single
matmul — the weights below reproduce the reference's exact area-averaging
semantics, including its quirks:

- HTK-style mel scale with break 700 Hz, Q 1127, natural log
  (mel/impl.go:298-308).
- 2-tap fractional interpolation when a mel bin spans exactly 2 linear bins;
  otherwise a sum over ``[inlo, inhi)`` divided by ``inhi - inlo + 1`` (note the
  +1: the average is over one more than the number of summed bins — reproduced
  verbatim, mel/impl.go:328-336).
- A span of 0 linear bins yields exactly 0 (empty loop, then /1).
- Negative ``vallo`` clamps everything to 0 (mel/impl.go:320-322).

Weights are cached per (n_bins, n_mels, fmin, fmax).
"""
from __future__ import annotations

import functools
import math

import numpy as np

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def mel_to_hz(value: float) -> float:
    """HTK mel -> Hz (reference: mel/impl.go:298-302)."""
    return _MEL_BREAK_FREQUENCY_HERTZ * (math.exp(value / _MEL_HIGH_FREQUENCY_Q) - 1.0)


def hz_to_mel(value: float) -> float:
    """Hz -> HTK mel (reference: mel/impl.go:304-308)."""
    return _MEL_HIGH_FREQUENCY_Q * math.log(1.0 + (value / _MEL_BREAK_FREQUENCY_HERTZ))


@functools.lru_cache(maxsize=32)
def mel_weights(n_bins: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Forward filterbank matrix W [n_mels, n_bins], float64.

    ``mel = W @ spectrum`` reproduces ``domel`` (reference: mel/impl.go:310-345)
    exactly for every mel bin.
    """
    melbin = hz_to_mel(fmax) / float(n_mels)
    w = np.zeros((n_mels, n_bins), dtype=np.float64)
    for i in range(n_mels):
        vallo = float(n_bins) * (fmin + mel_to_hz(melbin * i)) / (fmax + fmin)
        valhi = float(n_bins) * (fmin + mel_to_hz(melbin * (i + 1))) / (fmax + fmin)
        modlo, inlo = math.modf(vallo)  # math.Modf: int part truncated toward zero
        inhi = math.floor(valhi)
        if inlo < 0:
            inlo, modlo, inhi = 0.0, 0.0, 0.0
        ilo, ihi = int(inlo), int(inhi)
        if ilo + 1 == ihi:
            # 2-tap fractional interpolation (mel/impl.go:328-331)
            if ihi >= n_bins:
                raise ValueError(
                    f"mel bin {i} interpolation index {ihi} out of range "
                    f"(n_bins={n_bins}) — invalid config, the reference would panic"
                )
            w[i, ilo] += 1.0 - modlo
            w[i, ihi] += modlo
        else:
            # averaged sum over [ilo, ihi) with the reference's +1 divisor
            # (mel/impl.go:332-336); empty span yields 0
            if ihi > n_bins:
                raise ValueError(
                    f"mel bin {i} span [{ilo},{ihi}) exceeds n_bins={n_bins} "
                    f"— invalid config, the reference would panic"
                )
            denom = float(ihi - ilo + 1)
            for k in range(ilo, ihi):
                w[i, k] += 1.0 / denom
    return w


@functools.lru_cache(maxsize=32)
def inverse_mel_weights(n_bins: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Pseudo-inverse filterbank matrix U [n_bins, n_mels], float64.

    ``spectrum = U @ mel`` reproduces ``undomel`` (reference: mel/impl.go:347-384),
    including its extra single-tap branch and its float (not int) divisor.
    """
    filterbin = hz_to_mel(fmax) / float(n_mels)
    u = np.zeros((n_bins, n_mels), dtype=np.float64)

    def _hz_to_mel_clamped(hz: float) -> float:
        # Go's math.Log returns -Inf/NaN for hz <= -700 which then trips the
        # ``inlo < 0`` clamp; emulate by returning -inf instead of raising.
        arg = 1.0 + hz / _MEL_BREAK_FREQUENCY_HERTZ
        if arg <= 0.0:
            return float("-inf")
        return _MEL_HIGH_FREQUENCY_Q * math.log(arg)

    for i in range(n_bins):
        vallo = _hz_to_mel_clamped((float(i) * (fmax + fmin) / float(n_bins)) - fmin) / filterbin
        valhi = _hz_to_mel_clamped((float(i + 1) * (fmax + fmin) / float(n_bins)) - fmin) / filterbin
        modlo, inlo = math.modf(vallo) if math.isfinite(vallo) else (0.0, vallo)
        inhi = math.floor(valhi) if math.isfinite(valhi) else valhi
        if inlo < 0:
            inlo, modlo, inhi = 0.0, 0.0, 0.0
        ilo, ihi = int(inlo), int(inhi)
        if ilo == ihi:
            # single tap (mel/impl.go:365-366)
            if ilo < n_mels:
                u[i, ilo] += 1.0
            else:
                raise ValueError(f"undomel bin {i}: tap {ilo} out of range n_mels={n_mels}")
        elif ilo + 1 == ihi and ihi < n_mels:
            # 2-tap fractional interpolation (mel/impl.go:367-369)
            u[i, ilo] += 1.0 - modlo
            u[i, ihi] += modlo
        else:
            # averaged sum with float divisor ``inhi - inlo + 1`` (mel/impl.go:371-374)
            if ihi > n_mels:
                raise ValueError(
                    f"undomel bin {i} span [{ilo},{ihi}) exceeds n_mels={n_mels}"
                )
            denom = inhi - inlo + 1.0
            for k in range(ilo, ihi):
                u[i, k] += 1.0 / denom
    return u
