"""Float64 numpy reference of the two codecs.

A plain, loop-free transcription of the reference semantics (gomel
``mel/mel.go`` and ``phase/phase.go``) that shares no device code with the
package: numpy's float64 FFT, explicit frame indexing, overlap-add by
``np.add.at``. The CPU tests compare the jitted codecs with it at small
sizes, and ``chip_smoke.py`` compares the accelerator's results with it at
the reference CLI widths. The filterbank matrices come from
``core.filterbank``, which ``tests/test_filterbank.py`` pins against a
literal transcription of the reference's ``domel``/``undomel`` loops.
"""
from __future__ import annotations

import numpy as np

from .core.filterbank import inverse_mel_weights, mel_weights


def hann(n: int) -> np.ndarray:
    """Symmetric Hann window (``np.hanning``, gossp's Hanning)."""
    return np.hanning(n)


def frames(x: np.ndarray, n: int, hop: int) -> np.ndarray:
    """[L] -> [F, n] overlapping frames, F = (L - n) // hop + 1."""
    f = (len(x) - n) // hop + 1
    idx = np.arange(n)[None, :] + hop * np.arange(f)[:, None]
    return np.asarray(x, np.float64)[idx]


def overlap_add(fr: np.ndarray, hop: int) -> np.ndarray:
    """[F, n] -> [n + (F-1)*hop], out[i*hop + j] += fr[i, j]."""
    f, n = fr.shape
    k = -(-n // hop)
    fp = np.pad(fr, ((0, 0), (0, k * hop - n)))
    out = np.zeros((f + k - 1) * hop)
    for j in range(k):  # column block j of frame i lands on hop-row i + j
        out[j * hop:(j + f) * hop] += fp[:, j * hop:(j + 1) * hop].ravel()
    return out[:n + (f - 1) * hop]


def mel_encode(x_padded: np.ndarray, num_mels: int, n: int, hop: int,
               fmin: float, fmax: float) -> np.ndarray:
    """Padded audio -> log-mel [F, num_mels, 2] (mel/mel.go:46-74): channel
    0 holds |S[j]|, channel 1 |S[N-j-1]| = |S[j+1]|, for j < N/2."""
    mags = np.abs(np.fft.rfft(frames(x_padded, n, hop) * hann(n), axis=-1))
    w = mel_weights(n // 2, num_mels, fmin, fmax)
    mel = np.stack([mags[:, :-1] @ w.T, mags[:, 1:] @ w.T], axis=-1)
    return np.log(np.maximum(mel, 1e-5))


def mel_magnitudes(logmel: np.ndarray, n: int, fmin: float, fmax: float,
                   tune_mul: float = 1.0, tune_add: float = 0.0
                   ) -> np.ndarray:
    """log-mel [F, M, 2] -> fixed Griffin-Lim half-spectrum magnitudes
    [F, N/2+1] (undomel, then mel/mel.go:105-108's symmetry rule)."""
    inv = inverse_mel_weights(n // 2, logmel.shape[1], fmin, fmax)
    lin = np.einsum("fmc,bm->fbc", np.exp(logmel), inv)
    lin = (lin - tune_add) / tune_mul
    return np.concatenate([np.abs(lin[..., 0]), np.abs(lin[:, -1:, 1])],
                          axis=1)


def griffin_lim(mag: np.ndarray, hop: int, n_iter: int, init: np.ndarray,
                momentum: float = 0.0) -> np.ndarray:
    """Un-normalized Griffin-Lim from ``init`` (mel/mel.go:76-139), with the
    optional fast-Griffin-Lim extrapolation of ops/griffinlim.py."""
    n = (mag.shape[1] - 1) * 2
    w = hann(n)

    def g(sig):
        s = np.fft.rfft(frames(sig, n, hop) * w, axis=-1)
        a = np.abs(s)
        unit = np.where(a > 0, s / np.where(a > 0, a, 1.0), 1.0)
        return overlap_add(np.fft.irfft(mag * unit, n=n, axis=-1) * w, hop)

    sig = np.asarray(init, np.float64)
    prev = sig
    for i in range(n_iter):
        t = g(sig)
        last = i == n_iter - 1
        sig = t if (momentum == 0.0 or last) else t + momentum * (t - prev)
        prev = t
    return sig


def phase_encode(x_padded: np.ndarray, num_freqs: int, n: int,
                 hop: int) -> np.ndarray:
    """Padded audio -> phase spectrogram [F, num_freqs, 2]
    (phase/phase.go:41-70): (imag, real) of rfft bins 1..num_freqs."""
    s = np.fft.rfft(frames(x_padded, n, hop) * hann(n), axis=-1)
    s = s[:, 1:num_freqs + 1]
    return np.stack([s.imag, s.real], axis=-1)


def phase_decode(spec2: np.ndarray, n: int, hop: int,
                 volume_boost: float = 0.0) -> np.ndarray:
    """Phase spectrogram [F, nf, 2] -> audio (phase/phase.go:72-153): grow
    by repeating the last bin, inverse rFFT, windowed overlap-add, and the
    window-sum normalization with its 0.5*max threshold and fade."""
    f, nf, _ = spec2.shape
    half = n // 2
    if nf < half:
        spec2 = np.concatenate(
            [spec2, np.repeat(spec2[:, -1:], half - nf, axis=1)], axis=1)
    h = np.zeros((f, half + 1), np.complex128)
    h[:, 1:half] = spec2[:, :half - 1, 1] + 1j * spec2[:, :half - 1, 0]
    h[:, half] = spec2[:, half - 1, 1]
    w = hann(n)
    sig = overlap_add(np.fft.irfft(h, n=n, axis=-1) * w, hop)
    wsum = overlap_add(np.broadcast_to(w * w, (f, n)), hop)
    thr = 0.5 * wsum.max()
    out = np.where(wsum > thr, sig / np.where(wsum > 1e-21, wsum, 1.0),
                   np.where(wsum > 1e-21, sig / thr, sig))
    return out * volume_boost if volume_boost != 0.0 else out


def spectral_convergence(sig: np.ndarray, mag: np.ndarray,
                         hop: int) -> float:
    """|| |STFT(sig)| - mag || / ||mag||: Griffin-Lim's own objective."""
    n = (mag.shape[1] - 1) * 2
    got = np.abs(np.fft.rfft(frames(sig, n, hop) * hann(n), axis=-1))
    return float(np.linalg.norm(got - mag) / np.linalg.norm(mag))
