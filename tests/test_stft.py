"""STFT / iSTFT op tests against plain numpy oracles."""
import conftest  # noqa: F401

import numpy as np
import jax.numpy as jnp
import pytest

from gomel_tpu.ops.stft import frame_signal, hann_window, stft
from gomel_tpu.ops.istft import istft_direct, overlap_add, window_sum


def test_hann_matches_numpy():
    np.testing.assert_allclose(hann_window(4096), np.hanning(4096), atol=0)
    np.testing.assert_allclose(hann_window(256), np.hanning(256), atol=0)


@pytest.mark.parametrize("L,N,hop", [(19199, 4096, 1280), (8000, 2048, 256),
                                     (5000, 1024, 1000)])
def test_frame_signal_matches_strided(L, N, hop):
    rng = np.random.RandomState(0)
    x = rng.randn(L)
    F = (L - N) // hop + 1
    idx = np.arange(N)[None, :] + np.arange(F)[:, None] * hop
    expect = x[idx]
    got = np.asarray(frame_signal(jnp.asarray(x), N, hop))
    np.testing.assert_array_equal(got, expect)


def test_stft_matches_full_fft_oracle():
    """The rfft half-spectrum must equal the reference's full-FFT bins
    (vectorized port semantics, phase.py:119-127)."""
    rng = np.random.RandomState(1)
    L, N, hop = 19199, 4096, 1280
    x = rng.randn(L)
    F = (L - N) // hop + 1
    idx = np.arange(N)[None, :] + np.arange(F)[:, None] * hop
    frames = x[idx] * np.hanning(N)
    full = np.fft.fft(frames, axis=1)
    got = np.asarray(stft(jnp.asarray(x), N, hop))
    np.testing.assert_allclose(got, full[:, : N // 2 + 1], rtol=1e-9, atol=1e-9)
    # conjugate symmetry: bin N-j-1 == conj(bin j+1)
    j = np.arange(N // 2)
    np.testing.assert_allclose(full[:, N - j - 1], np.conj(full[:, j + 1]),
                               rtol=1e-9, atol=1e-9)


def test_overlap_add_matches_scalar():
    rng = np.random.RandomState(2)
    F, N, hop = 7, 1024, 300
    frames = rng.randn(F, N)
    expect = np.zeros(N + (F - 1) * hop)
    for i in range(F):
        expect[i * hop: i * hop + N] += frames[i]
    got = np.asarray(overlap_add(jnp.asarray(frames), hop))
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)


def test_window_sum_matches_scalar():
    F, N, hop = 12, 4096, 1280
    w = np.hanning(N)
    expect = np.zeros(N + (F - 1) * hop)
    for i in range(F):
        expect[i * hop: i * hop + N] += w * w
    got = np.asarray(window_sum(jnp.asarray(w), F, hop))
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)


def test_istft_direct_matches_scalar_oracle():
    """Literal transcription of the phase ISTFT (phase/phase.go:93-133)."""
    rng = np.random.RandomState(3)
    F, N, hop = 13, 2048, 640
    w = np.hanning(N)
    # random Hermitian-compatible half spectrum
    half = rng.randn(F, N // 2 + 1) + 1j * rng.randn(F, N // 2 + 1)
    half[:, 0] = 0.0
    half[:, -1] = half[:, -1].real

    out_len = N + (F - 1) * hop
    sig = np.zeros(out_len)
    wsum = np.zeros(out_len)
    for i in range(F):
        td = np.fft.irfft(half[i], n=N)
        sig[i * hop: i * hop + N] += td * w
        wsum[i * hop: i * hop + N] += w * w
    thr = wsum.max() * 0.5
    expect = sig.copy()
    for n in range(out_len):
        if wsum[n] > thr:
            expect[n] = sig[n] / wsum[n]
        elif wsum[n] > 1e-21:
            expect[n] = sig[n] / wsum[n] * (wsum[n] / thr)

    got = np.asarray(istft_direct(jnp.asarray(half), hop, jnp.asarray(w)))
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-12)
