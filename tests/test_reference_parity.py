"""The float64 reference (gomel_tpu/reference.py) against the jitted codecs.

chip_smoke.py holds the accelerator to the same reference at the CLI
widths; here the CPU float64 path must agree with it to rounding, over the
reference configurations: the CLI and library-default mel presets, the 48k
(nf 768) and 44.1k (nf 836) phase families and the 44.1k HDR width
(nf 1672).
"""
import conftest  # noqa: F401  (forces CPU, float64)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gomel_tpu import MelConfig, PhaseConfig
from gomel_tpu import reference as R
from gomel_tpu.core.filterbank import inverse_mel_weights, mel_weights
from gomel_tpu.core.framing import pad_length
from gomel_tpu.ops.fftbackend import irfft_planes, rfft_mag, rfft_planes
from gomel_tpu.ops.griffinlim import griffin_lim, griffin_lim_magnitudes
from gomel_tpu.ops.istft import window_sum, window_sum_max
from gomel_tpu.ops.mel_ops import mel_encode, mel_to_linear
from gomel_tpu.ops.phase_ops import phase_decode, phase_encode

MEL_CONFIGS = {
    "cli": MelConfig.cli_default(),
    "lib": MelConfig(),
}
PHASE_CONFIGS = {
    "48k_nf768": PhaseConfig.for_sample_rate(48000),
    "44k_nf836": PhaseConfig.for_sample_rate(44100),
    "44k_hdr_nf1672": PhaseConfig.for_sample_rate(44100, hdr=True),
}


def _signal(n_frames, frame_len, hop, seed=0):
    n = pad_length(frame_len + (n_frames - 1) * hop, hop)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    return 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)


@pytest.mark.parametrize("n", [64, 256, 2048, 4096])
def test_rfft_planes_match_numpy(n):
    x = np.random.default_rng(n).standard_normal((3, n))
    re, im = rfft_planes(jnp.asarray(x))
    want = np.fft.rfft(x, axis=-1)
    np.testing.assert_allclose(np.asarray(re), want.real, atol=1e-10 * n)
    np.testing.assert_allclose(np.asarray(im), want.imag, atol=1e-10 * n)
    np.testing.assert_allclose(np.asarray(rfft_mag(jnp.asarray(x))),
                               np.abs(want), atol=1e-10 * n)


@pytest.mark.parametrize("n", [64, 256, 2048, 4096])
def test_irfft_planes_match_numpy(n):
    rng = np.random.default_rng(n + 1)
    spec = rng.standard_normal((3, n // 2 + 1)) \
        + 1j * rng.standard_normal((3, n // 2 + 1))
    got = irfft_planes(jnp.asarray(spec.real), jnp.asarray(spec.imag), n)
    np.testing.assert_allclose(np.asarray(got),
                               np.fft.irfft(spec, n=n, axis=-1), atol=1e-12)


@pytest.mark.parametrize("name", list(MEL_CONFIGS))
def test_mel_encode_matches_reference(name):
    c = MEL_CONFIGS[name]
    x = _signal(24, c.resolut, c.window)
    w = jnp.asarray(mel_weights(c.n_bins, c.num_mels, c.mel_fmin,
                                c.mel_fmax))
    got = np.asarray(mel_encode(jnp.asarray(x), c.num_mels, c.resolut,
                                c.window, w))
    want = R.mel_encode(x, c.num_mels, c.resolut, c.window, c.mel_fmin,
                        c.mel_fmax)
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("name", list(MEL_CONFIGS))
def test_mel_magnitudes_match_reference(name):
    c = MEL_CONFIGS[name]
    logmel = np.random.default_rng(3).standard_normal((6, c.num_mels, 2))
    inv = jnp.asarray(inverse_mel_weights(c.n_bins, c.num_mels, c.mel_fmin,
                                          c.mel_fmax))
    got = griffin_lim_magnitudes(mel_to_linear(jnp.asarray(logmel), inv))
    want = R.mel_magnitudes(logmel, c.resolut, c.mel_fmin, c.mel_fmax)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("momentum", [0.0, 0.99])
@pytest.mark.parametrize("name", list(MEL_CONFIGS))
def test_griffin_lim_matches_reference(name, momentum):
    c = MEL_CONFIGS[name]
    x = _signal(12, c.resolut, c.window, seed=5)
    logmel = R.mel_encode(x, c.num_mels, c.resolut, c.window, c.mel_fmin,
                          c.mel_fmax)
    mag = R.mel_magnitudes(logmel, c.resolut, c.mel_fmin, c.mel_fmax)
    init = np.random.default_rng(6).random(
        c.resolut + (mag.shape[0] - 1) * c.window)
    got = np.asarray(griffin_lim(jnp.asarray(mag), c.window, 4, None,
                                 init=jnp.asarray(init), momentum=momentum))
    want = R.griffin_lim(mag, c.window, 4, init, momentum=momentum)
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("name", list(PHASE_CONFIGS))
def test_phase_encode_matches_reference(name):
    c = PHASE_CONFIGS[name]
    x = _signal(20, c.resolut, c.window, seed=7)
    got = np.asarray(phase_encode(jnp.asarray(x), c.num_freqs, c.resolut,
                                  c.window))
    want = R.phase_encode(x, c.num_freqs, c.resolut, c.window)
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("name", list(PHASE_CONFIGS))
def test_phase_decode_matches_reference(name):
    c = PHASE_CONFIGS[name]
    x = _signal(20, c.resolut, c.window, seed=8)
    spec = R.phase_encode(x, c.num_freqs, c.resolut, c.window)
    got = np.asarray(phase_decode(jnp.asarray(spec), c.resolut, c.window,
                                  1.5))
    want = R.phase_decode(spec, c.resolut, c.window, 1.5)
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("n_frames", [1, 3, 4, 7, 40])
def test_window_sum_max_matches_full_sum(n_frames):
    """The host-side threshold equals the max of the signal-length window
    sum, in the short (few-frame) and the periodic regime alike."""
    from gomel_tpu.ops.stft import hann_window
    w = hann_window(1024)
    full = np.asarray(window_sum(jnp.asarray(w), n_frames, 320))
    assert window_sum_max(w, n_frames, 320) == pytest.approx(full.max(),
                                                             rel=1e-12)
    dev = window_sum_max(jnp.asarray(w), n_frames, 320)
    assert float(dev) == pytest.approx(full.max(), rel=1e-12)


def test_reference_overlap_add_matches_scatter():
    fr = np.random.default_rng(9).standard_normal((7, 100))
    out = np.zeros(100 + 6 * 30)
    for i in range(7):
        out[i * 30:i * 30 + 100] += fr[i]
    np.testing.assert_allclose(R.overlap_add(fr, 30), out, atol=1e-12)


def test_reference_jit_agrees_under_jax_jit():
    """The ops are jit-traceable with the same results as eager calls —
    the property chip_smoke relies on when it jits them on the card."""
    c = PHASE_CONFIGS["48k_nf768"]
    x = jnp.asarray(_signal(10, c.resolut, c.window, seed=10))
    f = jax.jit(lambda s: phase_encode(s, c.num_freqs, c.resolut, c.window))
    np.testing.assert_allclose(
        np.asarray(f(x)),
        np.asarray(phase_encode(x, c.num_freqs, c.resolut, c.window)),
        atol=1e-12)
