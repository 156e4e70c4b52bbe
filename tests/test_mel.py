"""Mel codec tests against literal scalar oracles of the Go reference."""
import conftest  # noqa: F401

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gomel_tpu import Mel, MelConfig
from gomel_tpu.core.filterbank import inverse_mel_weights, mel_weights
from gomel_tpu.core.framing import pad_length
from gomel_tpu.ops.griffinlim import griffin_lim, griffin_lim_magnitudes
from gomel_tpu.ops.mel_ops import mel_to_linear

from test_filterbank import oracle_domel


def make_audio(n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 44100.0
    return 0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)


def oracle_to_mel(buf, cfg: MelConfig):
    """Literal transcription of ToMel (mel/mel.go:46-74): full FFT, abs of
    bins j and Resolut-j-1, domel, log-normalize."""
    padded = pad_length(len(buf), cfg.window)
    x = np.pad(buf, (0, padded - len(buf)))
    N, hop = cfg.resolut, cfg.window
    F = (len(x) - N) // hop + 1
    idx = np.arange(N)[None, :] + np.arange(F)[:, None] * hop
    spectrum = np.fft.fft(x[idx] * np.hanning(N), axis=1)
    rows = []
    for i in range(F):
        for j in range(N // 2):
            rows.append([abs(spectrum[i][j]), abs(spectrum[i][N - j - 1])])
    ospec = np.array(rows)
    melspec = oracle_domel(N // 2, cfg.num_mels, ospec, cfg.mel_fmin, cfg.mel_fmax)
    melspec = np.where(melspec < 1e-5, 1e-5, melspec)
    return np.log(melspec)


@pytest.mark.parametrize("cfg", [
    MelConfig(),  # NewMel defaults
    MelConfig.cli_default(),
])
def test_to_mel_matches_oracle(cfg):
    audio = make_audio(6000)
    expect = oracle_to_mel(audio, cfg)
    m = Mel(cfg, dtype=jnp.float64)
    got = m.to_mel(audio)
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=1e-8, atol=1e-10)


def oracle_griffin_lim(spectrogram, window_arr, hop, n_iter, init):
    """Literal transcription of the Go ISTFT/Griffin-Lim loop
    (mel/mel.go:76-139), full complex spectrogram [F, N]."""
    spectrogram = spectrogram.astype(np.complex128).copy()
    F, N = spectrogram.shape
    out_len = N + (F - 1) * hop
    sig = init.copy()
    for _ in range(n_iter):
        for i in range(F):
            frame = np.zeros(N)
            for j in range(N):
                pos = i * hop + j
                if pos < len(sig):
                    frame[j] = sig[pos] * window_arr[j]
            stft_frame = np.fft.fft(frame)
            mag = np.abs(spectrogram[i])
            ph = np.angle(stft_frame)
            spectrogram[i] = mag * np.exp(1j * ph)
            for j in range(1, N // 2):
                spectrogram[i][N - j] = np.conj(spectrogram[i][j])
        new = np.zeros(out_len)
        for i in range(F):
            buf = np.fft.ifft(spectrogram[i])
            for j in range(N):
                pos = i * hop + j
                if pos < out_len:
                    new[pos] += buf[j].real * window_arr[j]
        sig = new
    return sig


def test_griffin_lim_matches_go_loop_exactly():
    """The rfft-space Griffin-Lim must equal the reference's full-FFT loop
    given the same init signal (equivalence derivation in ops/griffinlim.py)."""
    rng = np.random.RandomState(4)
    F, N, hop = 5, 512, 160
    w = np.hanning(N)
    # undospectrum layout: real ch0 at bins [0, N/2), real ch1 reversed above
    lin2 = rng.randn(F, N // 2, 2)
    full = np.zeros((F, N), dtype=np.complex128)
    for i in range(F):
        for j in range(N // 2):
            full[i, j] = lin2[i, j, 0]
            full[i, N - j - 1] = lin2[i, j, 1]
    init = rng.rand(N + (F - 1) * hop)
    for iters in (1, 2, 3):
        expect = oracle_griffin_lim(full, w, hop, iters, init)
        mag = griffin_lim_magnitudes(jnp.asarray(lin2))
        got = np.asarray(griffin_lim(mag, hop, iters, jax.random.PRNGKey(0),
                                     jnp.asarray(w), init=jnp.asarray(init)))
        np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-9)


def test_mel_to_linear_matches_undomel_oracle():
    from test_filterbank import oracle_undomel
    rng = np.random.RandomState(5)
    cfg = MelConfig(num_mels=80, resolut=1024, window=256, tune_mul=1.5,
                    tune_add=0.25)
    F = 4
    logmel = rng.randn(F, cfg.num_mels, 2)
    melspec = np.exp(logmel)
    lin = oracle_undomel(cfg.n_bins, cfg.num_mels,
                         melspec.reshape(-1, 2), 0.0, 8000.0)
    expect = (lin - cfg.tune_add) / cfg.tune_mul
    inv = jnp.asarray(inverse_mel_weights(cfg.n_bins, cfg.num_mels, 0.0, 8000.0))
    got = np.asarray(mel_to_linear(jnp.asarray(logmel), inv,
                                   cfg.tune_mul, cfg.tune_add)).reshape(-1, 2)
    np.testing.assert_allclose(got, expect, rtol=1e-10, atol=1e-12)


def test_from_mel_end_to_end_shape_and_sanity():
    cfg = MelConfig()
    audio = make_audio(8000, seed=6)
    m = Mel(cfg, dtype=jnp.float64)
    spec = m.to_mel(audio)
    wav = m.from_mel(spec, seed=0)
    padded = pad_length(len(audio), cfg.window)
    F = (padded - cfg.resolut) // cfg.window + 1
    assert wav.shape == (cfg.resolut + (F - 1) * cfg.window,)
    assert np.all(np.isfinite(wav))
    # Griffin-Lim output correlates with a (scaled) version of the input
    n = min(len(audio), len(wav))
    sl = slice(cfg.resolut, n - cfg.resolut)
    c = np.corrcoef(audio[sl], wav[sl])[0, 1]
    assert abs(c) > 0.3, f"reconstruction uncorrelated: {c}"


def test_decode_num_mels_mismatch_raises_config_error():
    """Decoding a spectrogram whose mel count disagrees with the config must
    fail with a ConfigError naming the cause, not an einsum shape error.

    The footgun is real in the reference too: NewMel defaults to 160 mels
    (mel/mel.go:32) while the CLI presets bake 192 (cmd/tomel/main.go:28),
    so a CLI-written PNG cannot be decoded by a default-config Mel."""
    from gomel_tpu.core.config import ConfigError

    m = Mel(MelConfig(num_mels=160), dtype=jnp.float64)
    spec = np.zeros((4, 192, 2))
    with pytest.raises(ConfigError, match="192 mel bins .*num_mels=160"):
        m.decode(spec)


def test_dumpbuffer_image_parity():
    """Image() per-channel min/max uint16 packing (mel/impl.go:16-44)."""
    rng = np.random.RandomState(7)
    cfg = MelConfig(num_mels=8, resolut=64, window=16)
    m = Mel(cfg, dtype=jnp.float64)
    buf = rng.randn(5 * 8, 2)
    out = m.image(buf)
    spec = buf.reshape(5, 8, 2)
    mx, mn = spec.max(axis=(0, 1)), spec.min(axis=(0, 1))
    v0 = np.trunc(255 * (spec[..., 0] - mn[0]) / (mx[0] - mn[0])).astype(np.uint16)
    v1 = np.trunc(255 * (spec[..., 1] - mn[1]) / (mx[1] - mn[1])).astype(np.uint16)
    expect = (v0 | (v1 << 8)).reshape(-1)
    np.testing.assert_array_equal(out, expect)


def test_pipeline_encode_auto_chunk_matches_flat_kernel():
    """Mel.encode past 3072 frames (where an older policy chunked the
    frames) must match the flat ops kernel on the same padded signal."""
    import jax.numpy as jnp
    from gomel_tpu.core.config import MelConfig
    from gomel_tpu.core.framing import pad_length
    from gomel_tpu.core.filterbank import mel_weights
    from gomel_tpu.ops.mel_ops import mel_encode
    from gomel_tpu.pipelines.mel import Mel

    cfg = MelConfig(num_mels=8, resolut=64, window=16)
    L = pad_length(64 + 3300 * 16, 16)
    x = np.random.default_rng(31).standard_normal(L).astype(np.float32)
    m = Mel(cfg)
    got = np.asarray(m.encode(x))
    assert got.shape[0] >= 3072  # a long-form frame count
    w = jnp.asarray(mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                                cfg.mel_fmax), jnp.float32)
    want = np.asarray(mel_encode(jnp.asarray(x), cfg.num_mels, cfg.resolut,
                                 cfg.window, w))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_encode_rejects_batched_input():
    # a [B, L] batch would silently pad to pad_length(B); the pipelines
    # refuse and point at the batched API (parallel.BatchedMel/Phase)
    import pytest
    from gomel_tpu.pipelines.mel import Mel
    from gomel_tpu.pipelines.phase import Phase
    from gomel_tpu.core.config import MelConfig, PhaseConfig
    xb = np.zeros((2, 4000), dtype=np.float32)
    with pytest.raises(ValueError, match="BatchedMel"):
        Mel(MelConfig(num_mels=24, window=32, resolut=128)).encode(xb)
    with pytest.raises(ValueError, match="BatchedPhase"):
        Phase(PhaseConfig(num_freqs=40, window=32, resolut=128)).encode(xb)


def test_mel_tail_tracer_and_constant_forms_agree():
    """_mel_from_mags has two forms: the extended-weight single matmul for
    constant weights and the
    stack+einsum fallback when the weights are a tracer (runtime argument).
    Both must compute the same mel tail (reduction-order tolerance)."""
    from gomel_tpu.ops.mel_ops import _mel_from_mags

    cfg = MelConfig()
    w = mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin, cfg.mel_fmax)
    rng = np.random.RandomState(1)
    mags = jnp.asarray(np.abs(rng.randn(7, cfg.n_bins + 1)))

    const_form = _mel_from_mags(mags, jnp.asarray(w))          # extended
    tracer_form = jax.jit(_mel_from_mags)(mags, jnp.asarray(w))  # fallback
    np.testing.assert_allclose(const_form, tracer_form,
                               rtol=1e-12, atol=1e-12)
