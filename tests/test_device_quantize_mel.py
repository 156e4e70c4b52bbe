"""Mel device-fused PNG quantization (ops/quantize.py) vs the host path.

Mirror of tests/test_device_quantize.py for the mel codec:
Mel(device_quantize=True) must produce byte-near images (<=1 quantization
step, rare f32-vs-f64 trunc boundary flips), identical metadata, files the
standard reader accepts, and a fused dequantize+boost+decode whose WAV
matches the host path within PCM-16 rounding.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from gomel_tpu.io import imagecodec
from gomel_tpu.io.audio import load_wav, save_wav
from gomel_tpu.io.pngcodec import read_png
from gomel_tpu.ops.quantize import dequantize_mel_plane, quantize_mel_plane
from gomel_tpu.pipelines.mel import Mel


def _audio(secs=1.5, sr=22050, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(t.shape))


def _cli_mel(**kw):
    from gomel_tpu.core.config import MelConfig
    return Mel(MelConfig.cli_default(), **kw)


def test_device_vs_host_bytes(tmp_path):
    buf = _audio()
    wav = str(tmp_path / "in.wav")
    save_wav(wav, buf, 22050)
    p_host = str(tmp_path / "host.png")
    p_dev = str(tmp_path / "dev.png")
    _cli_mel().to_mel_wav(wav, p_host)
    _cli_mel(device_quantize=True).to_mel_wav(wav, p_dev)

    a, b = read_png(p_host), read_png(p_dev)
    assert a.shape == b.shape and a.dtype == b.dtype
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert diff.max() <= 1, f"max pixel diff {diff.max()}"
    assert (diff > 0).mean() < 2e-3

    # metadata + decoded content agree (the real contract)
    sa, samples_a, sr_a = imagecodec.load_mel_image(p_host, True)
    sb, samples_b, sr_b = imagecodec.load_mel_image(p_dev, True)
    assert samples_a == pytest.approx(samples_b)
    assert sr_a == pytest.approx(sr_b)
    scale = max(1e-12, float(np.abs(sa).max()))
    assert np.abs(sa - sb).max() / scale < 2e-2


def test_quantized_writer_reader_consistent(tmp_path):
    """save_mel_image_quantized -> load_mel_image_raw is exact, and
    load_mel_image reads the same file to the identical spectrogram."""
    rng = np.random.default_rng(3)
    spec = (rng.standard_normal((40, 192, 2)) * 2.0 - 5.0).astype(np.float32)
    img2, mx, mn = quantize_mel_plane(jnp.asarray(spec))
    img2 = np.asarray(img2)
    png = str(tmp_path / "q.png")
    imagecodec.save_mel_image_quantized(
        png, img2, float(mx), float(mn), True, 512.0, 22050.0)
    planes, mx2, mn2, samples, sr = imagecodec.load_mel_image_raw(png, True)
    np.testing.assert_array_equal(planes, img2)
    assert mx2 == pytest.approx(float(mx), rel=1e-3)  # f16 metadata
    assert mn2 == pytest.approx(float(mn), rel=1e-3)
    assert samples == pytest.approx(512.0 * 40)
    assert sr == float(np.float16(22050.0))  # f16 metadata rounding
    # the standard reader sees the same content
    spec_std, samples_std, sr_std = imagecodec.load_mel_image(png, True)
    re = dequantize_mel_plane(jnp.asarray(planes), jnp.asarray(mx2),
                              jnp.asarray(mn2))
    np.testing.assert_allclose(np.asarray(re), spec_std, rtol=0, atol=1e-5)
    assert (samples_std, sr_std) == (samples, sr)


def test_load_mel_image_raw_legacy_guard(tmp_path):
    """max == samples_in_mel triggers the legacy samples=0 guard
    (mel/impl.go:105-107) in the raw loader too."""
    img2 = np.zeros((192, 16, 2), np.uint8)
    png = str(tmp_path / "legacy.png")
    imagecodec.save_mel_image_quantized(
        png, img2, 7.0, -3.0, True, 7.0, 22050.0)
    _, _, _, samples, _ = imagecodec.load_mel_image_raw(png, True)
    assert samples == 0.0


def test_device_dequantize_decode_matches_host(tmp_path):
    """to_wav_png with device_quantize uploads integer planes and fuses
    rescale + volume boost + Griffin-Lim; the WAV must match the host
    de-quantization path within PCM-16 rounding (same seed => same GL
    noise init)."""
    buf = _audio(secs=1.0, seed=4)
    wav = str(tmp_path / "in.wav")
    png = str(tmp_path / "m.png")
    save_wav(wav, buf, 22050)
    _cli_mel().to_mel_wav(wav, png)
    out_h = str(tmp_path / "h.wav")
    out_d = str(tmp_path / "d.wav")
    _cli_mel(volume_boost=1.5).to_wav_png(png, out_h, seed=7)
    _cli_mel(volume_boost=1.5, device_quantize=True).to_wav_png(
        png, out_d, seed=7)
    a, _ = load_wav(out_h)
    b, _ = load_wav(out_d)
    assert a.shape == b.shape
    # f32-vs-f64 de-quantization noise through exp() + GL under PCM-16
    lsb = np.abs(a - b) * 32768.0
    assert lsb.max() <= 2.0 + 1e-9, lsb.max()
    assert (lsb > 0.5).mean() < 5e-2


def test_device_quantized_roundtrip(tmp_path):
    """Full WAV -> PNG (device) -> WAV (device): same reconstruction
    contract as the host path (GL-2 at the CLI config is lossy; compare
    the two paths' spectral content instead of raw correlation)."""
    buf = _audio(secs=1.5, seed=6)
    wav = str(tmp_path / "in.wav")
    save_wav(wav, buf, 22050)
    png_d = str(tmp_path / "d.png")
    out_d = str(tmp_path / "d.wav")
    png_h = str(tmp_path / "h.png")
    out_h = str(tmp_path / "h.wav")
    m_dev = _cli_mel(device_quantize=True)
    m_host = _cli_mel()
    m_dev.to_mel_wav(wav, png_d)
    m_dev.to_wav_png(png_d, out_d, seed=3)
    m_host.to_mel_wav(wav, png_h)
    m_host.to_wav_png(png_h, out_h, seed=3)
    a, _ = load_wav(out_h)
    b, _ = load_wav(out_d)
    assert a.shape == b.shape
    # both paths reconstruct the same signal up to quantizer LSB noise
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.999, corr


def test_mismatched_mels_raises(tmp_path):
    buf = _audio(secs=0.5)
    wav = str(tmp_path / "in.wav")
    png = str(tmp_path / "m.png")
    save_wav(wav, buf, 22050)
    _cli_mel(device_quantize=True).to_mel_wav(wav, png)
    from gomel_tpu.core.config import ConfigError
    with pytest.raises(ConfigError, match="mel bins"):
        Mel(device_quantize=True).to_wav_png(png, str(tmp_path / "o.wav"))


def test_cli_device_quantize_flag(tmp_path):
    """tomel/towav --device-quantize round-trips end to end."""
    from gomel_tpu.cli.tools import tomel, towav
    buf = _audio(secs=0.8)
    wav = str(tmp_path / "in.wav")
    png = str(tmp_path / "in.wav.png")
    out = str(tmp_path / "out.wav")
    save_wav(wav, buf, 22050)
    assert tomel([wav, "--device-quantize"]) == 0
    assert towav([png, "22050", "-o", out, "--device-quantize"]) == 0
    rec, sr = load_wav(out)
    assert sr == 22050
    # same length contract as the host CLI path (incl. the reference's
    # minus-one padding quirk deciding whether the tail is trimmed)
    png_h = str(tmp_path / "h.png")
    out_h = str(tmp_path / "h.wav")
    assert tomel([wav, "-o", png_h, "--host-quantize"]) == 0
    assert towav([png_h, "22050", "-o", out_h, "--host-quantize"]) == 0
    rec_h, _ = load_wav(out_h)
    assert len(rec) == len(rec_h)
