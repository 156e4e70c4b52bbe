"""CLI tool tests: routing rules, default parameters, end-to-end files."""
import os

import numpy as np
import pytest

from gomel_tpu.cli import tools
from gomel_tpu.io.audio import load_wav, save_wav
from gomel_tpu.io import flac as flacmod


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    sr = 48000
    t = np.arange(sr) / sr
    audio = 0.5 * np.sin(2 * np.pi * 440 * t)
    p = str(d / "tone.wav")
    save_wav(p, audio, sr)
    return p


def test_route_audio_input():
    # reference routing (cmd/tomel/main.go:33-59)
    assert tools._route_audio_input("a.flac") == ("a.flac", "flac")
    assert tools._route_audio_input("a.wav") == ("a.wav", "wav")
    assert tools._route_audio_input("a") == ("a.wav", "wav")


def test_tomel_towav_roundtrip(wav_file, tmp_path):
    png = str(tmp_path / "m.png")
    wav = str(tmp_path / "m.wav")
    assert tools.tomel([wav_file, "-o", png]) == 0
    assert os.path.exists(png)
    assert tools.towav([png, "48000", "-o", wav]) == 0
    rec, sr = load_wav(wav)
    assert sr == 48000
    assert len(rec) > 0


def test_tophase_fromphase_roundtrip(wav_file, tmp_path):
    png = str(tmp_path / "p.png")
    wav = str(tmp_path / "p.wav")
    assert tools.tophase([wav_file, "-o", png]) == 0
    assert tools.fromphase([png, "-o", wav]) == 0
    rec, sr = load_wav(wav)
    orig, _ = load_wav(wav_file)
    n = min(len(rec), len(orig))
    corr = np.corrcoef(orig[4096:n - 4096], rec[4096:n - 4096])[0, 1]
    assert corr > 0.99


def test_tophase_flac_input(tmp_path):
    sr = 48000
    t = np.arange(sr // 2) / sr
    audio = 0.4 * np.sin(2 * np.pi * 330 * t)
    f = str(tmp_path / "x.flac")
    flacmod.write_flac(f, audio, sr)
    png = str(tmp_path / "x.png")
    assert tools.tophase([f, "-o", png]) == 0
    assert os.path.exists(png)


def test_bare_name_implies_wav(wav_file, tmp_path):
    base = wav_file[: -len(".wav")]
    assert tools.tomel([base, "-o", str(tmp_path / "b.png")]) == 0


def test_missing_file_errors(tmp_path, capsys):
    rc = tools.tomel([str(tmp_path / "nope.wav")])
    assert rc == 1
    assert "Error generating mel spectrogram" in capsys.readouterr().err


def test_main_dispatch(wav_file, tmp_path):
    assert tools.main(["tomel", wav_file,
                       "-o", str(tmp_path / "d.png")]) == 0
    assert tools.main(["bogus"]) == 1
    assert tools.main([]) == 1


def test_batch_tomel_and_tophase(tmp_path):
    from gomel_tpu.cli.batch import batch_tomel, batch_tophase
    from gomel_tpu.io import imagecodec
    rng = np.random.default_rng(5)
    sr = 48000
    d = tmp_path / "audio"
    d.mkdir()
    lens = [sr // 2, sr // 3, sr]
    for i, n in enumerate(lens):
        t = np.arange(n) / sr
        save_wav(str(d / f"u{i}.wav"), 0.4 * np.sin(2 * np.pi * (200 + 100 * i) * t), sr)
    out = tmp_path / "png"
    rc = batch_tomel([str(d), "--out-dir", str(out), "--window", "256",
                      "--resolut", "1024", "--num-mels", "32",
                      "--max-batch", "2"])
    assert rc == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "u0.wav.png", "u1.wav.png", "u2.wav.png"]
    # per-file metadata preserved: decode one and check true length recovery
    spec, samples, got_sr = imagecodec.load_mel_image(
        str(out / "u2.wav.png"), True)
    assert got_sr == pytest.approx(sr, rel=1e-2)
    assert samples == pytest.approx(lens[2], rel=2e-3)

    out2 = tmp_path / "png2"
    # family num_freqs (768) must fit resolut/2 -> use resolut 2048
    rc = batch_tophase([str(d), "--out-dir", str(out2), "--window", "256",
                        "--resolut", "2048", "--max-batch", "2"])
    assert rc == 0
    assert len(list(out2.iterdir())) == 3
    # batched phase PNG decodes like a single-file one
    from gomel_tpu import Phase, PhaseConfig
    ph = Phase(PhaseConfig(num_freqs=768, window=256, resolut=2048,
                           y_reverse=True))
    wav = str(tmp_path / "rec.wav")
    ph.to_wav_png(str(out2 / "u0.wav.png"), wav)
    rec, _ = load_wav(wav)
    orig, _ = load_wav(str(d / "u0.wav"))
    n = min(len(rec), len(orig))
    corr = np.corrcoef(orig[2048:n - 2048], rec[2048:n - 2048])[0, 1]
    assert corr > 0.99


def test_batch_decode_roundtrip(tmp_path):
    from gomel_tpu.cli.batch import (batch_fromphase, batch_tophase,
                                     batch_tomel, batch_towav)
    sr = 48000
    d = tmp_path / "audio"
    d.mkdir()
    for i in range(3):
        t = np.arange(sr // 2) / sr
        save_wav(str(d / f"u{i}.wav"),
                 0.4 * np.sin(2 * np.pi * (300 + 50 * i) * t), sr)
    png = tmp_path / "png"
    assert batch_tophase([str(d), "--out-dir", str(png), "--window", "256",
                          "--resolut", "2048", "--max-batch", "2"]) == 0
    wavs = tmp_path / "wav"
    assert batch_fromphase([str(png), "--out-dir", str(wavs),
                            "--window", "256", "--resolut", "2048",
                            "--max-batch", "2"]) == 0
    assert len(list(wavs.iterdir())) == 3
    # batched decode equals the single-file fromphase for the same PNG
    from gomel_tpu import Phase, PhaseConfig
    single_wav = str(tmp_path / "single.wav")
    Phase(PhaseConfig(num_freqs=768, window=256, resolut=2048,
                      y_reverse=True)).to_wav_png(
        str(png / "u0.wav.png"), single_wav)
    a, _ = load_wav(str(wavs / "u0.wav.png.wav"))
    b, _ = load_wav(single_wav)
    np.testing.assert_allclose(a, b, atol=2e-4)

    pngm = tmp_path / "pngm"
    assert batch_tomel([str(d), "--out-dir", str(pngm), "--window", "256",
                        "--resolut", "1024", "--num-mels", "32"]) == 0
    wavm = tmp_path / "wavm"
    assert batch_towav([str(pngm), "--out-dir", str(wavm), "--window", "256",
                        "--resolut", "1024", "--num-mels", "32",
                        "--sample-rate", "48000"]) == 0
    assert len(list(wavm.iterdir())) == 3

    # fast-GL decode: flag accepted, outputs differ from plain GL
    wavf = tmp_path / "wavf"
    assert batch_towav([str(pngm), "--out-dir", str(wavf), "--window", "256",
                        "--resolut", "1024", "--num-mels", "32",
                        "--sample-rate", "48000",
                        "--gl-momentum", "0.99"]) == 0
    a, _ = load_wav(str(wavm / "u0.wav.png.wav"))
    b, _ = load_wav(str(wavf / "u0.wav.png.wav"))
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_info_tool_prints_artifact_meta(tmp_path, capsys):
    import json
    from gomel_tpu import serving, MelConfig
    cfg = MelConfig(num_mels=16, resolut=256, window=64)
    exp = serving.export_mel_encoder(cfg, seconds=0.05, sample_rate=8000,
                                     batch=2,
                                     platforms=("cpu",))
    p = str(tmp_path / "a.jaxexp")
    serving.save_exported(exp, p, meta=serving.artifact_meta(
        exp, cfg, kind="mel-enc"))
    assert tools.main(["info", p]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["kind"] == "mel-enc" and meta["config"]["num_mels"] == 16


def test_batch_process_shard_splits_work(tmp_path):
    from gomel_tpu.cli.batch import batch_tomel
    from gomel_tpu.io.audio import save_wav as _sw
    import numpy as _np
    d = tmp_path / "in"
    d.mkdir()
    for i in range(5):
        t = _np.arange(4000) / 8000.0
        _sw(str(d / f"u{i}.wav"), 0.3 * _np.sin(2 * _np.pi * (200 + i) * t),
            8000)
    out0, out1 = str(tmp_path / "s0"), str(tmp_path / "s1")
    args = [str(d), "--num-mels", "16", "--window", "64", "--resolut", "256"]
    assert batch_tomel(args + ["--out-dir", out0,
                               "--process-shard", "0", "2"]) == 0
    assert batch_tomel(args + ["--out-dir", out1,
                               "--process-shard", "1", "2"]) == 0
    got0 = sorted(os.listdir(out0))
    got1 = sorted(os.listdir(out1))
    assert got0 == ["u0.wav.png", "u2.wav.png", "u4.wav.png"]
    assert got1 == ["u1.wav.png", "u3.wav.png"]


def test_towav_gl_momentum_flag(wav_file, tmp_path):
    png = str(tmp_path / "m.png")
    assert tools.tomel([wav_file, "-o", png, "--num-mels", "32",
                        "--window", "64", "--resolut", "256"]) == 0
    plain = str(tmp_path / "plain.wav")
    fast = str(tmp_path / "fast.wav")
    args = [png, "48000", "--num-mels", "32", "--window", "64",
            "--resolut", "256", "--seed", "0"]
    assert tools.towav(args + ["-o", plain]) == 0
    assert tools.towav(args + ["-o", fast, "--gl-momentum", "0.99"]) == 0
    a, _ = load_wav(plain)
    b, _ = load_wav(fast)
    assert len(a) == len(b)
    assert not np.array_equal(a, b)  # momentum changes the GL trajectory


def test_save_wav_stereo_go_layout(tmp_path):
    """stereo=True duplicates mono into 2 identical channels — the Go
    dumpwav container layout (mel/impl.go:195-232); mono='left' reads
    channel 0 back bit-exactly."""
    from gomel_tpu.io.audio import save_wav as _sw
    from gomel_tpu.io import wavcodec
    t = np.arange(400) / 8000.0
    x = 0.5 * np.sin(2 * np.pi * 440 * t)
    p = str(tmp_path / "st.wav")
    _sw(p, x, 8000, stereo=True)
    raw, sr = wavcodec.read_wav(p)
    assert raw.ndim == 2 and raw.shape[1] == 2
    np.testing.assert_array_equal(raw[:, 0], raw[:, 1])
    mono, _ = load_wav(p, mono="left")
    np.testing.assert_allclose(mono, np.clip(x, -1, 1), atol=1 / 32768)


def test_tophase_fromphase_hdr_roundtrip(wav_file, tmp_path):
    """16-bit HDR phase PNG via the CLI: --hdr write + read back."""
    png = str(tmp_path / "hdr.png")
    wav = str(tmp_path / "hdr.wav")
    assert tools.tophase([wav_file, "-o", png, "--hdr"]) == 0
    from gomel_tpu.io.pngcodec import read_png
    assert read_png(png).dtype == np.uint16  # really 16-bit
    assert tools.fromphase([png, "-o", wav, "--hdr"]) == 0
    rec, _ = load_wav(wav)
    orig, _ = load_wav(wav_file)
    n = min(len(rec), len(orig))
    corr = np.corrcoef(orig[4096:n - 4096], rec[4096:n - 4096])[0, 1]
    assert corr > 0.99
