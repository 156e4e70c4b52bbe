"""Adversarial/untrusted-input tests for the PNG container and image readers.

The PNG readers are an untrusted-input surface (``loadpng`` of arbitrary
files, /root/reference/mel/impl.go:52-118); like the FLAC decoder's
decompression-bomb guard (native/flacdec.cpp, io/flac.py), the PNG inflate is
bounded by what the IHDR claims, absurd IHDR dimensions are rejected before
any allocation, and images smaller than their metadata block fail with a
clean ValueError instead of a wrapped-slice struct.error.
"""
import struct
import zlib

import numpy as np
import pytest

from gomel_tpu.io import imagecodec, pngcodec
from gomel_tpu.io.pngcodec import _SIGNATURE, _chunk, read_png, write_png


def _png_bytes(ihdr: bytes, idat: bytes) -> bytes:
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def _write(path, data: bytes) -> str:
    p = str(path)
    with open(p, "wb") as f:
        f.write(data)
    return p


def test_absurd_ihdr_dimensions_rejected_before_inflate(tmp_path):
    # 1M x 1M RGBA/16: header alone demands ~16 TB — must die on the
    # dimension check, not on an allocation.
    ihdr = struct.pack(">IIBBBBB", 1_000_000, 1_000_000, 16, 6, 0, 0, 0)
    p = _write(tmp_path / "huge.png", _png_bytes(ihdr, zlib.compress(b"x")))
    with pytest.raises(ValueError, match="decode limit"):
        read_png(p)


def test_zero_dimension_rejected(tmp_path):
    ihdr = struct.pack(">IIBBBBB", 0, 4, 8, 0, 0, 0, 0)
    p = _write(tmp_path / "zero.png", _png_bytes(ihdr, zlib.compress(b"")))
    with pytest.raises(ValueError, match="zero image dimension"):
        read_png(p)


def test_decompression_bomb_is_bounded(tmp_path):
    #

    # A 4x4 gray image needs 4*(4+1)=20 raw bytes, but the IDAT inflates to
    # 64 MiB from a few KB of input. The reader must stop at the claimed
    # size and reject, never materializing the full plaintext.
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 0)
    bomb = zlib.compress(b"\x00" * (64 << 20), 9)
    assert len(bomb) < 100_000  # it really is a bomb
    p = _write(tmp_path / "bomb.png", _png_bytes(ihdr, bomb))
    with pytest.raises(ValueError, match="inflates past"):
        read_png(p)


def test_truncated_file_clean_error(tmp_path):
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    good = str(tmp_path / "good.png")
    write_png(good, img)
    with open(good, "rb") as f:
        data = f.read()
    p = _write(tmp_path / "trunc.png", data[: len(data) // 2])
    with pytest.raises(ValueError):
        read_png(p)


def test_corrupt_idat_clean_error(tmp_path):
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 0)
    p = _write(tmp_path / "junk.png", _png_bytes(ihdr, b"not-deflate-data"))
    with pytest.raises(ValueError, match="corrupt PNG"):
        read_png(p)


def test_exact_size_stream_still_reads(tmp_path):
    # the bound must not reject legitimate images
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (16, 9, 3), dtype=np.uint8)
    p = str(tmp_path / "ok.png")
    write_png(p, img)
    np.testing.assert_array_equal(read_png(p), img)


def test_mel_image_too_small_for_metadata(tmp_path):
    # 4 mel rows < the 8-byte metadata block: clean error, not struct.error
    img = np.zeros((4, 6, 4), dtype=np.uint8)
    p = str(tmp_path / "tiny_mel.png")
    write_png(p, img)
    with pytest.raises(ValueError, match="too small"):
        imagecodec.load_mel_image(p, y_reverse=False)


def test_phase_image_too_small_for_metadata(tmp_path):
    # 8 rows < 12-byte py layout and < 16-byte go layout
    img = np.zeros((8, 6, 4), dtype=np.uint8)
    p = str(tmp_path / "tiny_phase.png")
    write_png(p, img)
    with pytest.raises(ValueError, match="too small"):
        imagecodec.load_phase_image(p, y_reverse=False, layout="go")
    with pytest.raises(ValueError, match="too small"):
        imagecodec.load_phase_image(p, y_reverse=False, layout="py")
    with pytest.raises(ValueError, match="too small"):
        imagecodec.load_phase_image(p, y_reverse=False, layout="auto")


def test_unknown_layout_rejected(tmp_path):
    img = np.zeros((20, 6, 4), dtype=np.uint8)
    p = str(tmp_path / "p.png")
    write_png(p, img)
    with pytest.raises(ValueError, match="unknown metadata layout"):
        imagecodec.load_phase_image(p, y_reverse=False, layout="bogus")


def test_bounded_decode_limit_is_adjustable(tmp_path, monkeypatch):
    ihdr = struct.pack(">IIBBBBB", 64, 64, 8, 0, 0, 0, 0)
    raw = bytes(64 * 65)
    p = _write(tmp_path / "cap.png", _png_bytes(ihdr, zlib.compress(raw)))
    monkeypatch.setattr(pngcodec, "MAX_IMAGE_BYTES", 1024)
    with pytest.raises(ValueError, match="decode limit"):
        read_png(p)


# ---------------------------------------------------------------------------
# Layout auto-detection on degenerate (silent/constant) content
# ---------------------------------------------------------------------------

def _roundtrip_layout(tmp_path, spec, layout):
    p = str(tmp_path / f"{layout}.png")
    imagecodec.save_phase_image(p, spec, y_reverse=True, samples_in_mel=100.0,
                                sample_rate=48000.0, layout=layout)
    got, samples, sr, nf = imagecodec.load_phase_image(p, y_reverse=True,
                                                       layout="auto")
    return got, samples, sr, nf


@pytest.mark.parametrize("layout", ["go", "py"])
def test_layout_autodetect_on_silent_content(tmp_path, layout):
    """A silent/constant spectrogram has float16-zero metadata bytes exactly
    where the old placeholder heuristic looked; the blue-plane discriminator
    must still classify both layouts correctly."""
    spec = np.zeros((6, 24, 2), dtype=np.float64)
    got, samples, sr, nf = _roundtrip_layout(tmp_path, spec, layout)
    assert nf == 24
    assert sr == 48000.0
    # silent content must decode back to exactly zero
    np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("layout", ["go", "py"])
def test_layout_autodetect_on_normal_content(tmp_path, layout):
    rng = np.random.default_rng(1)
    spec = rng.standard_normal((10, 32, 2))
    got, samples, sr, nf = _roundtrip_layout(tmp_path, spec, layout)
    assert nf == 32
    # 8-bit quantization tolerance
    np.testing.assert_allclose(got, spec, atol=1.5 * np.ptp(spec) / 255)


def test_fromphase_cli_metadata_layout_override(tmp_path):
    """A silent-content py-layout PNG round-trips via the CLI, both with
    explicit --metadata-layout py and with auto-detection."""
    from gomel_tpu.cli import tools

    nf, frames = 24, 6
    spec = np.zeros((frames, nf, 2), dtype=np.float64)
    png = str(tmp_path / "silent.png")
    imagecodec.save_phase_image(png, spec, y_reverse=True,
                                samples_in_mel=0.0, sample_rate=48000.0,
                                layout="py")
    for extra in (["--metadata-layout", "py"], []):
        wav = str(tmp_path / f"out{len(extra)}.wav")
        rc = tools.fromphase([png, "-o", wav, "--resolut", "256",
                              "--window", "64", "--num-freqs", "24"] + extra)
        assert rc == 0
        from gomel_tpu.io.audio import load_wav
        rec, _ = load_wav(wav)
        assert np.allclose(rec, 0.0)


def test_read_png_garbage_fuzz(tmp_path):
    """Random garbage (with and without a valid signature) must always fail
    with ValueError — never struct.error, zlib.error, or a crash."""
    rng = np.random.default_rng(42)
    for i in range(40):
        blob = rng.integers(0, 256, rng.integers(8, 400), dtype=np.uint8
                            ).tobytes()
        if i % 2 == 0:
            blob = _SIGNATURE + blob
        p = _write(tmp_path / f"fuzz{i}.png", blob)
        with pytest.raises(ValueError):
            read_png(p)


@pytest.mark.parametrize("layout", ["go", "py"])
def test_layout_autodetect_click_at_t0(tmp_path, layout):
    """Regression (round-3 review): a Go image whose channel-0 energy is
    concentrated in the FIRST frame quantizes every off-column-0 blue hint
    to 0 — detection must still classify it via column 0 / the block
    structure, not assume 'py'."""
    spec = np.zeros((10, 32, 2), dtype=np.float64)
    spec[0, :, 0] = 1.0   # click at t=0, channel 0
    spec[0, :, 1] = 1.0
    got, samples, sr, nf = _roundtrip_layout(tmp_path, spec, layout)
    assert nf == 32
    np.testing.assert_allclose(got, spec, atol=1.5 / 255)


# ---------------------------------------------------------------------------
# Hypothesis fuzz: layout auto-detection over arbitrary content
# ---------------------------------------------------------------------------

from hypothesis import given, settings, strategies as st, HealthCheck


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2 ** 32 - 1),
       frames=st.integers(1, 12), nf=st.integers(16, 40),
       layout=st.sampled_from(["go", "py"]),
       kind=st.sampled_from(["normal", "silent", "click0", "negative"]))
def test_layout_autodetect_fuzz(tmp_path, seed, frames, nf, layout, kind):
    """Auto-detection must round-trip correctly for arbitrary content —
    including the degenerate families that defeated earlier heuristics
    (silence, click-at-t0, all-negative). The assertion is LOAD-level: in
    the one genuinely byte-ambiguous family (100%-metadata silent images)
    both layout interpretations decode identically, so the label itself is
    immaterial there (see imagecodec._detect_phase_layout)."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        spec = rng.standard_normal((frames, nf, 2))
    elif kind == "silent":
        spec = np.zeros((frames, nf, 2))
    elif kind == "click0":
        spec = np.zeros((frames, nf, 2))
        spec[0] = np.abs(rng.standard_normal((nf, 2))) + 0.5
    else:  # negative: values in [-2, -1]
        spec = -1.0 - rng.random((frames, nf, 2))
    p = str(tmp_path / f"fz_{layout}_{kind}_{seed}.png")
    imagecodec.save_phase_image(p, spec, y_reverse=True,
                                samples_in_mel=7.0, sample_rate=48000.0,
                                layout=layout)
    got, samples, sr, got_nf = imagecodec.load_phase_image(
        p, y_reverse=True, layout="auto")
    want, wsamples, wsr, wnf = imagecodec.load_phase_image(
        p, y_reverse=True, layout=layout)
    assert got_nf == wnf == nf
    assert sr == wsr == 48000.0
    assert samples == wsamples
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# WAV reader: same untrusted-input contract as the PNG/FLAC readers
# ---------------------------------------------------------------------------

def test_read_wav_garbage_fuzz(tmp_path):
    """Random garbage (with/without a RIFF header) must fail with ValueError
    — never struct.error or a crash."""
    from gomel_tpu.io.wavcodec import read_wav
    rng = np.random.default_rng(7)
    for i in range(40):
        blob = rng.integers(0, 256, rng.integers(4, 300), dtype=np.uint8
                            ).tobytes()
        if i % 3 == 0:
            blob = b"RIFF" + blob[:4] + b"WAVE" + blob
        p = _write(tmp_path / f"wf{i}.wav", blob)
        try:
            read_wav(p)  # a lucky valid-enough file is fine...
        except ValueError:
            pass         # ...and the only acceptable failure is ValueError


def test_read_wav_truncated_fmt_and_zero_channels(tmp_path):
    from gomel_tpu.io.wavcodec import read_wav
    # truncated fmt chunk (8 bytes < 16)
    fmt8 = b"RIFF\x28\x00\x00\x00WAVE" + b"fmt " + struct.pack("<I", 8) \
        + b"\x01\x00\x01\x00\x40\x1f\x00\x00" + b"data" + struct.pack("<I", 0)
    p = _write(tmp_path / "shortfmt.wav", fmt8)
    with pytest.raises(ValueError, match="truncated fmt"):
        read_wav(p)
    # zero channels
    fmt = struct.pack("<HHIIHH", 1, 0, 8000, 16000, 2, 16)
    blob = (b"RIFF\x30\x00\x00\x00WAVE" + b"fmt "
            + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", 4) + b"\x00\x00\x00\x00")
    p = _write(tmp_path / "zeroch.wav", blob)
    with pytest.raises(ValueError, match="zero channels"):
        read_wav(p)


def test_read_wav_odd_payload_truncates_cleanly(tmp_path):
    from gomel_tpu.io.wavcodec import read_wav
    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 16000, 2, 16)
    blob = (b"RIFF\x30\x00\x00\x00WAVE" + b"fmt "
            + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", 5) + b"\x01\x00\x02\x00\x03")
    p = _write(tmp_path / "odd.wav", blob)
    arr, sr = read_wav(p)
    assert sr == 8000 and list(arr) == [1, 2]
