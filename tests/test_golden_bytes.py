"""Independent byte-level anchors for the PNG persistence layouts.

Round-1 parity rested on round-tripping the repo's own writer+reader pair —
a shared byte-layout bug would be invisible.
These tests break that circularity three ways:

1. Golden artifact: /root/reference/glados-1609757458000_.png is the one file
   in the environment actually produced by the Go toolchain (referenced at
   /root/reference/README.md:5). It predates the metadata block (its blue
   channel tracks red; no float16 bytes), so it cannot pin the metadata
   layout — but it pins the PNG *container* decode: our from-scratch codec
   must byte-match PIL (an independent decoder) on an authentic
   Go-image/png-encoded file, including checked-in checksums.

2. Writer fixtures: hand-computed expected pixel bytes derived from the Go
   source (mel writer /root/reference/mel/impl.go:127-193; phase writer
   /root/reference/phase/impl.go:168-278), with float16 metadata bytes
   written as hex literals (computed from the IEEE 754 binary16 definition,
   matching x448/float16's LittleEndian packing, phase/impl.go:155-160).
   The written PNG is decoded with PIL, not our reader.

3. Reader fixtures: PNGs are synthesized with PIL (independent encoder)
   from the same hand-computed byte arrays and decoded with our readers.

A flipped byte order, wrong metadata offset, wrong channel, or wrong
truncation rule fails these tests.
"""
import os

import numpy as np
import pytest

PIL = pytest.importorskip("PIL.Image")

from gomel_tpu.io.imagecodec import (load_mel_image, load_phase_image,
                                     save_mel_image, save_phase_image)
from gomel_tpu.io.pngcodec import read_png

GLADOS = "/root/reference/glados-1609757458000_.png"

# float16 little-endian byte literals (IEEE binary16):
F16 = {
    2.0: b"\x00\x40",
    1.0: b"\x00\x3c",
    0.0: b"\x00\x00",
    -1.0: b"\x00\xbc",
    3.5: b"\x00\x43",
    48000.0: b"\xdc\x79",
}


# ---------------------------------------------------------------------------
# 1. authentic Go artifact
# ---------------------------------------------------------------------------

def test_glados_container_decode_matches_pil():
    ours = read_png(GLADOS)
    theirs = np.asarray(PIL.open(GLADOS))
    assert ours.shape == theirs.shape == (80, 183, 3)
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_glados_checked_in_expectations():
    img = read_png(GLADOS)
    # checked-in golden facts (computed once from the PIL decode)
    assert [int(img[..., c].astype(np.uint64).sum()) for c in range(3)] == \
        [388259, 388160, 388191]
    assert img[0, :4].tolist() == [[2, 2, 2]] * 4
    # pre-metadata vintage: no float16 block — blue equals red in the
    # 8-byte metadata window (both are just pixel data)
    flipped = img[::-1]
    np.testing.assert_array_equal(flipped[-8:, 0, 2], flipped[-8:, 0, 0])


def test_glados_loads_without_error():
    spec, samples, sr = load_mel_image(GLADOS, y_reverse=True)
    assert spec.shape == (183, 80, 2)
    assert np.isfinite(spec).all()


# ---------------------------------------------------------------------------
# 2. mel writer: hand-computed bytes (Go semantics, mel/impl.go:127-193)
# ---------------------------------------------------------------------------

def _mel_fixture():
    # spec[frame, mel, ch]; buf[y + x*mels][l] <-> spec[x, y, l]
    spec = np.zeros((3, 16, 2))
    spec[0, 0, 0] = 2.0      # -> global max
    spec[1, 2, 0] = 1.0      # norm 0.5 -> uint8(int(127.5)) = 127
    # global min 0.0
    meta = (F16[2.0] + F16[0.0] + F16[3.5] + F16[48000.0])
    return spec, meta


def test_mel_writer_bytes(tmp_path):
    spec, meta = _mel_fixture()
    path = str(tmp_path / "m.png")
    save_mel_image(path, spec, y_reverse=False, samples_in_mel=3.5,
                   sample_rate=48000.0)
    img = np.asarray(PIL.open(path))          # independent decoder
    assert img.shape == (16, 3, 4)
    expect_r = np.zeros((16, 3), np.uint8)
    expect_r[0, 0] = 255                       # (x=0, y=0) val0=1.0
    expect_r[2, 1] = 127                       # (x=1, y=2) val0=0.5
    np.testing.assert_array_equal(img[:, :, 0], expect_r)
    np.testing.assert_array_equal(img[:, :, 1], 0)      # G: all zero
    expect_b = np.zeros((16, 3), np.uint8)
    expect_b[8:, 0] = np.frombuffer(meta, np.uint8)     # metaStart = 16-8
    np.testing.assert_array_equal(img[:, :, 2], expect_b)
    np.testing.assert_array_equal(img[:, :, 3], 255)


def test_mel_writer_bytes_y_reverse(tmp_path):
    spec, meta = _mel_fixture()
    path = str(tmp_path / "m.png")
    save_mel_image(path, spec, y_reverse=True, samples_in_mel=3.5,
                   sample_rate=48000.0)
    img = np.asarray(PIL.open(path))
    # reverse: pixel (x, mels-1-y); metadata bytes land at rows 7..0 (flipped)
    assert img[15, 0, 0] == 255
    assert img[13, 1, 0] == 127
    np.testing.assert_array_equal(img[7::-1, 0, 2], np.frombuffer(meta, np.uint8))


def test_mel_reader_bytes(tmp_path):
    # synthesize with PIL from hand bytes; decode with OUR reader
    _, meta = _mel_fixture()
    img = np.zeros((16, 3, 3), np.uint8)
    img[0, 0, 0] = 255
    img[2, 1, 0] = 127
    img[8:, 0, 2] = np.frombuffer(meta, np.uint8)
    path = str(tmp_path / "m.png")
    PIL.fromarray(img, "RGB").save(path)
    spec, samples, sr = load_mel_image(path, y_reverse=False)
    assert spec.shape == (3, 16, 2)
    assert sr == 48000.0
    assert samples == 3.5 * 3                   # samples_in_mel * stride
    # values rescale to [min, max] = [0, 2]
    assert spec[0, 0, 0] == pytest.approx(2.0)
    assert spec[1, 2, 0] == pytest.approx(2.0 * 127 / 255)
    assert spec[2, 5, 0] == pytest.approx(0.0)


def test_mel_reader_legacy_guard(tmp_path):
    # mgc_max == samples_in_mel -> samples forced to 0 (mel/impl.go:105-107)
    img = np.zeros((16, 3, 3), np.uint8)
    meta = F16[2.0] + F16[0.0] + F16[2.0] + F16[48000.0]
    img[8:, 0, 2] = np.frombuffer(meta, np.uint8)
    path = str(tmp_path / "m.png")
    PIL.fromarray(img, "RGB").save(path)
    _, samples, _ = load_mel_image(path, y_reverse=False)
    assert samples == 0.0


# ---------------------------------------------------------------------------
# 3. phase writer/reader: 16-byte block, B = -val0 hint, per-channel min/max
#    (phase/impl.go:168-278)
# ---------------------------------------------------------------------------

def _phase_fixture():
    # nf=24 -> metaStart = 24-16 = 8: rows 0..7 carry the -val0 hint,
    # rows 8..23 the metadata block (column x=0 only).
    spec = np.zeros((3, 24, 2))
    spec[0, 0, 0] = 2.0      # ch0 max
    spec[1, 2, 0] = 1.0      # ch0 norm 0.5
    spec[0, 1, 1] = 1.0      # ch1 max
    spec[2, 3, 1] = -1.0     # ch1 min -> norm 0
    meta = (F16[2.0] + F16[1.0] + F16[0.0] + F16[0.0] + F16[-1.0]
            + F16[0.0] + F16[3.5] + F16[48000.0])
    return spec, meta


def test_phase_writer_bytes(tmp_path):
    spec, meta = _phase_fixture()
    path = str(tmp_path / "p.png")
    save_phase_image(path, spec, y_reverse=False, samples_in_mel=3.5,
                     sample_rate=48000.0, layout="go")
    img = np.asarray(PIL.open(path))
    assert img.shape == (24, 3, 4)
    # R: ch0 normalized to [0,2] -> val{2:255, 1:127, 0:0}
    expect_r = np.zeros((24, 3), np.uint8)
    expect_r[0, 0] = 255
    expect_r[2, 1] = 127
    np.testing.assert_array_equal(img[:, :, 0], expect_r)
    # G: ch1 normalized to [-1,1] -> val{1:255, 0:127, -1:0}
    expect_g = np.full((24, 3), 127, np.uint8)
    expect_g[1, 0] = 255
    expect_g[3, 2] = 0
    np.testing.assert_array_equal(img[:, :, 1], expect_g)
    # B: -val0 with Go uint8 wrap: uint8(int(255 * -1.0)) = 1,
    # uint8(int(-127.5)) = uint8(-127) = 129, -0 -> 0
    expect_b = np.zeros((24, 3), np.uint8)
    expect_b[0, 0] = 1      # will be overwritten by meta? no: metaStart=8
    expect_b[2, 1] = 129
    expect_b[8:, 0] = np.frombuffer(meta, np.uint8)
    np.testing.assert_array_equal(img[:, :, 2], expect_b)
    np.testing.assert_array_equal(img[:, :, 3], 255)


def test_phase_reader_bytes(tmp_path):
    _, meta = _phase_fixture()
    img = np.zeros((24, 3, 3), np.uint8)
    img[0, 0, 0] = 255
    img[2, 1, 0] = 127
    img[:, :, 1] = 127
    img[1, 0, 1] = 255
    img[3, 2, 1] = 0
    img[8:, 0, 2] = np.frombuffer(meta, np.uint8)
    path = str(tmp_path / "p.png")
    PIL.fromarray(img, "RGB").save(path)
    spec, samples, sr, nf = load_phase_image(path, y_reverse=False,
                                             layout="go")
    assert (nf, spec.shape[0]) == (24, 3)
    assert sr == 48000.0
    assert samples == 3.5 * 3
    # per-channel rescale: ch0 [0,2], ch1 [-1,1]
    assert spec[0, 0, 0] == pytest.approx(2.0)
    assert spec[1, 2, 0] == pytest.approx(2.0 * 127 / 255)
    assert spec[0, 1, 1] == pytest.approx(1.0)
    assert spec[2, 3, 1] == pytest.approx(-1.0)
    assert spec[1, 5, 1] == pytest.approx(2.0 * 127 / 255 - 1.0)


def test_phase_reader_detects_byte_order_flip(tmp_path):
    """A big-endian float16 pack must NOT read back as the fixture values."""
    img = np.zeros((24, 3, 3), np.uint8)
    meta_le = (F16[2.0] + F16[1.0] + F16[0.0] + F16[0.0] + F16[-1.0]
               + F16[0.0] + F16[3.5] + F16[48000.0])
    meta_be = b"".join(meta_le[i:i + 2][::-1] for i in range(0, 16, 2))
    img[8:, 0, 2] = np.frombuffer(meta_be, np.uint8)
    path = str(tmp_path / "p.png")
    PIL.fromarray(img, "RGB").save(path)
    spec, samples, sr, _ = load_phase_image(path, y_reverse=False,
                                            layout="go")
    assert sr != 48000.0 or samples != 10.5


def _cv2_read_rgb(path):
    """Independent 16-bit PNG decode (PIL silently downconverts 16-bit RGB
    to 8-bit, so OpenCV is the independent decoder here); BGR(A) -> RGB(A)."""
    cv2 = pytest.importorskip("cv2")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert img is not None
    if img.ndim == 3 and img.shape[2] >= 3:
        order = [2, 1, 0] + ([3] if img.shape[2] == 4 else [])
        img = img[:, :, order]
    return img


def test_phase_hdr_writer_bytes(tmp_path):
    """HDR: 16-bit samples, metadata byte stored AS the uint16 value
    (low byte), B hint wraps mod 65536 (phase/impl.go:233-248)."""
    spec, meta = _phase_fixture()
    path = str(tmp_path / "p16.png")
    save_phase_image(path, spec, y_reverse=False, samples_in_mel=3.5,
                     sample_rate=48000.0, layout="go", hdr=True)
    img = _cv2_read_rgb(path)
    assert img.dtype == np.uint16 and img.shape == (24, 3, 4)
    assert img[0, 0, 0] == 65535
    assert img[2, 1, 0] == 32767          # int(65535*0.5) = 32767
    # metadata bytes stored as raw uint16 values
    np.testing.assert_array_equal(
        img[8:, 0, 2], np.frombuffer(meta, np.uint8).astype(np.uint16))
    # B hint: uint16(int(65535 * -1.0)) wraps to 1
    assert img[0, 0, 2] == 1
    assert img[2, 1, 2] == 65536 - 32767  # int(-32767.5) -> -32767 & 0xFFFF


def test_phase_hdr_reader_bytes(tmp_path):
    _, meta = _phase_fixture()
    img = np.zeros((24, 3, 3), np.uint16)
    img[0, 0, 0] = 65535
    img[2, 1, 0] = 32767
    img[:, :, 1] = 32767
    img[1, 0, 1] = 65535
    img[8:, 0, 2] = np.frombuffer(meta, np.uint8).astype(np.uint16)
    path = str(tmp_path / "p16.png")
    # OpenCV as the INDEPENDENT 16-bit PNG encoder (expects BGR order)
    cv2 = pytest.importorskip("cv2")
    assert cv2.imwrite(path, img[:, :, [2, 1, 0]])
    spec, samples, sr, _ = load_phase_image(path, y_reverse=False,
                                            layout="go", hdr=True)
    assert sr == 48000.0
    assert samples == 3.5 * 3
    assert spec[0, 0, 0] == pytest.approx(2.0)


def test_towav_end_to_end_on_authentic_go_artifact(tmp_path):
    """Pin the WHOLE PNG -> mel -> Griffin-Lim -> WAV chain on real Go
    encoder output (README.md:5's glados-1609757458000_.png, 183x80), not
    just the container decode. Checked-in expectations
    at seed 0: exact output length resolut + (F-1)*hop = 237056, RMS/peak
    bands wide enough for backend float noise but tight enough to catch any
    chain regression (measured 2026-08-17: rms 0.02909, peak 0.1081)."""
    import os
    from gomel_tpu.cli import tools
    from gomel_tpu.io.audio import load_wav

    src = "/root/reference/glados-1609757458000_.png"
    if not os.path.exists(src):
        pytest.skip("reference artifact not present")
    out = str(tmp_path / "glados.wav")
    rc = tools.towav([src, "44100", "-o", out, "--num-mels", "80",
                      "--seed", "0"])
    assert rc == 0
    wave, sr = load_wav(out)
    assert sr == 44100
    assert len(wave) == 237056  # 4096 + 182*1280, no trim (legacy metadata)
    rms = float(np.sqrt(np.mean(wave ** 2)))
    assert 0.027 < rms < 0.032, rms
    peak = float(np.abs(wave).max())
    assert 0.08 < peak < 0.16, peak
    # explicit-PRNG determinism (the reference uses unseeded math/rand)
    out2 = str(tmp_path / "glados2.wav")
    assert tools.towav([src, "44100", "-o", out2, "--num-mels", "80",
                       "--seed", "0"]) == 0
    np.testing.assert_array_equal(wave, load_wav(out2)[0])


# ---------------------------------------------------------------------------
# Hand-constructed Go-layout PHASE fixtures
# ---------------------------------------------------------------------------
# The mel reader is pinned by the authentic Go artifact above; the reference
# repo ships no Go-binary PHASE PNG, so tests/fixtures/ carries artifacts
# built by an INDEPENDENT line-by-line transcription of the Go writer
# (make_phase_go_fixture.py: pure-Python per-pixel loops + its own minimal
# PNG encoder, no gomel_tpu imports) together with expectations computed by
# transcribing the Go READER math — closing the self-consistency loophole
# (writer and reader here were otherwise only validated against each other).

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.mark.parametrize("name,ihs,hdr", [
    ("phase_go_8bit", 0, False),
    ("phase_go_8bit_ihs", 2, False),
    ("phase_go_hdr", 0, True),
])
def test_phase_reader_on_go_fixture(name, ihs, hdr):
    """load_phase_image must reproduce the Go loadpng decode of the
    hand-constructed Go-writer bytes: spectrogram values, samples, sr
    (phase/impl.go:51-153 vs 168-278)."""
    from gomel_tpu.io.imagecodec import load_phase_image

    exp = np.load(os.path.join(FIXDIR, "phase_go_expected.npz"))
    spec, samples, sr, nf = load_phase_image(
        os.path.join(FIXDIR, name + ".png"), y_reverse=True,
        ihs_passes=ihs, hdr=hdr, layout="go")
    assert nf == 32
    assert sr == float(exp[name + "_sr"]) == 48000.0
    assert samples == float(exp[name + "_samples"]) == 39936.0
    np.testing.assert_allclose(spec, exp[name + "_spec"], rtol=0, atol=1e-12)


def test_phase_go_fixture_autodetects_go_layout():
    """The 16-byte layout auto-detector must classify the hand-built Go
    artifact as 'go' (the B = -val0 wraparound hint is nonzero off-column-0,
    imagecodec._detect_phase_layout)."""
    from gomel_tpu.io.imagecodec import load_phase_image

    exp = np.load(os.path.join(FIXDIR, "phase_go_expected.npz"))
    spec, samples, sr, _ = load_phase_image(
        os.path.join(FIXDIR, "phase_go_8bit.png"), y_reverse=True,
        layout="auto")
    assert sr == 48000.0 and samples == 39936.0
    np.testing.assert_allclose(spec, exp["phase_go_8bit_spec"],
                               rtol=0, atol=1e-12)


def test_fromphase_cli_decodes_go_fixture(tmp_path):
    """fromphase end-to-end on the hand-built Go artifact: exit 0, output
    WAV at the family main rate with the iSTFT length for 24 frames."""
    from gomel_tpu.cli import tools
    from gomel_tpu.io.audio import load_wav

    out = str(tmp_path / "go_fixture.wav")
    rc = tools.fromphase([os.path.join(FIXDIR, "phase_go_8bit.png"),
                          "-o", out, "--num-freqs", "32",
                          "--window", "32", "--resolut", "128",
                          "--metadata-layout", "go"])
    assert rc == 0
    wave, sr = load_wav(out)
    assert sr == 48000  # nf=32 is not in the 836-family -> main rate 48000
    assert len(wave) > 0 and np.isfinite(wave).all()
