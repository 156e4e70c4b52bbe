"""FLAC codec tests: encoder/decoder round trips, native vs Python decoder
parity, and the mel/phase scaling difference (SURVEY.md §5.3)."""
import numpy as np
import pytest

from gomel_tpu.io import flac
from gomel_tpu.io.audio import load_flac


def _pcm(n, ch=1, seed=0, bps=16):
    rng = np.random.default_rng(seed)
    lim = 1 << (bps - 1)
    a = rng.integers(-lim, lim, size=(n, ch) if ch > 1 else n, dtype=np.int64)
    return a


def test_roundtrip_mono(tmp_path):
    a = _pcm(10000)
    p = str(tmp_path / "m.flac")
    flac.write_flac(p, a, 48000)
    got, sr = flac.read_flac(p)
    assert sr == 48000
    np.testing.assert_array_equal(got.astype(np.int64), a)


def test_roundtrip_stereo_and_odd_tail(tmp_path):
    a = _pcm(4096 * 2 + 123, ch=2, seed=1)
    p = str(tmp_path / "s.flac")
    flac.write_flac(p, a, 44100)
    got, sr = flac.read_flac(p)
    assert sr == 44100
    assert got.shape == a.shape
    np.testing.assert_array_equal(got.astype(np.int64), a)


def test_roundtrip_float_input(tmp_path):
    rng = np.random.default_rng(2)
    a = (rng.random(5000) * 1.8 - 0.9).astype(np.float64)
    p = str(tmp_path / "f.flac")
    flac.write_flac(p, a, 16000)
    got, sr = flac.read_flac(p)
    np.testing.assert_allclose(got / 32768.0, a, atol=1.0 / 32768)


def test_python_decoder_matches_native(tmp_path):
    a = _pcm(9000, ch=2, seed=3)
    p = str(tmp_path / "d.flac")
    flac.write_flac(p, a, 24000)
    with open(p, "rb") as f:
        data = f.read()
    arr, nch, sr, bps = flac._decode_python(data)
    assert (nch, sr, bps) == (2, 24000, 16)
    np.testing.assert_array_equal(
        arr.reshape(-1, 2).astype(np.int64), a)
    if flac._get_lib() is not None:
        got, sr2 = flac.read_flac(p)
        np.testing.assert_array_equal(got.astype(np.int64), a)


def test_load_flac_scaling_mel_vs_phase(tmp_path):
    # reference: phase divides by 32768 (phase/impl.go:375),
    # mel by 65536 (mel/impl.go:290)
    a = np.full(8000, 16384, dtype=np.int64)
    p = str(tmp_path / "sc.flac")
    flac.write_flac(p, a, 48000)
    ph, _ = load_flac(p, scaling="phase")
    me, _ = load_flac(p, scaling="mel")
    np.testing.assert_allclose(ph, 0.5)
    np.testing.assert_allclose(me, 0.25)


def test_to_phase_flac_end_to_end(tmp_path):
    from gomel_tpu import Phase
    sr = 48000
    t = np.arange(sr) / sr
    audio = 0.5 * np.sin(2 * np.pi * 440 * t)
    p = str(tmp_path / "tone.flac")
    flac.write_flac(p, audio, sr)
    ph = Phase(sample_rate=sr)
    png = str(tmp_path / "tone.png")
    ph.to_phase_flac(p, png)
    wav = str(tmp_path / "tone.wav")
    Phase(sample_rate=sr).to_wav_png(png, wav)
    from gomel_tpu.io.audio import load_wav
    rec, _ = load_wav(wav)
    n = min(len(rec), len(audio))
    corr = np.corrcoef(audio[4096:n - 4096], rec[4096:n - 4096])[0, 1]
    assert corr > 0.99


def test_bad_file_raises(tmp_path):
    p = str(tmp_path / "bad.flac")
    with open(p, "wb") as f:
        f.write(b"not a flac at all")
    with pytest.raises(Exception):
        flac.read_flac(p)


def test_fixed_mode_roundtrip_and_smaller(tmp_path):
    sr = 48000
    t = np.arange(20000) / sr
    tone = np.rint(20000 * np.sin(2 * np.pi * 220 * t)).astype(np.int64)
    pv = str(tmp_path / "v.flac")
    pf = str(tmp_path / "x.flac")
    flac.write_flac(pv, tone, sr, mode="verbatim")
    flac.write_flac(pf, tone, sr, mode="fixed")
    import os
    assert os.path.getsize(pf) < os.path.getsize(pv) // 2
    got_v, _ = flac.read_flac(pv)
    got_f, _ = flac.read_flac(pf)
    np.testing.assert_array_equal(got_v, got_f)
    np.testing.assert_array_equal(got_f.astype(np.int64), tone)
    # python fallback decoder agrees on the FIXED/Rice path too
    with open(pf, "rb") as fh:
        arr, nch, sr2, bps = flac._decode_python(fh.read())
    np.testing.assert_array_equal(arr.astype(np.int64), tone)


def test_left_side_stereo_decorrelation(tmp_path):
    # hand-build a left/side frame to exercise ch_code=8 in both decoders
    left = np.array([100, 200, -300, 50, 0, 7, -7, 32000], dtype=np.int64)
    right = np.array([90, 180, -310, 60, -1, 6, -8, 31000], dtype=np.int64)
    side = left - right
    import struct
    hw = flac._BitWriter()
    hw.write(0b11111111111110, 14); hw.write(0, 1); hw.write(0, 1)
    hw.write(6, 4)       # blocksize: 8-bit at end
    hw.write(10, 4)      # sample rate 48000
    hw.write(8, 4)       # left/side
    hw.write(4, 3)       # 16 bps
    hw.write(0, 1)
    hw.align()
    hdr = bytearray(hw.bytes()) + flac._utf8_number(0) + bytes([len(left) - 1])
    hdr.append(flac._crc8(bytes(hdr)))
    bw = flac._BitWriter()
    flac._write_subframe_verbatim(bw, left, 16)
    flac._write_subframe_verbatim(bw, side, 17)  # side channel gets +1 bit
    bw.align()
    frame = bytes(hdr) + bw.bytes()
    frame += struct.pack(">H", flac._crc16(frame))

    si = bytearray()
    si += struct.pack(">HH", 8, 8) + b"\x00" * 6
    packed = (48000 << 44) | (1 << 41) | (15 << 36) | len(left)
    si += packed.to_bytes(8, "big") + b"\x00" * 16
    data = b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big") + bytes(si) + frame
    p = str(tmp_path / "ls.flac")
    with open(p, "wb") as f:
        f.write(data)
    got, sr = flac.read_flac(p)
    np.testing.assert_array_equal(got[:, 0].astype(np.int64), left)
    np.testing.assert_array_equal(got[:, 1].astype(np.int64), right)
    arr, nch, _, _ = flac._decode_python(data)
    arr = arr.reshape(-1, 2)
    np.testing.assert_array_equal(arr[:, 0].astype(np.int64), left)
    np.testing.assert_array_equal(arr[:, 1].astype(np.int64), right)


def test_fuzz_decoder_no_crash(tmp_path):
    """Mutated/truncated/random streams must raise cleanly, never crash."""
    rng = np.random.default_rng(42)
    base = np.clip(rng.standard_normal(9000) * 0.3, -1, 1)
    p = str(tmp_path / "base.flac")
    flac.write_flac(p, base, 48000, mode="fixed")
    with open(p, "rb") as f:
        good = bytearray(f.read())
    for trial in range(60):
        data = bytearray(good)
        kind = trial % 3
        if kind == 0:      # random byte flips
            for _ in range(rng.integers(1, 20)):
                data[rng.integers(0, len(data))] ^= int(rng.integers(1, 256))
        elif kind == 1:    # truncate
            data = data[: rng.integers(4, len(data))]
        else:              # random garbage with flac magic
            data = bytearray(b"fLaC") + bytes(rng.integers(0, 256,
                             size=int(rng.integers(10, 400)), dtype=np.uint8))
        f2 = str(tmp_path / "fuzz.flac")
        with open(f2, "wb") as f:
            f.write(bytes(data))
        decoded = None
        try:
            decoded, sr = flac.read_flac(f2)
        except ValueError:
            pass  # clean failure is fine; a segfault would kill pytest
        if decoded is not None:
            assert len(decoded) <= len(base) * 4  # plausible size


def test_go_concat_layout(tmp_path):
    """Go reference loaders concatenate ALL channels blockwise (the
    per-channel break is commented out, phase/impl.go:373-378)."""
    rng = np.random.default_rng(9)
    n, bs = 5000, 1024
    a = rng.integers(-30000, 30000, size=(n, 2), dtype=np.int64)
    p = str(tmp_path / "st.flac")
    flac.write_flac(p, a, 48000, block_size=bs)
    got, sr = flac.read_flac(p, layout="go_concat")
    # expected: per block, ch0 then ch1
    exp = []
    for s in range(0, n, bs):
        blk = a[s:s + bs]
        exp.extend(blk[:, 0].tolist())
        exp.extend(blk[:, 1].tolist())
    np.testing.assert_array_equal(got.astype(np.int64), np.asarray(exp))
    # python fallback agrees
    with open(p, "rb") as fh:
        arr, nch, _, _ = flac._decode_python(fh.read(), 1)
    assert nch == 1
    np.testing.assert_array_equal(arr.astype(np.int64), np.asarray(exp))
    # mono files identical in both layouts
    m = str(tmp_path / "mono.flac")
    flac.write_flac(m, a[:, 0], 48000, block_size=bs)
    g1, _ = flac.read_flac(m, layout="go_concat")
    g2, _ = flac.read_flac(m, layout="interleaved")
    np.testing.assert_array_equal(g1, g2)


def test_midstream_corruption_resyncs(tmp_path):
    """A corrupt frame mid-stream must not silently truncate the rest."""
    rng = np.random.default_rng(11)
    n, bs = 4096 * 5, 1024
    a = rng.integers(-20000, 20000, size=n, dtype=np.int64)
    p = str(tmp_path / "c.flac")
    flac.write_flac(p, a, 48000, block_size=bs)
    data = bytearray(open(p, "rb").read())
    # corrupt a byte inside the 3rd audio frame's payload (not its header)
    # find frame sync words after the metadata
    syncs = [i for i in range(len(data) - 1)
             if data[i] == 0xFF and (data[i + 1] & 0xFC) == 0xF8]
    assert len(syncs) >= 5
    data[syncs[2] + 40] ^= 0xFF
    f2 = str(tmp_path / "c2.flac")
    with open(f2, "wb") as f:
        f.write(bytes(data))
    got, sr = flac.read_flac(f2)
    # all frames except the corrupted one must survive (>= 4 of 5 blocks)
    assert len(got) >= 4 * bs
    with open(f2, "rb") as fh:
        arr, nch, _, _ = flac._decode_python(fh.read())
    assert len(arr) >= 4 * bs


def test_decompression_bomb_rejected(tmp_path):
    """A stream whose frames decode to vastly more PCM than STREAMINFO
    declares must fail with rc=-7 (bounded growth) instead of allocating
    without limit."""
    import struct

    base = str(tmp_path / "base.flac")
    flac.write_flac(base, np.zeros(4096), 48000, mode="verbatim")
    data = bytearray(open(base, "rb").read())
    # STREAMINFO packed field (sr/ch/bps/total) = file bytes [18:26);
    # re-declare total_samples = 100 while keeping sr/ch/bps
    packed = int.from_bytes(data[18:26], "big")
    packed = (packed & ~((1 << 36) - 1)) | 100
    data[18:26] = packed.to_bytes(8, "big")
    # duplicate the single 4096-sample frame 40x -> 163k samples decoded
    # vs a bomb cap of (100 + 65536) * 1 channel
    body = bytes(data[42:])
    bomb = str(tmp_path / "bomb.flac")
    with open(bomb, "wb") as f:
        f.write(bytes(data[:42]) + body * 40)
    with pytest.raises(ValueError, match="rc=-7"):
        flac.read_flac(bomb)
    # the pure-Python fallback must enforce the same bound (it engages
    # whenever the native toolchain is unavailable)
    with pytest.raises(ValueError, match="rc=-7"):
        flac._decode_python(open(bomb, "rb").read())


def test_max_samples_cap_is_configurable(tmp_path):
    """Round-3 review: the bomb ceiling must not reject legitimate long
    files — it is caller-configurable; a deliberately tiny cap rejects."""
    from gomel_tpu.io.flac import read_flac, write_flac
    sr = 8000
    x = 0.25 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)
    p = str(tmp_path / "cap.flac")
    write_flac(p, x, sr)
    pcm, rate = read_flac(p)            # default cap: fine
    assert rate == sr and len(pcm) == sr
    pcm2, _ = read_flac(p, max_samples=len(pcm) + 70000)  # explicit, fine
    np.testing.assert_array_equal(pcm, pcm2)
    with pytest.raises(ValueError):
        read_flac(p, max_samples=100)   # tiny cap must reject
