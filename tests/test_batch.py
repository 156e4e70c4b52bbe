"""Length-bucketed batcher + data-parallel pipeline tests (8-dev CPU mesh)."""
import jax.numpy as jnp
import numpy as np

from gomel_tpu.core.config import MelConfig, PhaseConfig
from gomel_tpu.core.framing import pad_length
from gomel_tpu.parallel.batch import (BatchedMel, BatchedPhase, make_buckets,
                                      pad_batch_to_multiple)
from gomel_tpu.parallel.mesh import make_mesh
from gomel_tpu.pipelines.mel import Mel
from gomel_tpu.pipelines.phase import Phase

CFG = dict(window=64, resolut=256)


def _utts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(l).astype(np.float32) for l in lengths]


def test_bucket_grouping_and_order():
    utts = _utts([100, 5000, 120, 5100, 30000])
    buckets = make_buckets(utts, hop=64, max_batch=2)
    covered = sorted(i for b in buckets for i in b.indices)
    assert covered == [0, 1, 2, 3, 4]
    for b in buckets:
        assert b.audio.shape[1] == b.padded_len
        assert b.audio.shape[0] <= 2
        for row, i in enumerate(b.indices):
            assert b.lengths[row] == len(utts[i])
            # padded region is zeros, content preserved
            np.testing.assert_array_equal(
                b.audio[row, :b.lengths[row]], utts[i])
            assert not b.audio[row, b.lengths[row]:].any()
        # bucket length is at least the reference padded length of each item
        for row, i in enumerate(b.indices):
            assert b.padded_len >= pad_length(len(utts[i]), 64)


def test_pad_batch_to_multiple():
    utts = _utts([100, 200, 300])
    b = make_buckets(utts, hop=64, max_batch=8)[0]
    p = pad_batch_to_multiple(b, 4)
    assert p.audio.shape[0] == 4
    assert p.indices[-1] == -1 and p.lengths[-1] == 0


def test_batched_mel_matches_single():
    mesh = make_mesh(data=8, frame=1)
    cfg = MelConfig(num_mels=24, **CFG)
    bm = BatchedMel(cfg, mesh=mesh)
    single = Mel(cfg)
    L = pad_length(4000, cfg.window)
    rng = np.random.default_rng(1)
    xb = rng.standard_normal((8, L)).astype(np.float32)
    got = np.asarray(bm.encode(xb))
    for i in range(8):
        want = np.asarray(single.encode(xb[i]))
        np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=1e-5)


def test_batched_phase_roundtrip_matches_single():
    mesh = make_mesh(data=8, frame=1)
    cfg = PhaseConfig(num_freqs=96, **CFG)
    bp = BatchedPhase(cfg, mesh=mesh)
    single = Phase(cfg)
    L = pad_length(4000, cfg.window)
    rng = np.random.default_rng(2)
    xb = rng.standard_normal((8, L)).astype(np.float32)
    spec = bp.encode(xb)
    dec = np.asarray(bp.decode(spec))
    for i in range(8):
        want_spec = np.asarray(single.encode(xb[i]))
        np.testing.assert_allclose(np.asarray(spec)[i], want_spec,
                                   atol=1e-5, rtol=1e-5)
        want_dec = np.asarray(single.decode(want_spec))
        np.testing.assert_allclose(dec[i], want_dec, atol=1e-4, rtol=1e-4)


def test_encode_buckets_end_to_end():
    mesh = make_mesh(data=2, frame=1)
    cfg = MelConfig(num_mels=16, **CFG)
    bm = BatchedMel(cfg, mesh=mesh)
    utts = _utts([1000, 1100, 9000], seed=3)
    results = bm.encode_buckets(utts, max_batch=4)
    single = Mel(cfg)
    seen = set()
    for bucket, logmel in results:
        assert logmel.shape[0] == len(bucket.indices)
        for row, i in enumerate(bucket.indices):
            seen.add(int(i))
            # single-utterance pipeline pads to pad_length(len);
            # bucket pads further -> frames prefix must match
            want = np.asarray(single.encode(utts[i]))
            got = np.asarray(logmel[row])[: want.shape[0]]
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert seen == {0, 1, 2}


def test_input_mode_validation():
    import pytest
    with pytest.raises(ValueError, match="input_mode"):
        BatchedMel(MelConfig(num_mels=16, **CFG), input_mode="bogus")
    with pytest.raises(ValueError, match="requires a mesh"):
        BatchedMel(MelConfig(num_mels=16, **CFG), input_mode="process_local")


def test_process_local_single_process_equals_replicated():
    # on one process, process_local reduces to the plain device_put path
    mesh = make_mesh(data=8, frame=1)
    cfg = MelConfig(num_mels=24, **CFG)
    L = pad_length(3000, cfg.window)
    xb = np.random.default_rng(3).standard_normal((8, L)).astype(np.float32)
    a = np.asarray(BatchedMel(cfg, mesh=mesh).encode(xb))
    b = np.asarray(BatchedMel(cfg, mesh=mesh,
                              input_mode="process_local").encode(xb))
    np.testing.assert_array_equal(a, b)


def test_local_rows_roundtrip_single_process():
    from gomel_tpu.parallel.batch import local_rows
    mesh = make_mesh(data=4, frame=2)
    cfg = MelConfig(num_mels=24, **CFG)
    bm = BatchedMel(cfg, mesh=mesh)
    L = pad_length(3000, cfg.window)
    xb = np.random.default_rng(4).standard_normal((4, L)).astype(np.float32)
    enc = bm.encode(xb)
    rows = local_rows(enc, 3)
    np.testing.assert_array_equal(rows, np.asarray(enc)[:3])


def test_decode_accepts_global_encode_result():
    # decode fed the (sharded) result of encode directly — the pod-side flow
    mesh = make_mesh(data=8, frame=1)
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=2, **CFG)
    bm = BatchedMel(cfg, mesh=mesh)
    L = pad_length(3000, cfg.window)
    xb = np.random.default_rng(5).standard_normal((8, L)).astype(np.float32)
    enc = bm.encode(xb)
    out = np.asarray(bm.decode(enc, seed=0))
    want = np.asarray(bm.decode(np.asarray(enc), seed=0))
    np.testing.assert_allclose(out, want, atol=1e-6, rtol=1e-6)


def test_batch_explicit_encoders_match_vmap():
    """mel_encode_batch / phase_encode_batch are a pure formulation change
    (ops/mel_ops.py) — their output must match jax.vmap of the
    single-signal encoders."""
    import jax
    from gomel_tpu.core.filterbank import mel_weights
    from gomel_tpu.ops.mel_ops import mel_encode, mel_encode_batch
    from gomel_tpu.ops.phase_ops import phase_encode, phase_encode_batch

    frame_len, hop, num_mels, num_freqs = 128, 32, 24, 40
    L = pad_length(3000, hop)
    xb = jnp.asarray(
        np.random.default_rng(6).standard_normal((3, L)), jnp.float64)
    fwd = jnp.asarray(mel_weights(frame_len // 2, num_mels, 0.0, 8000.0),
                      jnp.float64)

    got = mel_encode_batch(xb, num_mels, frame_len, hop, fwd)
    want = jax.vmap(lambda x: mel_encode(x, num_mels, frame_len, hop, fwd))(xb)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)

    gotp = phase_encode_batch(xb, num_freqs, frame_len, hop)
    wantp = jax.vmap(lambda x: phase_encode(x, num_freqs, frame_len, hop))(xb)
    np.testing.assert_allclose(np.asarray(gotp), np.asarray(wantp),
                               rtol=1e-12, atol=1e-12)


def test_batched_mel_encode_quantized_matches_single():
    """Per-row masked extrema = quantizing each file alone: rows of the
    batched fused quantizer (sliced to true frames) match
    Mel(device_quantize=True).encode_quantized within one trunc step."""
    from gomel_tpu.core.framing import frames_for_padded
    mesh = make_mesh(data=2, frame=1)
    cfg = MelConfig(num_mels=24, **CFG)
    bm = BatchedMel(cfg, mesh=mesh)
    single = Mel(cfg, device_quantize=True)
    utts = _utts([1000, 2500, 3100], seed=7)
    for bucket in make_buckets(utts, cfg.window, max_batch=4):
        frames = np.asarray(
            [frames_for_padded(int(L), cfg.window, cfg.resolut)
             for L in bucket.lengths], np.int32)
        img2b, mxb, mnb = bm.encode_quantized(bucket.audio, frames)
        img2b = np.asarray(img2b)
        for row, i in enumerate(bucket.indices):
            w_img, w_mx, w_mn = single.encode_quantized(utts[i])
            w_img = np.asarray(w_img)
            f = int(frames[row])
            assert w_img.shape[1] == f
            got = img2b[row][:, :f].astype(np.int64)
            np.testing.assert_allclose(
                float(np.asarray(mxb)[row]), float(w_mx), rtol=1e-5)
            np.testing.assert_allclose(
                float(np.asarray(mnb)[row]), float(w_mn), rtol=1e-5)
            diff = np.abs(got - w_img.astype(np.int64))
            assert diff.max() <= 1
            assert (diff > 0).mean() < 2e-3


def test_batched_phase_quantized_roundtrip_matches_single():
    """Fused batched phase quantize (with IHS) + fused batched dequantize
    decode: parity with the single-file device paths."""
    from gomel_tpu.core.framing import frames_for_padded
    from gomel_tpu.ops.quantize import quantize_planes
    mesh = make_mesh(data=2, frame=1)
    cfg = PhaseConfig(num_freqs=96, ihs=True, **CFG)
    bp = BatchedPhase(cfg, mesh=mesh)
    single = Phase(cfg, device_quantize=True)
    utts = _utts([1500, 2800], seed=8)
    bucket = make_buckets(utts, cfg.window, max_batch=4)[0]
    frames = np.asarray(
        [frames_for_padded(int(L), cfg.window, cfg.resolut)
         for L in bucket.lengths], np.int32)
    img2b, mxb, mnb = bp.encode_quantized(bucket.audio, frames)
    img2b, mxb, mnb = np.asarray(img2b), np.asarray(mxb), np.asarray(mnb)
    for row, i in enumerate(bucket.indices):
        w_img, w_mx, w_mn = single.encode_quantized(utts[i])
        w_img = np.asarray(w_img)
        f = int(frames[row])
        got = img2b[row][:, :f].astype(np.int64)
        np.testing.assert_allclose(mxb[row], np.asarray(w_mx), rtol=1e-5)
        np.testing.assert_allclose(mnb[row], np.asarray(w_mn), rtol=1e-5)
        diff = np.abs(got - w_img.astype(np.int64))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 2e-3
    # decode the batch of quantized planes: rows match the single-file
    # fused dequantize+decode on the same planes (exact same program)
    wavs = np.asarray(bp.decode_quantized(img2b, mxb, mnb))
    for row, i in enumerate(bucket.indices):
        f = int(frames[row])
        want = np.asarray(single.decode_quantized(
            img2b[row], mxb[row], mnb[row]))
        np.testing.assert_allclose(wavs[row], want, atol=1e-4, rtol=1e-4)


def test_batch_cli_device_quantize(tmp_path):
    """batch-tomel/batch-towav and batch-tophase/batch-fromphase with
    --device-quantize: files written are readable and byte-near the host
    quantizer's output."""
    from gomel_tpu.cli.batch import (batch_fromphase, batch_tomel,
                                     batch_tophase, batch_towav)
    from gomel_tpu.io.audio import save_wav, load_wav
    from gomel_tpu.io.pngcodec import read_png
    import os
    rng = np.random.default_rng(9)
    wav_dir = tmp_path / "wavs"
    os.makedirs(wav_dir)
    for k, secs in enumerate([0.4, 0.7]):
        t = np.arange(int(secs * 48000)) / 48000
        a = 0.4 * np.sin(2 * np.pi * (300 + 100 * k) * t) \
            + 0.05 * rng.standard_normal(t.shape)
        save_wav(str(wav_dir / f"u{k}.wav"), a, 48000)

    # phase: encode both ways, compare pixels, then decode fused
    for tag, extra in [("h", ["--host-quantize"]), ("d", ["--device-quantize"])]:
        rc = batch_tophase([str(wav_dir), "--out-dir",
                            str(tmp_path / f"p_{tag}")] + extra)
        assert rc == 0
    for k in range(2):
        a = read_png(str(tmp_path / "p_h" / f"u{k}.wav.png"))
        b = read_png(str(tmp_path / "p_d" / f"u{k}.wav.png"))
        assert a.shape == b.shape
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
        diff = np.minimum(diff, 256 - diff)  # wrapped B channel
        assert diff.max() <= 1
    rc = batch_fromphase([str(tmp_path / "p_d"), "--out-dir",
                          str(tmp_path / "pw"), "--device-quantize"])
    assert rc == 0
    for k in range(2):
        w, sr = load_wav(str(tmp_path / "pw" / f"u{k}.wav.png.wav"))
        assert sr == 48000 and len(w) > 0

    # mel: same shape of checks
    for tag, extra in [("h", ["--host-quantize"]), ("d", ["--device-quantize"])]:
        rc = batch_tomel([str(wav_dir), "--out-dir",
                          str(tmp_path / f"m_{tag}")] + extra)
        assert rc == 0
    for k in range(2):
        a = read_png(str(tmp_path / "m_h" / f"u{k}.wav.png"))
        b = read_png(str(tmp_path / "m_d" / f"u{k}.wav.png"))
        assert a.shape == b.shape
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert diff.max() <= 1
    rc = batch_towav([str(tmp_path / "m_d"), "--out-dir",
                      str(tmp_path / "mw"), "--device-quantize"])
    assert rc == 0
    for k in range(2):
        w, sr = load_wav(str(tmp_path / "mw" / f"u{k}.wav.png.wav"))
        assert sr == 44100 and len(w) > 0


def test_batched_mel_encode_quantized_int16_matches_float():
    """The raw-PCM batch ingest (int16 upload + per-row power-of-two
    scales) produces IDENTICAL quantized planes to the float ingest of the
    converted signal — /32768 and /65536 are exact in f32."""
    cfg = MelConfig(num_mels=24, **CFG)
    bm = BatchedMel(cfg)
    rng = np.random.default_rng(10)
    L = pad_length(3000, cfg.window)
    pcm = rng.integers(-32768, 32767, size=(3, L), dtype=np.int16)
    scales = np.asarray([32768.0, 65536.0, 32768.0], np.float32)
    from gomel_tpu.core.framing import frames_for_padded
    frames = np.full(3, frames_for_padded(L, cfg.window, cfg.resolut),
                     np.int32)
    img_i, mx_i, mn_i = bm.encode_quantized(pcm, frames, scales=scales)
    flt = pcm.astype(np.float32) / scales[:, None]
    img_f, mx_f, mn_f = bm.encode_quantized(flt, frames)
    np.testing.assert_array_equal(np.asarray(img_i), np.asarray(img_f))
    np.testing.assert_allclose(np.asarray(mx_i), np.asarray(mx_f), rtol=0)
    np.testing.assert_allclose(np.asarray(mn_i), np.asarray(mn_f), rtol=0)


def test_batch_tomel_mixed_wav_flac_raw_ingest(tmp_path):
    """batch-tomel's raw int16 ingest handles a mixed WAV+FLAC directory
    (different per-row scales: 1/32768 vs 1/65536) and its PNGs match the
    single-file device path byte-for-byte (same program content)."""
    import os
    from gomel_tpu.cli.batch import batch_tomel
    from gomel_tpu.io.audio import save_wav
    from gomel_tpu.io.flac import write_flac
    from gomel_tpu.io.pngcodec import read_png
    rng = np.random.default_rng(11)
    d = tmp_path / "in"
    os.makedirs(d)
    t = np.arange(int(0.5 * 48000)) / 48000
    a1 = 0.4 * np.sin(2 * np.pi * 300 * t) + 0.02 * rng.standard_normal(t.shape)
    a2 = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.standard_normal(t.shape)
    save_wav(str(d / "u0.wav"), a1, 48000)
    write_flac(str(d / "u1.flac"),
               np.clip(np.rint(a2 * 32767), -32768, 32767).astype(np.int16),
               48000)
    out = tmp_path / "png"
    rc = batch_tomel([str(d), "--out-dir", str(out), "--window", "256",
                      "--resolut", "1024", "--num-mels", "32",
                      "--fmax", "8000"])
    assert rc == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == ["u0.wav.png", "u1.flac.png"]
    # cross-check vs the single-file device-quantize path
    from gomel_tpu.pipelines.mel import Mel
    m = Mel(MelConfig(num_mels=32, mel_fmax=8000.0, y_reverse=True,
                      window=256, resolut=1024), device_quantize=True)
    m.to_mel_wav(str(d / "u0.wav"), str(tmp_path / "single0.png"))
    m.to_mel_flac(str(d / "u1.flac"), str(tmp_path / "single1.png"))
    for got, want in [("u0.wav.png", "single0.png"),
                      ("u1.flac.png", "single1.png")]:
        g = read_png(str(out / got))
        w = read_png(str(tmp_path / want))
        assert g.shape == w.shape
        assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= 1


def test_batched_phase_encode_quantized_int16_matches_float():
    """BatchedPhase int16 ingest (fixed 1/32768) == float ingest of the
    converted batch, bit-for-bit on the quantized planes."""
    cfg = PhaseConfig(num_freqs=96, **CFG)
    bp = BatchedPhase(cfg)
    rng = np.random.default_rng(12)
    L = pad_length(3000, cfg.window)
    pcm = rng.integers(-32768, 32767, size=(2, L), dtype=np.int16)
    from gomel_tpu.core.framing import frames_for_padded
    frames = np.full(2, frames_for_padded(L, cfg.window, cfg.resolut),
                     np.int32)
    img_i, mx_i, mn_i = bp.encode_quantized(pcm, frames)
    img_f, mx_f, mn_f = bp.encode_quantized(
        pcm.astype(np.float32) / 32768.0, frames)
    np.testing.assert_array_equal(np.asarray(img_i), np.asarray(img_f))
    np.testing.assert_array_equal(np.asarray(mx_i), np.asarray(mx_f))
    np.testing.assert_array_equal(np.asarray(mn_i), np.asarray(mn_f))
