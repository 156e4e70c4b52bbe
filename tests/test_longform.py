"""Long-form pipeline API: frame-sharded codecs match single-chip pipelines."""
import jax.numpy as jnp
import numpy as np
import pytest

from gomel_tpu.core.config import MelConfig, PhaseConfig
from gomel_tpu.parallel.mesh import make_mesh
from gomel_tpu.pipelines.longform import LongFormMel, LongFormPhase
from gomel_tpu.pipelines.mel import Mel
from gomel_tpu.pipelines.phase import Phase

CFG = dict(window=64, resolut=256)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=2, frame=4)


def test_longform_phase_roundtrip_matches_single(mesh):
    cfg = PhaseConfig(num_freqs=96, **CFG)
    lf = LongFormPhase(cfg, mesh)
    single = Phase(cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    spec = lf.encode(x)
    dec = np.asarray(lf.decode(spec))
    for i in range(2):
        want_spec = np.asarray(single.encode(x[i]))
        np.testing.assert_allclose(np.asarray(spec)[i], want_spec,
                                   atol=1e-4, rtol=1e-4)
        want = np.asarray(single.decode(want_spec))
        np.testing.assert_allclose(dec[i][: len(want)], want,
                                   atol=1e-3, rtol=1e-3)


def test_longform_mel_encode_matches_single(mesh):
    cfg = MelConfig(num_mels=24, **CFG)
    lf = LongFormMel(cfg, mesh)
    single = Mel(cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    got = np.asarray(lf.encode(x))
    for i in range(2):
        want = np.asarray(single.encode(x[i]))
        np.testing.assert_allclose(got[i], want, atol=1e-4, rtol=1e-4)


def test_longform_mel_decode_runs(mesh):
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=2, **CFG)
    lf = LongFormMel(cfg, mesh)
    x = np.random.default_rng(2).standard_normal((2, 4000)).astype(np.float32)
    logmel = lf.encode(x)
    out = lf.decode(logmel, seed=0)
    assert out.shape[0] == 2
    assert np.isfinite(np.asarray(out)).all()


def test_longform_mel_decode_seed_semantics(mesh):
    """Per-shard GL init (noise drawn inside shard_map, fold_in of the mesh
    axis indices) must stay deterministic per seed and vary across seeds —
    and never materialize a [B, F_pad*hop] staging tensor outside the mesh
   ."""
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=2, **CFG)
    lf = LongFormMel(cfg, mesh)
    x = np.random.default_rng(5).standard_normal((2, 4000)).astype(np.float32)
    logmel = lf.encode(x)
    a = np.asarray(lf.decode(logmel, seed=0))
    b = np.asarray(lf.decode(logmel, seed=0))
    c = np.asarray(lf.decode(logmel, seed=1))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0  # different seed, different GL phases


def test_longform_1d_input(mesh):
    cfg = PhaseConfig(num_freqs=96, **CFG)
    lf = LongFormPhase(cfg, mesh)
    x = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
    spec = lf.encode(x)
    assert spec.shape[0] == 1 and spec.shape[2] == 96


def test_decode_cache_not_stale_across_frame_counts(mesh):
    # regression: F=12 and F=13 can pad to the same n_frames_padded; the
    # cached decode fn must not reuse the smaller real-frame mask
    cfg = PhaseConfig(num_freqs=64, window=32, resolut=128)
    lf = LongFormPhase(cfg, mesh)
    single = Phase(cfg)
    rng = np.random.default_rng(7)
    for f in (12, 13, 14):
        spec = rng.standard_normal((2, f, 64, 2)).astype(np.float32)
        got = np.asarray(lf.decode(spec))
        for i in range(2):
            want = np.asarray(single.decode(spec[i]))
            np.testing.assert_allclose(got[i][: len(want)], want,
                                       atol=1e-3, rtol=1e-3)


def test_decode_resumable_matches_one_call_bit_for_bit(mesh):
    """Segmented Griffin-Lim (decode_resumable) executes the identical
    iteration sequence as the one-call decode: same per-shard noise init
    (sharded_gl_noise_fn shares the fold_in scheme), all-interior segments,
    exact final inverse only in the last segment."""
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=7, **CFG)
    lf = LongFormMel(cfg, mesh)
    x = np.random.default_rng(8).standard_normal((2, 4000)).astype(np.float32)
    logmel = lf.encode(x)
    want = np.asarray(lf.decode(logmel, seed=3))
    for seg in (1, 3, 7, 100):
        got = np.asarray(lf.decode_resumable(logmel, seed=3,
                                             segment_iters=seg))
        np.testing.assert_array_equal(got, want), seg


def test_decode_resumable_checkpoint_roundtrip(mesh, tmp_path):
    from gomel_tpu.pipelines.longform import (load_gl_checkpoint,
                                              save_gl_checkpoint)
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=6, **CFG)
    lf = LongFormMel(cfg, mesh)
    x = np.random.default_rng(9).standard_normal((2, 4000)).astype(np.float32)
    logmel = lf.encode(x)
    want = np.asarray(lf.decode_resumable(logmel, seed=0, segment_iters=2))

    # run the first 4 iterations, persist, "crash", resume the rest
    ckpt = str(tmp_path / "gl.npz")
    seen = []

    def cb(done, carry):
        seen.append(done)
        if done == 4:
            save_gl_checkpoint(ckpt, done, carry)

    lf2 = LongFormMel(cfg, mesh)
    out = lf2.decode_resumable(logmel, seed=0, segment_iters=2, callback=cb)
    assert seen == [2, 4, 6]
    lf3 = LongFormMel(cfg, mesh)
    resumed = np.asarray(lf3.decode_resumable(
        logmel, seed=0, segment_iters=2, resume=load_gl_checkpoint(ckpt)))
    np.testing.assert_array_equal(resumed, want)
    np.testing.assert_array_equal(np.asarray(out), want)


def test_decode_resumable_momentum_runs(mesh):
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=6, **CFG)
    lf = LongFormMel(cfg, mesh)
    x = np.random.default_rng(10).standard_normal((2, 4000)).astype(np.float32)
    logmel = lf.encode(x)
    out = np.asarray(lf.decode_resumable(logmel, seed=0, momentum=0.9,
                                         segment_iters=3))
    assert np.isfinite(out).all()


def test_sharded_checkpoint_roundtrip(mesh, tmp_path):
    """Pod-capable per-shard checkpointing: save every addressable shard,
    reassemble with make_array_from_single_device_arrays, resume — equals
    the uninterrupted run bit-for-bit."""
    from gomel_tpu.pipelines.longform import (load_gl_checkpoint_sharded,
                                              save_gl_checkpoint_sharded)
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=6, **CFG)
    lf = LongFormMel(cfg, mesh)
    x = np.random.default_rng(11).standard_normal((2, 4000)).astype(np.float32)
    logmel = lf.encode(x)
    want = np.asarray(lf.decode_resumable(logmel, seed=0, segment_iters=3))

    ckpt = str(tmp_path / "glckpt")

    class Preempted(Exception):
        pass

    def cb(done, carry):
        save_gl_checkpoint_sharded(ckpt, done, carry)
        if done == 3:
            raise Preempted  # simulated preemption mid-run

    with pytest.raises(Preempted):
        LongFormMel(cfg, mesh).decode_resumable(logmel, seed=0,
                                                segment_iters=3, callback=cb)
    done, carry = load_gl_checkpoint_sharded(ckpt, mesh)
    assert done == 3
    resumed = np.asarray(LongFormMel(cfg, mesh).decode_resumable(
        logmel, seed=0, segment_iters=3, resume=(done, carry)))
    np.testing.assert_array_equal(resumed, want)


def test_decode_resumable_cache_not_stale_across_frame_counts(mesh):
    """Regression (round-3 review): F=12 and F=10 inputs can pad to the same
    n_frames_padded; the cached segment fn must not reuse the wrong
    real-frame mask (the cache key now includes plan.n_frames)."""
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=4, **CFG)
    lf = LongFormMel(cfg, mesh)
    rng = np.random.default_rng(12)
    for f in (12, 10, 14):
        logmel = rng.standard_normal((2, f, 24, 2)).astype(np.float32)
        got = np.asarray(lf.decode_resumable(logmel, seed=0,
                                             segment_iters=2))
        fresh = np.asarray(LongFormMel(cfg, mesh).decode_resumable(
            logmel, seed=0, segment_iters=2))
        np.testing.assert_array_equal(got, fresh)


def test_longform_decode_accepts_plain_lists(mesh):
    # round-2 accepted nested lists (jnp.asarray ran first); keep that
    cfg = PhaseConfig(num_freqs=16, window=32, resolut=128)
    lf = LongFormPhase(cfg, mesh)
    spec = np.random.default_rng(13).standard_normal((2, 8, 16, 2))
    out = np.asarray(lf.decode(spec.tolist()))
    want = np.asarray(lf.decode(spec.astype(np.float32)))
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_sharded_checkpoint_partial_save_is_skipped(mesh, tmp_path):
    """A preemption mid-save leaves a partial iter_ subdirectory (no
    completeness marker); load must roll back to the last complete one and
    reject mixed-iteration shards."""
    import os
    from gomel_tpu.pipelines.longform import (load_gl_checkpoint_sharded,
                                              save_gl_checkpoint_sharded)
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=4, **CFG)
    lf = LongFormMel(cfg, mesh)
    x = np.random.default_rng(14).standard_normal((2, 4000)).astype(np.float32)
    logmel = lf.encode(x)
    ckpt = str(tmp_path / "glckpt")
    lf.decode_resumable(logmel, seed=0, segment_iters=2,
                        callback=lambda d, c: save_gl_checkpoint_sharded(
                            ckpt, d, c))
    # simulate a partial save at iteration 6: shards+META but no marker
    done4 = os.path.join(ckpt, "iter_00000004")
    partial = os.path.join(ckpt, "iter_00000006")
    os.makedirs(partial)
    for name in os.listdir(done4):
        if name.startswith(("shard_", "META")):
            with open(os.path.join(done4, name), "rb") as f:
                blob = f.read()
            with open(os.path.join(partial, name), "wb") as f:
                f.write(blob)
            break  # only ONE file: definitely incomplete
    done, carry = load_gl_checkpoint_sharded(ckpt, mesh)
    assert done == 4
    # explicit done pointing at the incomplete dir fails loudly, not wrongly
    with pytest.raises((ValueError, FileNotFoundError)):
        load_gl_checkpoint_sharded(ckpt, mesh, done=6)


def test_prune_gl_checkpoints(mesh, tmp_path):
    import os
    from gomel_tpu.pipelines.longform import (load_gl_checkpoint_sharded,
                                              prune_gl_checkpoints,
                                              save_gl_checkpoint_sharded)
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=8, **CFG)
    lf = LongFormMel(cfg, mesh)
    x = np.random.default_rng(15).standard_normal((2, 4000)).astype(np.float32)
    logmel = lf.encode(x)
    ckpt = str(tmp_path / "glckpt")
    lf.decode_resumable(
        logmel, seed=0, segment_iters=2,
        callback=lambda d, c: (save_gl_checkpoint_sharded(ckpt, d, c),
                               prune_gl_checkpoints(ckpt, keep_last=2)))
    dirs = sorted(n for n in os.listdir(ckpt) if n.startswith("iter_"))
    assert dirs == ["iter_00000006", "iter_00000008"]
    done, carry = load_gl_checkpoint_sharded(ckpt, mesh)
    assert done == 8
    with pytest.raises(ValueError):
        prune_gl_checkpoints(ckpt, keep_last=0)


def test_call_longform_wrong_arity():
    from gomel_tpu import serving
    from gomel_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(data=2, frame=4)
    cfg = MelConfig(num_mels=24, **CFG)
    exp = serving.export_longform_mel_decoder(cfg, mesh, n_frames=20,
                                              batch=2, platforms=("cpu",))
    with pytest.raises(ValueError, match="takes 2 inputs"):
        serving.call_longform(exp, mesh, np.zeros((2, 3, 24, 2), np.float32))


# ---------------------------------------------------------------------------
# File-level API: hour-scale users get the same file surface
# as the single-chip pipelines — parity on the same audio.
# ---------------------------------------------------------------------------

def _file_audio(tmp_path, sr=24000, secs=0.5, seed=11, name="in.wav"):
    from gomel_tpu.io.audio import save_wav
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    a = (0.4 * np.sin(2 * np.pi * 220 * t)
         + 0.05 * rng.standard_normal(t.shape))
    p = str(tmp_path / name)
    save_wav(p, a, sr)
    return p, a


def test_longform_phase_file_parity(mesh, tmp_path):
    """to_phase_wav / to_wav_png via the sharded pipeline match the
    single-chip file path on the same audio (24 kHz exercises the
    zero-stuff upsample + samples_in_mel metadata)."""
    from gomel_tpu.io.audio import load_wav
    from gomel_tpu.io import imagecodec
    cfg = PhaseConfig(num_freqs=96, **CFG)
    wav, _ = _file_audio(tmp_path)
    lf = LongFormPhase(cfg, mesh)
    single = Phase(cfg)
    png_lf = str(tmp_path / "lf.png")
    png_s = str(tmp_path / "s.png")
    lf.to_phase_wav(wav, png_lf)
    single.to_phase_wav(wav, png_s)
    # identical metadata; pixels within one quantization step (sharded vs
    # single-chip encode differ by float noise)
    sa = imagecodec.load_phase_image(png_s, cfg.y_reverse, 0, False)
    sb = imagecodec.load_phase_image(png_lf, cfg.y_reverse, 0, False)
    assert sa[1:] == sb[1:]
    step = (sa[0].reshape(-1, 2).max(axis=0)
            - sa[0].reshape(-1, 2).min(axis=0)) / 255.0
    assert np.all(np.abs(sa[0] - sb[0]).reshape(-1, 2).max(axis=0)
                  <= step * 1.001 + 1e-12)

    out_lf = str(tmp_path / "lf.wav")
    out_s = str(tmp_path / "s.wav")
    sr_lf = lf.to_wav_png(png_s, out_lf)   # decode the SAME png both ways
    sr_s = single.to_wav_png(png_s, out_s)
    assert sr_lf == sr_s
    a, ra = load_wav(out_lf)
    b, rb = load_wav(out_s)
    assert ra == rb and a.shape == b.shape
    assert np.abs(a - b).max() < 1e-3


def test_longform_phase_file_device_quantize(mesh, tmp_path):
    """device_quantize=True long-form file paths: byte-near PNG, readable
    by the standard loader, fused sharded decode parity."""
    from gomel_tpu.io.audio import load_wav
    from gomel_tpu.io.pngcodec import read_png
    cfg = PhaseConfig(num_freqs=96, ihs=True, **CFG)
    wav, _ = _file_audio(tmp_path, seed=12)
    host = LongFormPhase(cfg, mesh)
    dev = LongFormPhase(cfg, mesh, device_quantize=True)
    png_h = str(tmp_path / "h.png")
    png_d = str(tmp_path / "d.png")
    host.to_phase_wav(wav, png_h)
    dev.to_phase_wav(wav, png_d)
    a, b = read_png(png_h), read_png(png_d)
    assert a.shape == b.shape
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    diff = np.minimum(diff, 256 - diff)  # wrapped B channel
    assert diff.max() <= 1
    out_h = str(tmp_path / "h.wav")
    out_d = str(tmp_path / "d.wav")
    host.to_wav_png(png_h, out_h)
    dev.to_wav_png(png_h, out_d)  # same png through both decoders
    x, _ = load_wav(out_h)
    y, _ = load_wav(out_d)
    assert x.shape == y.shape
    assert np.abs(x - y).max() * 32768.0 <= 2.0


def test_longform_mel_file_parity(mesh, tmp_path):
    """to_mel_wav / to_wav_png via the sharded pipeline match the
    single-chip mel file path (same GL seed => same noise init is NOT
    guaranteed across shard layouts; compare spectral content)."""
    from gomel_tpu.io.audio import load_wav
    from gomel_tpu.io import imagecodec
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=2, **CFG)
    wav, _ = _file_audio(tmp_path, sr=48000, seed=13)
    lf = LongFormMel(cfg, mesh)
    single = Mel(cfg)
    png_lf = str(tmp_path / "lf.png")
    png_s = str(tmp_path / "s.png")
    lf.to_mel_wav(wav, png_lf)
    single.to_mel_wav(wav, png_s)
    sa, samples_a, sra = imagecodec.load_mel_image(png_s, cfg.y_reverse)
    sb, samples_b, srb = imagecodec.load_mel_image(png_lf, cfg.y_reverse)
    assert (samples_a, sra) == (samples_b, srb)
    step = (sa.max() - sa.min()) / 255.0
    assert np.abs(sa - sb).max() <= step * 1.001 + 1e-12

    out_lf = str(tmp_path / "lf.wav")
    out_s = str(tmp_path / "s.wav")
    sr1 = lf.to_wav_png(png_s, out_lf, seed=0)
    sr2 = single.to_wav_png(png_s, out_s, seed=0)
    assert sr1 == sr2
    x, _ = load_wav(out_lf)
    y, _ = load_wav(out_s)
    assert x.shape == y.shape  # same trim decision
    # GL from different noise layouts: compare reconstructed mel content
    mx = np.asarray(single.encode(x))
    my = np.asarray(single.encode(y))
    rel = np.linalg.norm(np.exp(mx) - np.exp(my)) / np.linalg.norm(np.exp(mx))
    assert rel < 0.35, rel


def test_longform_mel_file_device_quantize(mesh, tmp_path):
    from gomel_tpu.io.audio import load_wav
    from gomel_tpu.io.pngcodec import read_png
    cfg = MelConfig(num_mels=24, griffin_lim_iterations=2,
                    volume_boost=1.0, **CFG)
    wav, _ = _file_audio(tmp_path, sr=48000, seed=14)
    host = LongFormMel(cfg, mesh)
    dev = LongFormMel(cfg, mesh, device_quantize=True)
    png_h = str(tmp_path / "h.png")
    png_d = str(tmp_path / "d.png")
    host.to_mel_wav(wav, png_h)
    dev.to_mel_wav(wav, png_d)
    a, b = read_png(png_h), read_png(png_d)
    assert a.shape == b.shape
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
    out_h = str(tmp_path / "h.wav")
    out_d = str(tmp_path / "d.wav")
    host.to_wav_png(png_h, out_h, seed=3)
    dev.to_wav_png(png_h, out_d, seed=3)  # same png, same seed
    x, _ = load_wav(out_h)
    y, _ = load_wav(out_d)
    assert x.shape == y.shape
    # identical plan + seed => identical GL noise; only dequantize noise
    assert np.abs(x - y).max() * 32768.0 <= 2.0


def test_longform_file_mismatched_mels_raises(mesh, tmp_path):
    from gomel_tpu.core.config import ConfigError
    cfg = MelConfig(num_mels=24, **CFG)
    wav, _ = _file_audio(tmp_path, sr=48000, seed=15)
    png = str(tmp_path / "m.png")
    LongFormMel(cfg, mesh).to_mel_wav(wav, png)
    bad = LongFormMel(MelConfig(num_mels=16, **CFG), mesh)
    with pytest.raises(ConfigError, match="mel bins"):
        bad.to_wav_png(png, str(tmp_path / "o.wav"))


def test_longform_phase_pcm_ingest_matches_float(mesh, tmp_path):
    """zp=0 raw int16 ingest (sharded device conversion) writes the
    byte-identical PNG as the float ingest of the same file."""
    cfg = PhaseConfig(num_freqs=96, **CFG)
    wav, _ = _file_audio(tmp_path, sr=48000, seed=21)
    lf = LongFormPhase(cfg, mesh, device_quantize=True)
    png_pcm = str(tmp_path / "pcm.png")
    png_flt = str(tmp_path / "flt.png")
    lf.to_phase_wav(wav, png_pcm)  # routes through _encode_file_pcm
    from gomel_tpu.io.audio import load_wav
    buf, sr = load_wav(wav, mono="left")
    lf._encode_file(buf, sr, png_flt)  # float ingest of the same audio
    assert open(png_pcm, "rb").read() == open(png_flt, "rb").read()
