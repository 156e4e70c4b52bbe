"""AOT serving artifacts (gomel_tpu/serving.py): jax.export round trips.

The serving story is framework-native added value (the reference has no AOT
path); what must hold is that a serialized artifact, reloaded from bytes in
a fresh deserialize, computes exactly what the live pipeline computes, for
any batch size when exported with a symbolic batch dimension.
"""
import conftest  # noqa: F401  (forces CPU, 8 virtual devices)

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gomel_tpu import MelConfig, PhaseConfig, serving

CFG = MelConfig(num_mels=32, resolut=256, window=64, griffin_lim_iterations=2)
PCFG = PhaseConfig(sample_rate=8000, resolut=256, window=64, num_freqs=100)


def _audio(batch, n, seed=0):
    return np.random.RandomState(seed).randn(batch, n).astype(np.float32)


def test_mel_encoder_artifact_matches_live_path(tmp_path):
    exp = serving.export_mel_encoder(CFG, seconds=0.05, sample_rate=8000,
                                     batch=None,
                                     platforms=("cpu",))
    path = str(tmp_path / "enc.jaxexp")
    serving.save_exported(exp, path)
    art = serving.load_exported(path)
    n = exp.in_avals[0].shape[1]

    from gomel_tpu.core.filterbank import mel_weights
    from gomel_tpu.ops.mel_ops import mel_encode
    from gomel_tpu.ops.stft import hann_window
    fwd = jnp.asarray(mel_weights(CFG.n_bins, CFG.num_mels, CFG.mel_fmin,
                                  CFG.mel_fmax), jnp.float32)
    win = jnp.asarray(hann_window(CFG.resolut), jnp.float32)

    # one symbolic-batch artifact serves multiple batch sizes
    for batch in (1, 3):
        x = _audio(batch, n, seed=batch)
        got = np.asarray(art.call(jnp.asarray(x)))
        for i in range(batch):
            ref = mel_encode(jnp.asarray(x[i]), CFG.num_mels, CFG.resolut,
                             CFG.window, fwd, win)
            np.testing.assert_allclose(got[i], np.asarray(ref), atol=1e-6)


def test_mel_decoder_artifact_matches_live_griffin_lim(tmp_path):
    eexp = serving.export_mel_encoder(CFG, seconds=0.05, sample_rate=8000,
                                      batch=2,
                                      platforms=("cpu",))
    n = eexp.in_avals[0].shape[1]
    logmel = eexp.call(jnp.asarray(_audio(2, n)))
    F = logmel.shape[1]

    dexp = serving.export_mel_decoder(CFG, n_frames=F, batch=None, platforms=("cpu",))
    path = str(tmp_path / "dec.jaxexp")
    serving.save_exported(dexp, path)
    art = serving.load_exported(path)

    keys = jnp.stack([jax.random.PRNGKey(7), jax.random.PRNGKey(8)])
    wav = np.asarray(art.call(logmel, keys.astype(jnp.uint32)))
    assert wav.shape == (2, CFG.resolut + (F - 1) * CFG.window)

    from gomel_tpu.core.filterbank import inverse_mel_weights
    from gomel_tpu.ops.mel_ops import mel_decode
    inv = jnp.asarray(inverse_mel_weights(CFG.n_bins, CFG.num_mels,
                                          CFG.mel_fmin, CFG.mel_fmax),
                      jnp.float32)
    ref = mel_decode(logmel[1], CFG.resolut, CFG.window, inv,
                     CFG.griffin_lim_iterations, jax.random.PRNGKey(8))
    np.testing.assert_allclose(wav[1], np.asarray(ref), atol=1e-5)


def test_phase_artifact_roundtrip_reconstructs_band_limited_audio(tmp_path):
    # num_freqs=100 keeps bins up to 100/128 of Nyquist; a 440 Hz tone at
    # sr=8000 lives well inside the retained band -> near-exact inversion
    eexp = serving.export_phase_encoder(PCFG, seconds=0.1, batch=2, platforms=("cpu",))
    n = eexp.in_avals[0].shape[1]
    t = np.arange(n) / PCFG.sample_rate
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                  0.3 * np.sin(2 * np.pi * 660 * t)]).astype(np.float32)
    spec = eexp.call(jnp.asarray(x))

    dexp = serving.export_phase_decoder(PCFG, n_frames=spec.shape[1],
                                        batch=2, platforms=("cpu",))
    for p in (str(tmp_path / "pd.jaxexp"),):
        serving.save_exported(dexp, p)
        wav = np.asarray(serving.load_exported(p).call(spec))
    m = PCFG.resolut
    for i in range(2):
        c = np.corrcoef(x[i][m:n - m], wav[i][m:n - m])[0, 1]
        assert c > 0.99, f"row {i}: corr {c}"


def test_phase_encoder_cli_preset_requires_explicit_sample_rate():
    # PhaseConfig.cli_default() leaves sample_rate=0 (Go parity); without
    # an explicit rate the input length would be degenerate — must raise.
    cfg = PhaseConfig.cli_default(resolut=256, window=64, num_freqs=100)
    with pytest.raises(ValueError, match="sample_rate must be set"):
        serving.export_phase_encoder(cfg, seconds=0.1, platforms=("cpu",))
    exp = serving.export_phase_encoder(cfg, seconds=0.1, sample_rate=8000,
                                       batch=1,
                                       platforms=("cpu",))
    assert exp.in_avals[0].shape[1] >= int(0.1 * 8000)


def test_export_cli_builds_runnable_artifact(tmp_path):
    from gomel_tpu.cli import tools
    out = str(tmp_path / "enc.jaxexp")
    rc = tools.main(["export", "mel-enc", out, "--seconds", "0.2",
                     "--sample-rate", "48000", "--preset", "lib",
                     "--platforms", "cpu", "--batch", "2"])
    assert rc == 0
    art = serving.load_exported(out)
    n = art.in_avals[0].shape[1]
    got = art.call(jnp.asarray(_audio(2, n)))
    assert got.shape[0] == 2 and got.shape[2] == MelConfig().num_mels
    assert np.all(np.isfinite(np.asarray(got)))


def test_artifact_composes_inside_larger_jit_program():
    exp = serving.export_mel_encoder(CFG, seconds=0.05, sample_rate=8000,
                                     batch=None,
                                     platforms=("cpu",))
    n = exp.in_avals[0].shape[1]
    x = jnp.asarray(_audio(2, n))
    # users embed artifacts in their own jitted programs
    f = jax.jit(lambda v: jnp.mean(exp.call(v), axis=(1, 3)))
    got = np.asarray(f(x))
    ref = np.asarray(exp.call(x)).mean(axis=(1, 3))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_load_rejects_foreign_file(tmp_path):
    p = tmp_path / "not_an_artifact.bin"
    p.write_bytes(b"PNG\x00junk")
    with pytest.raises(ValueError, match="not a gomel_tpu serving artifact"):
        serving.load_exported(str(p))


def test_pinned_batch_rejects_other_batch_size():
    exp = serving.export_mel_encoder(CFG, seconds=0.05, sample_rate=8000,
                                     batch=2,
                                     platforms=("cpu",))
    n = exp.in_avals[0].shape[1]
    with pytest.raises(Exception):
        exp.call(jnp.asarray(_audio(3, n)))


# -- sharded long-form exports ---------------------------

def _longform_mesh():
    from gomel_tpu.parallel.mesh import make_mesh
    return make_mesh(data=2, frame=4)


def test_longform_mel_encoder_export_roundtrip(tmp_path):
    from gomel_tpu.parallel import sharded as sh
    mesh = _longform_mesh()
    n_frames = 37
    exp = serving.export_longform_mel_encoder(
        CFG, mesh, n_frames=n_frames, batch=2, platforms=("cpu",))
    assert exp.nr_devices == 8
    p = str(tmp_path / "lf_enc.jaxexp")
    serving.save_exported(exp, p, meta=serving.artifact_meta(
        exp, CFG, kind="longform-mel-enc", n_frames=n_frames))
    art = serving.load_exported(p)
    plan = serving.longform_plan(CFG, mesh, n_frames)
    x = _audio(2, plan.sharded_signal_len)
    got = serving.call_longform(art, mesh, x)
    # parity vs the live sharded program
    from gomel_tpu.core.filterbank import mel_weights
    w = mel_weights(CFG.n_bins, CFG.num_mels, CFG.mel_fmin, CFG.mel_fmax)
    want = sh.sharded_mel_encode_fn(mesh, plan, CFG.num_mels, w)(
        jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    meta = serving.read_artifact_meta(p)
    assert meta["kind"] == "longform-mel-enc"
    assert meta["nr_devices"] == 8
    assert meta["config"]["num_mels"] == CFG.num_mels
    assert meta["n_frames"] == n_frames


def test_longform_mel_decoder_export_runs(tmp_path):
    mesh = _longform_mesh()
    exp = serving.export_longform_mel_decoder(
        CFG, mesh, n_frames=25, batch=2, platforms=("cpu",))
    p = str(tmp_path / "lf_dec.jaxexp")
    serving.save_exported(exp, p)
    art = serving.load_exported(p)
    plan = serving.longform_plan(CFG, mesh, 25)
    logmel = np.random.RandomState(1).randn(
        2, plan.n_frames_padded, CFG.num_mels, 2).astype(np.float32)
    key = np.asarray(jax.random.PRNGKey(0))
    out = serving.call_longform(art, mesh, logmel, key)
    o = np.asarray(out)
    assert o.shape == (2, plan.sharded_signal_len)
    assert np.isfinite(o).all()
    # deterministic per key, like the live path
    out2 = serving.call_longform(art, mesh, logmel, key)
    np.testing.assert_array_equal(o, np.asarray(out2))


def test_longform_phase_export_roundtrip_matches_live(tmp_path):
    from gomel_tpu.parallel import sharded as sh
    mesh = _longform_mesh()
    n_frames = 33
    enc = serving.export_longform_phase_encoder(
        PCFG, mesh, n_frames=n_frames, batch=2, platforms=("cpu",))
    dec = serving.export_longform_phase_decoder(
        PCFG, mesh, n_frames=n_frames, batch=2, platforms=("cpu",))
    plan = serving.longform_plan(PCFG, mesh, n_frames)
    x = _audio(2, plan.sharded_signal_len, seed=3)
    spec = serving.call_longform(enc, mesh, np.asarray(x))
    wav = serving.call_longform(dec, mesh, np.asarray(spec))
    want_spec = sh.sharded_phase_encode_fn(mesh, plan, PCFG.num_freqs)(
        jnp.asarray(x))
    want_wav = sh.sharded_phase_decode_fn(mesh, plan)(want_spec)
    np.testing.assert_allclose(np.asarray(spec), np.asarray(want_spec),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(wav), np.asarray(want_wav),
                               atol=1e-4, rtol=1e-4)


def test_longform_batch_must_match_data_axis():
    mesh = _longform_mesh()
    with pytest.raises(ValueError, match="multiple of the mesh"):
        serving.export_longform_mel_encoder(CFG, mesh, n_frames=20, batch=3,
                                            platforms=("cpu",))


def test_call_longform_rejects_wrong_mesh_size():
    from gomel_tpu.parallel.mesh import make_mesh
    mesh = _longform_mesh()
    exp = serving.export_longform_phase_encoder(PCFG, mesh, n_frames=20,
                                                batch=2, platforms=("cpu",))
    small = make_mesh(data=1, frame=4, devices=jax.devices()[:4])
    plan = serving.longform_plan(PCFG, mesh, 20)
    with pytest.raises(ValueError, match="exported for 8"):
        serving.call_longform(exp, small,
                              _audio(2, plan.sharded_signal_len))


def test_v1_artifact_still_loads(tmp_path):
    # round-2 artifacts (magic GMTPUEXP1, no JSON header) must keep loading
    exp = serving.export_mel_encoder(CFG, seconds=0.05, sample_rate=8000,
                                     batch=2,
                                     platforms=("cpu",))
    p = str(tmp_path / "v1.jaxexp")
    with open(p, "wb") as f:
        f.write(b"GMTPUEXP1\n")
        f.write(exp.serialize())
    art = serving.load_exported(p)
    n = art.in_avals[0].shape[1]
    assert np.isfinite(np.asarray(art.call(jnp.asarray(_audio(2, n))))).all()
    assert serving.read_artifact_meta(p) == {}


def test_artifact_meta_via_cli(tmp_path):
    from gomel_tpu.cli import tools
    out = str(tmp_path / "enc.jaxexp")
    rc = tools.main(["export", "mel-enc", out, "--seconds", "0.2",
                     "--sample-rate", "48000", "--preset", "lib",
                     "--platforms", "cpu", "--batch", "2"])
    assert rc == 0
    meta = serving.read_artifact_meta(out)
    assert meta["kind"] == "mel-enc"
    assert meta["config"]["num_mels"] == MelConfig().num_mels
    assert meta["seconds"] == 0.2 and meta["sample_rate"] == 48000


def test_longform_export_with_chunked_analysis(tmp_path):
    """A long-form encode (>=3072 frames per shard, where an older policy
    chunked the frames) must export and execute through jax.export."""
    from gomel_tpu.parallel import sharded as sh
    mesh = _longform_mesh()
    cfg = MelConfig(num_mels=8, resolut=64, window=16)
    n_frames = 4 * 3100
    exp = serving.export_longform_mel_encoder(
        cfg, mesh, n_frames=n_frames, batch=2, platforms=("cpu",))
    plan = serving.longform_plan(cfg, mesh, n_frames)
    assert plan.frames_per_shard >= 3072
    x = _audio(2, plan.sharded_signal_len, seed=5)
    got = serving.call_longform(serving.load_exported(
        _save_load_path(tmp_path, exp)), mesh, x)
    from gomel_tpu.core.filterbank import mel_weights
    w = mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin, cfg.mel_fmax)
    want = sh.sharded_mel_encode_fn(mesh, plan, cfg.num_mels, w)(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def _save_load_path(tmp_path, exp):
    p = str(tmp_path / "chunked.jaxexp")
    serving.save_exported(exp, p)
    return p


def test_phase_roundtrip_artifact_matches_two_stage(tmp_path):
    """The fused round-trip artifact computes exactly the encoder->decoder
    composition."""
    eexp = serving.export_phase_roundtrip(PCFG, seconds=0.1, batch=2,
                                          platforms=("cpu",))
    p = str(tmp_path / "rt.jaxexp")
    serving.save_exported(eexp, p)
    art = serving.load_exported(p)
    n = eexp.in_avals[0].shape[1]
    x = _audio(2, n, seed=5)
    got = np.asarray(art.call(jnp.asarray(x)))
    enc = serving.export_phase_encoder(PCFG, seconds=0.1, batch=2,
                                       platforms=("cpu",))
    spec = enc.call(jnp.asarray(x))
    dec = serving.export_phase_decoder(PCFG, n_frames=spec.shape[1],
                                       batch=2, platforms=("cpu",))
    want = np.asarray(dec.call(spec))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_quantized_artifacts_match_live_paths(tmp_path):
    """The quantized serving exports (r5: integer planes in/out, PCM-16
    out) compute exactly what the live device-quantize paths compute."""
    from gomel_tpu.pipelines.phase import Phase as LivePhase
    eexp = serving.export_phase_encoder_quantized(
        PCFG, seconds=0.1, batch=2, platforms=("cpu",))
    p = str(tmp_path / "encq.jaxexp")
    serving.save_exported(eexp, p)
    art = serving.load_exported(p)
    n = eexp.in_avals[0].shape[1]
    x = _audio(2, n, seed=7)
    planes, maxs, mins = art.call(jnp.asarray(x))
    assert np.asarray(planes).dtype == np.uint8
    # live single-stream path on each row (same program content, xla fft)
    live = LivePhase(PCFG, device_quantize=True)
    from gomel_tpu.ops.quantize import quantize_planes
    from gomel_tpu.ops.phase_ops import phase_encode
    from gomel_tpu.ops.stft import hann_window
    win = jnp.asarray(hann_window(PCFG.resolut), jnp.float32)
    for i in range(2):
        spec = phase_encode(jnp.asarray(x[i]), PCFG.num_freqs, PCFG.resolut,
                            PCFG.window, win)
        w_img, w_mx, w_mn = quantize_planes(spec, 255, 0)
        np.testing.assert_array_equal(np.asarray(planes)[i],
                                      np.asarray(w_img))
        np.testing.assert_allclose(np.asarray(maxs)[i], np.asarray(w_mx),
                                   rtol=1e-6)

    dexp = serving.export_phase_decoder_quantized(
        PCFG, n_frames=planes.shape[2], batch=2, platforms=("cpu",))
    p2 = str(tmp_path / "decq.jaxexp")
    serving.save_exported(dexp, p2)
    art2 = serving.load_exported(p2)
    pcm, finite = art2.call(planes, maxs.astype(jnp.float32),
                            mins.astype(jnp.float32))
    assert np.asarray(pcm).dtype == np.int16
    assert np.asarray(finite).all()
    # live fused decode on row 0
    want_pcm, want_fin = live.decode_quantized_pcm16(
        np.asarray(planes)[0], np.asarray(maxs)[0], np.asarray(mins)[0])
    np.testing.assert_array_equal(np.asarray(pcm)[0], np.asarray(want_pcm))


def test_quantized_mel_artifacts_run(tmp_path):
    eexp = serving.export_mel_encoder_quantized(
        CFG, seconds=0.05, sample_rate=8000, batch=2,
        platforms=("cpu",))
    n = eexp.in_avals[0].shape[1]
    x = _audio(2, n, seed=8)
    planes, mx, mn = eexp.call(jnp.asarray(x))
    assert np.asarray(planes).dtype == np.uint8
    dexp = serving.export_mel_decoder_quantized(
        CFG, n_frames=planes.shape[2], batch=2, platforms=("cpu",))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    pcm, finite = dexp.call(planes, mx.astype(jnp.float32),
                            mn.astype(jnp.float32),
                            keys.astype(jnp.uint32))
    assert np.asarray(pcm).dtype == np.int16
    assert np.asarray(finite).all()
    assert np.abs(np.asarray(pcm)).max() > 0


def test_default_platforms_lower_for_cuda_and_cpu(tmp_path):
    """Builders lower for CUDA and the CPU by default; the artifact runs
    here on the CPU and matches the live encode."""
    from gomel_tpu.core.filterbank import mel_weights
    from gomel_tpu.ops.mel_ops import mel_encode_batch
    from gomel_tpu.ops.stft import hann_window
    assert serving.DEFAULT_PLATFORMS == ("cuda", "cpu")
    exp = serving.export_mel_encoder(CFG, seconds=0.05, sample_rate=8000,
                                     batch=2)
    assert tuple(exp.platforms) == ("cuda", "cpu")
    p = str(tmp_path / "enc.jaxexp")
    serving.save_exported(exp, p, meta=serving.artifact_meta(exp, CFG))
    assert serving.read_artifact_meta(p)["platforms"] == ["cuda", "cpu"]
    x = _audio(2, exp.in_avals[0].shape[1], seed=9)
    fwd = jnp.asarray(mel_weights(CFG.n_bins, CFG.num_mels, CFG.mel_fmin,
                                  CFG.mel_fmax))
    win = jnp.asarray(hann_window(CFG.resolut))
    want = mel_encode_batch(jnp.asarray(x), CFG.num_mels, CFG.resolut,
                            CFG.window, fwd, win)
    np.testing.assert_allclose(
        np.asarray(serving.load_exported(p).call(jnp.asarray(x))),
        np.asarray(want), atol=1e-5, rtol=1e-5)


def test_export_cli_default_platforms(tmp_path):
    from gomel_tpu.cli import tools
    out = str(tmp_path / "rt.jaxexp")
    assert tools.main(["export", "phase-rt", out, "--seconds", "0.2",
                       "--batch", "2"]) == 0
    assert serving.read_artifact_meta(out)["platforms"] == ["cuda", "cpu"]


def test_missing_flatbuffers_falls_back_to_vendored(monkeypatch):
    import os
    import sys
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setitem(sys.modules, "flatbuffers", None)  # import fails
    serving._require_flatbuffers()
    vendor = os.path.join(os.path.dirname(serving.__file__), "_vendor")
    assert sys.path[-1] == vendor


def test_vendored_flatbuffers_round_trips_an_artifact(tmp_path):
    """jax.export (de)serialization with the vendored runtime, in a process
    where it is the flatbuffers package found first."""
    import os
    import subprocess
    import sys
    vendor = os.path.join(os.path.dirname(serving.__file__), "_vendor")
    code = f"""
import sys
sys.path.insert(0, {vendor!r})
import flatbuffers
assert "_vendor" in flatbuffers.__file__, flatbuffers.__file__
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from gomel_tpu import PhaseConfig, serving
cfg = PhaseConfig(sample_rate=8000, resolut=256, window=64, num_freqs=100)
exp = serving.export_phase_roundtrip(cfg, seconds=0.1, batch=1)
serving.save_exported(exp, {str(tmp_path / "rt.jaxexp")!r})
art = serving.load_exported({str(tmp_path / "rt.jaxexp")!r})
x = np.zeros((1, exp.in_avals[0].shape[1]), np.float32)
assert np.isfinite(np.asarray(art.call(x))).all()
print("VENDORED_OK")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=repo)
    assert "VENDORED_OK" in proc.stdout, proc.stdout + proc.stderr
