"""Frame-sharded (multi-chip) pipeline parity vs the single-chip ops.

Runs on the 8-virtual-device CPU mesh (conftest). The sharded results must
match the unsharded kernels bit-tolerantly; Griffin-Lim is seeded identically
via an explicit init signal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gomel_tpu.core.framing import num_frames
from gomel_tpu.ops.stft import stft, hann_window
from gomel_tpu.ops.istft import istft_direct
from gomel_tpu.ops.griffinlim import griffin_lim
from gomel_tpu.ops.phase_ops import phase_encode, phase_decode
from gomel_tpu.ops.mel_ops import mel_encode
from gomel_tpu.core.filterbank import mel_weights
from gomel_tpu.parallel.mesh import make_mesh
from gomel_tpu.parallel import sharded as sh

FRAME_LEN, HOP = 256, 64  # same ratio class as 4096/1280 (non-divisible: 512/160)


def _sig(L, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, L)).astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=2, frame=4)


def _plan_for(L, n_shards=4):
    f = num_frames(L, FRAME_LEN, HOP)
    return sh.plan_frame_sharding(f, FRAME_LEN, HOP, n_shards)


def test_plan_geometry():
    plan = _plan_for(FRAME_LEN + 37 * HOP)
    assert plan.n_frames_padded % plan.n_shards == 0
    assert plan.n_frames_padded >= plan.n_frames + (-(-FRAME_LEN // HOP)) - 1
    assert plan.chunk >= plan.halo  # halo stays within one neighbor


def test_sharded_stft_matches_unsharded(mesh):
    L = FRAME_LEN + 41 * HOP
    x = _sig(L)
    plan = _plan_for(L)
    xp = sh.pad_signal_for_plan(jnp.asarray(x), plan)
    re, im = sh.sharded_stft_fn(mesh, plan)(xp)
    got = np.asarray(re)[:, : plan.n_frames] + 1j * np.asarray(im)[:, : plan.n_frames]
    want = np.asarray(jax.vmap(lambda s: stft(jnp.asarray(s), FRAME_LEN, HOP))(
        jnp.asarray(x)))
    np.testing.assert_allclose(np.abs(got - want), 0, atol=1e-4)


def test_sharded_istft_matches_unsharded(mesh):
    L = FRAME_LEN + 41 * HOP
    x = _sig(L)
    plan = _plan_for(L)
    win = jnp.asarray(hann_window(FRAME_LEN), dtype=jnp.float32)
    spec = jax.vmap(lambda s: stft(s, FRAME_LEN, HOP))(jnp.asarray(x))
    want = jax.vmap(lambda s: istft_direct(s, HOP, win))(spec)
    spec_p = sh.pad_frames_for_plan(spec, plan)
    got = sh.sharded_istft_fn(mesh, plan)(spec_p)[:, : plan.out_len]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_sharded_phase_roundtrip_matches_unsharded(mesh):
    L = FRAME_LEN + 41 * HOP
    NUM_FREQS = 96
    x = _sig(L)
    plan = _plan_for(L)
    xp = sh.pad_signal_for_plan(jnp.asarray(x), plan)
    enc = sh.sharded_phase_encode_fn(mesh, plan, NUM_FREQS)(xp)
    want_enc = jax.vmap(
        lambda s: phase_encode(s, NUM_FREQS, FRAME_LEN, HOP))(jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(enc[:, : plan.n_frames]), np.asarray(want_enc), atol=1e-4)

    dec = sh.sharded_phase_decode_fn(mesh, plan)(enc)[:, : plan.out_len]
    want_dec = jax.vmap(
        lambda s: phase_decode(s, FRAME_LEN, HOP))(want_enc)
    np.testing.assert_allclose(np.asarray(dec), np.asarray(want_dec),
                               atol=1e-3, rtol=1e-3)


def test_sharded_mel_encode_matches_unsharded(mesh):
    L = FRAME_LEN + 41 * HOP
    NUM_MELS = 32
    x = _sig(L)
    plan = _plan_for(L)
    w = mel_weights(FRAME_LEN // 2, NUM_MELS, 0.0, 8000.0)
    xp = sh.pad_signal_for_plan(jnp.asarray(x), plan)
    got = sh.sharded_mel_encode_fn(mesh, plan, NUM_MELS, w)(xp)
    want = jax.vmap(lambda s: mel_encode(
        s, NUM_MELS, FRAME_LEN, HOP, jnp.asarray(w, jnp.float32)))(
        jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got[:, : plan.n_frames]),
                               np.asarray(want), atol=1e-4, rtol=1e-4)


def test_sharded_griffin_lim_matches_unsharded(mesh):
    L = FRAME_LEN + 41 * HOP
    x = _sig(L, b=2)
    plan = _plan_for(L)
    spec = jax.vmap(lambda s: stft(s, FRAME_LEN, HOP))(jnp.asarray(x))
    mag = jnp.abs(spec)
    # identical deterministic init on both paths
    init = jnp.asarray(
        np.random.default_rng(7).random((2, plan.sharded_signal_len)),
        dtype=jnp.float32)
    win = jnp.asarray(hann_window(FRAME_LEN), dtype=jnp.float32)
    want = jax.vmap(lambda m, s0: griffin_lim(
        m, HOP, 3, jax.random.PRNGKey(0), win, init=s0[: plan.out_len]))(
        mag, init)
    mag_p = sh.pad_frames_for_plan(mag, plan)
    gl = sh.sharded_griffin_lim_fn(mesh, plan, 3)
    got = gl(mag_p, init)[:, : plan.out_len]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-3, rtol=2e-3)


def test_sharded_griffin_lim_momentum_matches_unsharded(mesh):
    """Fast-GL (momentum) parity: the extrapolation is pointwise on the
    shard-local carry, so the sharded loop must track the unsharded one
    exactly like the plain-GL case."""
    L = FRAME_LEN + 41 * HOP
    x = _sig(L, b=2)
    plan = _plan_for(L)
    spec = jax.vmap(lambda s: stft(s, FRAME_LEN, HOP))(jnp.asarray(x))
    mag = jnp.abs(spec)
    init = jnp.asarray(
        np.random.default_rng(7).random((2, plan.sharded_signal_len)),
        dtype=jnp.float32)
    win = jnp.asarray(hann_window(FRAME_LEN), dtype=jnp.float32)
    want = jax.vmap(lambda m, s0: griffin_lim(
        m, HOP, 6, jax.random.PRNGKey(0), win, init=s0[: plan.out_len],
        momentum=0.99))(mag, init)
    gl = sh.sharded_griffin_lim_fn(mesh, plan, 6, momentum=0.99)
    got = gl(sh.pad_frames_for_plan(mag, plan), init)[:, : plan.out_len]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-3, rtol=2e-3)


def test_sharded_griffin_lim_nondivisible_frame_hop(mesh):
    # frame_len not a multiple of hop (like the flagship 4096/1280)
    fl, hop = 160, 48
    L = fl + 37 * hop
    x = _sig(L, b=2, seed=3)
    f = num_frames(L, fl, hop)
    plan = sh.plan_frame_sharding(f, fl, hop, 4)
    spec = jax.vmap(lambda s: stft(s, fl, hop))(jnp.asarray(x))
    want = jax.vmap(lambda s: istft_direct(s, hop,
                    jnp.asarray(hann_window(fl), jnp.float32)))(spec)
    got = sh.sharded_istft_fn(mesh, plan)(
        sh.pad_frames_for_plan(spec, plan))[:, : plan.out_len]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_sharded_griffin_lim_64_iterations(mesh):
    """The BASELINE 'long-form, 64-iteration Griffin-Lim, frame-sharded'
    config: state stays shard-resident across the fori_loop; result is
    finite and consistent with the unsharded kernel."""
    L = FRAME_LEN + 37 * HOP
    x = _sig(L, b=2, seed=9)
    plan = _plan_for(L)
    spec = jax.vmap(lambda s: stft(s, FRAME_LEN, HOP))(jnp.asarray(x))
    mag = jnp.abs(spec)
    init = jnp.asarray(
        np.random.default_rng(11).random((2, plan.sharded_signal_len)),
        dtype=jnp.float32)
    win = jnp.asarray(hann_window(FRAME_LEN), dtype=jnp.float32)
    want = jax.vmap(lambda m, s0: griffin_lim(
        m, HOP, 64, jax.random.PRNGKey(0), win, init=s0[: plan.out_len]))(
        mag, init)
    got = sh.sharded_griffin_lim_fn(mesh, plan, 64)(
        sh.pad_frames_for_plan(mag, plan), init)[:, : plan.out_len]
    g = np.asarray(got)
    assert np.isfinite(g).all()
    # 64 low-precision iterations accumulate small drift vs the unsharded
    # (also low-precision, but differently-ordered) loop
    denom = np.abs(np.asarray(want)).max()
    assert np.abs(g - np.asarray(want)).max() / denom < 0.02


def test_sharded_encode_auto_chunk_kicks_in_at_scale(mesh):
    """At >=3072 frames per shard (where an older policy chunked the
    frames) the sharded encode must match the unsharded kernel."""
    from gomel_tpu.ops.mel_ops import mel_encode
    fl, hop = 64, 16
    f = 4 * 3100  # 3100 frames/shard on the 4-shard frame axis
    plan = sh.plan_frame_sharding(f, fl, hop, 4)
    assert plan.frames_per_shard >= 3072
    x = _sig(plan.out_len, b=2, seed=21)
    xp = sh.pad_signal_for_plan(jnp.asarray(x), plan)
    w = mel_weights(fl // 2, 8, 0.0, 4000.0)
    got = np.asarray(sh.sharded_mel_encode_fn(mesh, plan, 8, w)(xp))
    for b in range(2):
        want = np.asarray(mel_encode(jnp.asarray(x[b]), 8, fl, hop,
                                     jnp.asarray(w)))
        np.testing.assert_allclose(got[b, :f], want, atol=1e-5, rtol=1e-5)
