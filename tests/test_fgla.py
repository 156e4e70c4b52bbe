"""Fast Griffin-Lim (momentum) — opt-in acceleration (ops/griffinlim.py).

momentum=0.0 must stay exactly the reference's plain Griffin-Lim (covered by
the Go-loop equivalence test in test_mel.py, which exercises the default
path); these tests pin the accelerated path: (1) the fori_loop carry wiring
against a hand-rolled FGLA recursion built from single plain-GL steps, and
(2) that momentum actually buys convergence per iteration.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gomel_tpu.ops.griffinlim import griffin_lim
from gomel_tpu.ops.stft import stft
from gomel_tpu.utils.metrics import spectral_convergence

FRAME_LEN, HOP = 256, 64


def _consistent_mag(n_frames: int, seed: int = 3):
    """Half-spectrum magnitudes of a real tonal signal (a consistent
    spectrogram, so Griffin-Lim has a true fixed point to converge to)."""
    sr = 8000
    n = FRAME_LEN + (n_frames - 1) * HOP
    t = np.arange(n) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.25 * np.sin(2 * np.pi * 1333 * t + 0.7))
    spec = stft(jnp.asarray(x), FRAME_LEN, HOP)  # complex [F, N/2+1]
    return jnp.abs(spec), x


def _residual(mag, sig):
    """Scale-invariant spectral convergence (see utils.metrics docstring for
    why scale invariance is required against the un-normalized GL)."""
    return spectral_convergence(sig, mag, FRAME_LEN, HOP)


def test_momentum_loop_matches_handrolled_fgla():
    """The fori_loop carry implements  t_n = G(c_n);
    c_{n+1} = t_n + m (t_n - t_{n-1})  with G = one plain-GL pass
    (``griffin_lim(n_iter=1)`` runs exactly one body() on its init)."""
    mag, _ = _consistent_mag(24)
    key = jax.random.PRNGKey(0)
    init = jax.random.uniform(
        key, (FRAME_LEN + (mag.shape[0] - 1) * HOP,), jnp.float64)
    mom, n_iter = 0.9, 5

    def G(s):
        return griffin_lim(mag, HOP, 1, key, init=s)

    c = t_prev = init
    for _ in range(n_iter - 1):
        t = G(c)
        c, t_prev = t + mom * (t - t_prev), t
    want = G(c)

    got = griffin_lim(mag, HOP, n_iter, key, init=init, momentum=mom)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-9, rtol=1e-9)


def test_momentum_zero_is_plain_gl():
    mag, _ = _consistent_mag(24)
    key = jax.random.PRNGKey(1)
    init = jax.random.uniform(
        key, (FRAME_LEN + (mag.shape[0] - 1) * HOP,), jnp.float64)
    plain = griffin_lim(mag, HOP, 6, key, init=init)
    mom0 = griffin_lim(mag, HOP, 6, key, init=init, momentum=0.0)
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(mom0))


@pytest.mark.parametrize("n_iter", [8, 16])
def test_momentum_converges_faster(n_iter):
    """At equal iteration count the accelerated update must land materially
    closer to the target magnitudes than plain GL (that is its whole point);
    require >= 20% lower residual at 8/16 iterations on tonal input."""
    mag, _ = _consistent_mag(40)
    key = jax.random.PRNGKey(2)
    init = jax.random.uniform(
        key, (FRAME_LEN + (mag.shape[0] - 1) * HOP,), jnp.float64)
    r_plain = _residual(mag, griffin_lim(mag, HOP, n_iter, key, init=init))
    r_fast = _residual(mag, griffin_lim(mag, HOP, n_iter, key, init=init,
                                        momentum=0.99))
    assert r_fast < 0.8 * r_plain, (r_plain, r_fast)


def test_equal_quality_pairs_rederive():
    """Guard for the PACKAGED serving recommendation:
    re-derive the measured equal-quality pairs cheaply — momentum-24 must
    match-or-beat plain-64 and momentum-8 must match-or-beat plain-16 on
    tonal input (benchmarks/exp_gl_frontier.py derivation; shipped as
    ops.griffinlim.GL_EQUAL_QUALITY_PAIRS / recommended_gl and cited by
    towav --help and the serving export docstrings). Deterministic: fixed
    key, fixed input, CPU float64."""
    from gomel_tpu.ops.griffinlim import (GL_EQUAL_QUALITY_PAIRS,
                                          recommended_gl)

    mag, _ = _consistent_mag(60)
    key = jax.random.PRNGKey(0)

    def conv(n_iter, momentum):
        return _residual(mag, griffin_lim(mag, HOP, n_iter, key,
                                          momentum=momentum))

    for plain_n in (16, 32, 64):
        mom, k = GL_EQUAL_QUALITY_PAIRS[plain_n]
        assert recommended_gl(plain_n) == (mom, k)
        assert conv(k, mom) <= conv(plain_n, 0.0), (plain_n, mom, k)
    # the GL-2 class has no reduction: momentum needs >= 2 iterations of
    # history, and at equal cost momentum-2 must not be worse
    assert recommended_gl(2) == GL_EQUAL_QUALITY_PAIRS[2] == (0.99, 2)
    assert conv(2, 0.99) <= conv(2, 0.0) * 1.001
    assert recommended_gl(1) == (0.0, 1)


def test_momentum_through_mel_pipeline():
    """Mel.decode(momentum=...) runs and returns the right shape; the
    momentum kwarg reaches the GL loop (different output from plain)."""
    from gomel_tpu.pipelines.mel import Mel

    m = Mel(num_mels=32, resolut=FRAME_LEN, window=HOP,
            sample_rate=8000, mel_fmax=4000.0, griffin_lim_iterations=4)
    sr = 8000
    t = np.arange(2 * sr) / sr
    x = 0.4 * np.sin(2 * np.pi * 440 * t)
    logmel = m.encode(x)
    plain = np.asarray(m.decode(logmel, seed=0))
    fast = np.asarray(m.decode(logmel, seed=0, momentum=0.99))
    assert plain.shape == fast.shape
    assert not np.array_equal(plain, fast)
