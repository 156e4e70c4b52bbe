"""Griffin-Lim phase reconstruction — device op.

Re-design of the reference's iterative ISTFT (mel/mel.go:76-139). The
reference loops per frame with full complex FFTs; analysis of its update
(see below) lets this version run the whole spectrogram batched in rfft
space with the iteration as a ``lax.fori_loop`` whose carry (the signal)
stays in device memory.

Exact-behavior analysis of the reference loop (mel/mel.go:85-136):
- The spectrogram state enters as ``undospectrum`` output: real values, bins
  0..N/2-1 from channel 0, bins N/2..N-1 from channel 1 reversed
  (mel/impl.go:386-408).
- Each iteration sets ``spec[j] = |spec[j]| * e^{i*phase(FFT(w*frame)[j])}`` and
  then FORCES conjugate symmetry for j in [1, N/2) (mel/mel.go:105-108). The
  upper-half magnitudes are therefore overwritten by mirrored lower-half ones
  before they are ever used by the IFFT — with one exception: bin N/2 (never
  touched by the symmetry loop) keeps channel 1's last-bin magnitude.
- Magnitudes are consequently CONSTANT across iterations: |spec| after the
  update equals |spec| before it.

So the exact equivalent is: fixed half-magnitudes
    mag[k] = |ch0[k]| for k in [0, N/2),  mag[N/2] = |ch1[N/2-1]|
and per iteration
    phase <- angle(rfft(window * frames(signal)))
    signal <- overlap_add(irfft(mag * e^{i*phase}) * window)
with NO window-sum normalization (commented out in the reference,
mel/mel.go:113,127-132) and uniform-[0,1) random initialization
(mel/mel.go:81-83; the reference uses unseeded math/rand — we take an explicit
PRNG key, so parity is tolerance-based per SURVEY.md §5.4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .fftbackend import irfft_planes, rfft_planes
from .istft import overlap_add
from .stft import frame_signal, hann_window


# Equal-quality serving pairs (benchmarks/exp_gl_frontier.py on tonal +
# speech-like input at the flagship 4096/1280 config; a quality derivation,
# independent of the device):
# plain-GL(n) quality class -> (momentum, iterations) matching or beating it
# in the fewest iterations. Momentum adds one axpy per iteration, so the
# saving is close to the iteration ratio.
GL_EQUAL_QUALITY_PAIRS: dict[int, tuple[float, int]] = {
    # reference CLI default (GriffinLimIterations=2, mel/mel.go:39):
    # momentum needs >= 2 iterations of history to engage, so no iteration
    # reduction exists; momentum-2 measures par-to-slightly-better at equal
    # cost (0.3847 vs 0.3867 tonal / 0.3629 vs 0.3641 speech-like)
    2: (0.99, 2),
    # mid class: momentum-8 beats plain-16 (0.1892 vs 0.1959 tonal,
    # 0.1851 vs 0.1990 speech-like) -> 2x fewer iterations
    16: (0.99, 8),
    # r5 anchor for the previously-extrapolated mid range: momentum-16
    # beats plain-32 (0.1202 vs 0.1470 tonal, 0.1127 vs 0.1355
    # speech-like; momentum-14 also clears both, momentum-12 loses
    # speech-like) -> the n/2 rule is validated with margin at 32
    32: (0.99, 16),
    # BASELINE long-form class: momentum-24 beats plain-64 (0.0896 vs
    # 0.1010 tonal, 0.0778 vs 0.0906 speech-like; 0.1238 vs 0.1340 on a
    # 5-minute long-form signal) -> 2.7x fewer iterations
    64: (0.99, 24),
}


def recommended_gl(plain_iters: int) -> tuple[float, int]:
    """(momentum, iterations) matching plain-GL(``plain_iters``) quality at
    the fewest iterations — the packaged serving recommendation.

    Evidence-bound interpolation of :data:`GL_EQUAL_QUALITY_PAIRS`:
    below 16 iterations the measured reductions do not hold (momentum at
    half the iterations loses to plain at n<=8), so the recommendation is
    momentum at EQUAL iterations (quality par-to-better, same cost); from
    16 it is n/2, and from 64 the measured 3n/8. Guarded by
    tests/test_fgla.py::test_equal_quality_pairs_rederive.
    """
    if plain_iters < 1:
        raise ValueError("plain_iters must be >= 1")
    if plain_iters < 2:
        return (0.0, plain_iters)        # no history to extrapolate from
    if plain_iters < 16:
        return (0.99, plain_iters)       # quality upgrade at equal cost
    if plain_iters < 64:
        return (0.99, -(-plain_iters // 2))
    return (0.99, -(-plain_iters * 3 // 8))


def griffin_lim_magnitudes(linear2: jax.Array) -> jax.Array:
    """Half-spectrum magnitudes [F, N/2+1] from a 2-channel linear spectrogram
    [F, N/2, 2] (the ``undospectrum`` layout, mel/impl.go:386-408)."""
    mag_low = jnp.abs(linear2[..., 0])          # bins 0..N/2-1
    mag_nyq = jnp.abs(linear2[:, -1:, 1])       # bin N/2 = |ch1[N/2-1]|
    return jnp.concatenate([mag_low, mag_nyq], axis=1)


def griffin_lim(mag_half: jax.Array, hop: int, n_iter: int, key: jax.Array,
                window=None,
                init: jax.Array | None = None,
                momentum: float = 0.0) -> jax.Array:
    """Iterative phase reconstruction.

    mag_half: [F, N/2+1] fixed half-spectrum magnitudes.
    Returns signal [N + (F-1)*hop]. With n_iter=0 returns the random init,
    matching the reference (mel/mel.go:85 loop never runs).
    ``init`` overrides the random initial signal (used by equivalence tests).
    ``window``: None (Hann) or an explicit analysis/synthesis window.

    Every iteration runs an exact f32 rFFT/irFFT pair: on the H100 cuFFT
    beats a direct-DFT matmul at TF32 and at bf16 (PERF.md).

    ``momentum``: 0.0 (default) is the reference's plain Griffin-Lim,
    exactly. A value in (0, 1] enables the fast-Griffin-Lim acceleration
    (Perraudin, Balazs & Sondergaard, WASPAA 2013), applied in the signal
    domain: with G the plain update (one body() pass below),
        t_n = G(c_n),   c_{n+1} = t_n + momentum * (t_n - t_{n-1}).
    Since the iteration's carry here IS the signal and the synthesis map is
    linear, this equals the classical spectrogram-domain FGLA extrapolation
    pushed through synthesis. Cost: one extra signal-length buffer and one
    fused axpy per iteration, while convergence per iteration improves
    ~2-4x at 8+ iterations (benchmarks/exp_gl_frontier.py). Beyond
    reference parity; opt-in, off everywhere by default.
    """
    F = mag_half.shape[0]
    N = (mag_half.shape[1] - 1) * 2
    dtype = mag_half.dtype
    if window is None:
        window = hann_window(N)
    window = jnp.asarray(window, dtype=dtype)
    out_len = N + (F - 1) * hop
    if init is not None:
        sig0 = jnp.asarray(init, dtype=dtype)
    else:
        sig0 = jax.random.uniform(key, (out_len,), dtype=dtype)
    m = mag_half.astype(dtype)

    def body(sig):
        re, im = rfft_planes(frame_signal(sig, N, hop) * window)
        # unit phase; angle(0) = 0 -> unit 1 (matches cmplx.Rect(mag, Phase(0)))
        a = jnp.sqrt(re * re + im * im)
        inv = jnp.where(a > 0, 1.0 / jnp.where(a > 0, a, 1.0), 0.0)
        unit_re = jnp.where(a > 0, re * inv, 1.0)
        unit_im = im * inv
        rec = irfft_planes(m * unit_re, m * unit_im, N)
        return overlap_add(rec.astype(dtype) * window, hop)

    mom = float(momentum)
    if mom != 0.0:
        def accel(_, carry):
            c, t_prev = carry
            t = body(c)
            return t + mom * (t - t_prev), t

        sig, _ = jax.lax.fori_loop(0, max(n_iter - 1, 0), accel,
                                   (sig0, sig0), unroll=False)
    else:
        sig = jax.lax.fori_loop(0, max(n_iter - 1, 0),
                                lambda _, s: body(s), sig0, unroll=False)
    if n_iter >= 1:  # final iteration (n_iter is static)
        sig = body(sig)
    return sig
