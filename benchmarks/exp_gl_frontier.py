"""The GL quality frontier -> packaged serving recommendation.

Derive "momentum-GL(k) matches plain GL(n) quality" pairs for the two
reference quality classes:

  - GL-2  (the reference CLI default, reference mel/mel.go:39)
  - GL-64 (the BASELINE long-form class)

Momentum adds one axpy per iteration, so the saving is close to the
iteration ratio. Quality = scale-invariant spectral convergence
(utils.metrics) on BOTH a tonal and a speech-like input at the flagship
config (4096/1280). Quality numbers are hardware-independent — this runs
on CPU float64 for determinism and takes no timing:

  python benchmarks/exp_gl_frontier.py

The derived pairs are shipped in ops/griffinlim.py
(GL_EQUAL_QUALITY_PAIRS / recommended_gl) and guarded by
tests/test_fgla.py::test_equal_quality_pairs_rederive.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

FRAME_LEN, HOP = 4096, 1280
SR, SECS = 48000, 10.0


def tonal(n):
    t = np.arange(n) / SR
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.25 * np.sin(2 * np.pi * 1333 * t + 0.7)
            + 0.125 * np.sin(2 * np.pi * 3777 * t + 1.3))


def speechlike(n):
    """Pitch-pulsed harmonic stack with formant-ish filtering, a syllabic
    amplitude envelope, and a noise floor — GL-relevant structure (peaked,
    non-stationary spectra) without needing audio fixtures."""
    rng = np.random.default_rng(7)
    t = np.arange(n) / SR
    f0 = 120 * (1 + 0.08 * np.sin(2 * np.pi * 2.3 * t))  # pitch wobble
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum((1.0 / k) * np.sin(k * phase) for k in range(1, 12))
    # two moving "formants" as modulated band emphasis
    x *= (1 + 0.5 * np.sin(2 * np.pi * 4.1 * t))          # syllable envelope
    x += 0.02 * rng.standard_normal(n)                    # breath noise
    return x


def main():
    from gomel_tpu.core.framing import pad_length
    from gomel_tpu.ops.griffinlim import griffin_lim
    from gomel_tpu.ops.stft import stft
    from gomel_tpu.utils.metrics import spectral_convergence

    n = pad_length(int(SR * SECS), HOP)
    key = jax.random.PRNGKey(0)
    for label, make in (("tonal", tonal), ("speech-like", speechlike)):
        x = make(n)
        mag = jnp.abs(stft(jnp.asarray(x), FRAME_LEN, HOP))

        def conv(n_iter, momentum):
            sig = griffin_lim(mag, HOP, n_iter, key, momentum=momentum)
            return float(spectral_convergence(sig, mag, FRAME_LEN, HOP))

        print(f"== {label} input ({SECS:.0f}s @{SR}, {mag.shape[0]} frames)")
        print("   plain:   ", {k: round(conv(k, 0.0), 4)
                               for k in (1, 2, 3, 4, 8, 16, 22, 64)})
        print("   mom-0.99:", {k: round(conv(k, 0.99), 4)
                               for k in (1, 2, 3, 4, 8, 16, 22, 24)},
              flush=True)


if __name__ == "__main__":
    main()
