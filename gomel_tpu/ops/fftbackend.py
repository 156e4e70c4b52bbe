"""Real FFTs in separate real/imag planes.

Thin wrappers over ``jnp.fft`` (cuFFT on the GPU, exact f32): every codec
kernel passes spectra as (re, im) plane pairs, so complex arrays exist only
inside these functions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def rfft_planes(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Real [..., n] -> (re, im) half-spectrum planes [..., n//2+1]."""
    spec = jnp.fft.rfft(x, axis=-1)
    return jnp.real(spec), jnp.imag(spec)


def rfft_mag(x: jax.Array) -> jax.Array:
    """Real [..., n] -> |rfft| [..., n//2+1]."""
    return jnp.abs(jnp.fft.rfft(x, axis=-1))


def irfft_planes(re: jax.Array, im: jax.Array, n: int) -> jax.Array:
    """(re, im) half-spectrum [..., n//2+1] -> real [..., n]."""
    return jnp.fft.irfft(jax.lax.complex(re, im), n=n, axis=-1)
