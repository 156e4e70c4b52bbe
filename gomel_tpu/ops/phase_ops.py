"""Phase-preserving spectrogram codec — device ops.

Re-design of the reference phase codec:
- encode: /root/reference/phase/phase.go:41-70 (port: phase.py:113-142)
- decode: /root/reference/phase/phase.go:72-153 (port: phase.py:144-220)
- shrink/grow: /root/reference/phase/impl.go:383-403 (port: phase.py:438-472)

Key equivalence used throughout (derivation in docstrings below): for a real
input frame, the reference's stored channel pair per bin j is
``[imag(S[j+1]), real(S[j+1])]`` where S is the full FFT — i.e. exactly the
rfft bins 1..N/2. Both encode and decode therefore run entirely in rfft space:
half the FFT work and half the memory traffic of a literal translation.

Spectrogram layout here is [frames, num_freqs, 2] (channel-last); the
reference's flattened [frames*num_freqs, 2] layout is a reshape away.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .stft import frame_signal, hann_window
from .fftbackend import rfft_planes
from .istft import istft_direct_planes


def phase_encode(x_padded: jax.Array, num_freqs: int, frame_len: int, hop: int,
                 window: jax.Array | None = None) -> jax.Array:
    """Audio -> phase spectrogram [F, num_freqs, 2].

    Reference (phase/phase.go:50-64): per bin j in [0, N/2):
        v0 = S[j+1]; v1 = S[N-j-1] = conj(S[j+1])
        ch0 = imag(v0) = imag(S[j+1]); ch1 = real(v1) = real(S[j+1])
    then ``shrink`` keeps the first num_freqs bins (phase/impl.go:383-391).
    So the channels are just (imag, real) of rfft bins 1..num_freqs.
    """
    if window is None:
        window = jnp.asarray(hann_window(frame_len), dtype=x_padded.dtype)
    frames = frame_signal(x_padded, frame_len, hop)
    re, im = rfft_planes(frames * window)
    return jnp.stack([im[:, 1:num_freqs + 1], re[:, 1:num_freqs + 1]],
                     axis=-1)


def phase_encode_batch(xb: jax.Array, num_freqs: int, frame_len: int,
                       hop: int, window: jax.Array | None = None
                       ) -> jax.Array:
    """Batched audio [B, L] -> phase spectrogram [B, F, num_freqs, 2].

    Batch-explicit form of ``jax.vmap(phase_encode)`` — identical numerics.
    The hot call sites keep ``jax.vmap(phase_encode)``; this exists for API
    symmetry with ops/mel_ops.mel_encode_batch.
    """
    if window is None:
        window = jnp.asarray(hann_window(frame_len), dtype=xb.dtype)
    frames = jax.vmap(lambda s: frame_signal(s, frame_len, hop))(xb)
    re, im = rfft_planes(frames * window)
    return jnp.stack([im[..., 1:num_freqs + 1], re[..., 1:num_freqs + 1]],
                     axis=-1)


def grow_half_spectrum(spec2: jax.Array, n_bins: int) -> jax.Array:
    """``grow`` + complex reconstruction, fused, in rfft layout.

    grow (phase/impl.go:392-403): replicate the last kept bin to refill bins
    num_freqs..N/2-1.

    undospectrum (phase/phase.go:72-91) writes, for each j in [0, N/2):
        S[j+1]   = realm0 + i*realn1
        S[N-j-1] = realm0 - i*realn1
    Bin N/2 is written twice in the same j = N/2-1 iteration; the v1 write wins,
    leaving S[N/2] = realm0 - i*realn1. Bin 0 is never written (stays 0).
    The reference then takes real(IFFT(S)); since real(IFFT(x)) equals the
    inverse rfft of the Hermitian part of x, the equivalent rfft half-spectrum is
        H[0] = 0;  H[k] = realm0[k-1] + i*realn1[k-1] (k = 1..N/2-1);
        H[N/2] = realm0[N/2-1]   (Nyquist imaginary part cancels).

    spec2: [F, num_freqs, 2] with channels (realn1=imag, realm0=real).
    Returns complex [F, N//2+1].
    """
    F, num_freqs, _ = spec2.shape
    half = n_bins  # N/2
    # grow: replicate last bin
    pad_cnt = half - num_freqs
    if pad_cnt > 0:
        last = spec2[:, -1:, :]
        spec2 = jnp.concatenate(
            [spec2, jnp.broadcast_to(last, (F, pad_cnt, 2))], axis=1)
    realn1 = spec2[..., 0]
    realm0 = spec2[..., 1]
    cplx = jax.lax.complex(realm0, realn1)  # bins 1..N/2
    # zero the Nyquist imaginary part (conjugate write-order; see docstring)
    nyq = jax.lax.complex(realm0[:, -1], jnp.zeros_like(realm0[:, -1]))
    dc = jnp.zeros((F, 1), dtype=cplx.dtype)
    return jnp.concatenate([dc, cplx[:, :-1], nyq[:, None]], axis=1)


def grow_half_planes(spec2: jax.Array, n_bins: int
                     ) -> tuple[jax.Array, jax.Array]:
    """``grow_half_spectrum`` in separate real/imag planes (no complex array):
    re = [0, realm0[0..N/2-1]],  im = [0, realn1[0..N/2-2], 0]."""
    F, num_freqs, _ = spec2.shape
    pad_cnt = n_bins - num_freqs
    if pad_cnt > 0:
        last = spec2[:, -1:, :]
        spec2 = jnp.concatenate(
            [spec2, jnp.broadcast_to(last, (F, pad_cnt, 2))], axis=1)
    realn1 = spec2[..., 0]
    realm0 = spec2[..., 1]
    zero = jnp.zeros((F, 1), dtype=spec2.dtype)
    re = jnp.concatenate([zero, realm0], axis=1)
    im = jnp.concatenate([zero, realn1[:, :-1], zero], axis=1)
    return re, im


def phase_decode(spec2: jax.Array, frame_len: int, hop: int,
                 volume_boost: float = 0.0,
                 window: jax.Array | None = None) -> jax.Array:
    """Phase spectrogram [F, num_freqs, 2] -> audio [N + (F-1)*hop].

    grow -> half-spectrum planes -> direct iSTFT with window-sum normalization
    -> optional volume boost (reference: phase/phase.go:136-153; boost applied
    when != 0, phase/phase.go:146 — note the port uses > 0, phase.py:216).
    """
    if window is None:
        window = hann_window(frame_len)  # host-side np, a compile-time constant
    re, im = grow_half_planes(spec2, frame_len // 2)
    sig = istft_direct_planes(re, im, hop, window)
    if volume_boost != 0.0:
        sig = sig * jnp.asarray(volume_boost, dtype=sig.dtype)
    return sig


def shrink(spec2_full: jax.Array, num_freqs: int) -> jax.Array:
    """Keep the first num_freqs bins: [F, N/2, 2] -> [F, num_freqs, 2]
    (reference: phase/impl.go:383-391)."""
    return spec2_full[:, :num_freqs, :]
