"""Golden parity tests: our phase codec vs the reference Python port
(/root/reference/phase.py), run in float64 on CPU."""
import conftest

import numpy as np
import jax.numpy as jnp
import pytest

from gomel_tpu import Phase

ref = conftest.load_reference_phase()
pytestmark = pytest.mark.skipif(ref is None, reason="reference port unavailable")


def make_audio(n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 48000.0
    return (0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * np.sin(2 * np.pi * 2333 * t)
            + 0.05 * rng.randn(n))


@pytest.mark.parametrize("n,sr", [(30000, 48000), (19199, 48000),
                                  (100_000, 44100), (5000, 16000)])
def test_to_phase_matches_reference(n, sr):
    audio = make_audio(n)
    rp = ref.Phase(sample_rate=sr)
    expect = rp.to_phase(audio.copy())
    p = Phase(sample_rate=sr, dtype=jnp.float64)
    got = p.to_phase(audio)
    assert got.shape == expect.shape
    scale = max(np.max(np.abs(expect)), 1.0)
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-10 * scale)


@pytest.mark.parametrize("n,sr", [(30000, 48000), (64000, 44100)])
def test_from_phase_matches_reference(n, sr):
    audio = make_audio(n, seed=1)
    rp = ref.Phase(sample_rate=sr)
    spec = rp.to_phase(audio.copy())
    expect = rp.from_phase(spec.copy())
    p = Phase(sample_rate=sr, dtype=jnp.float64)
    got = p.from_phase(spec)
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-12)


def test_roundtrip_reconstructs_signal():
    """Property 1 (design.md:165-169): round trip preserves the signal in the
    interior (away from window-edge fades).

    The codec keeps only rfft bins 1..num_freqs (shrink, phase/impl.go:383-391)
    so exact round-trip holds for signals band-limited below
    num_freqs/resolut * sr = 9 kHz at 48 kHz — the reference's zero-stuffing
    upsampler exists precisely to put low-rate content in that band.
    """
    t = np.arange(48000) / 48000.0
    audio = (0.4 * np.sin(2 * np.pi * 440 * t)
             + 0.2 * np.sin(2 * np.pi * 2333 * t)
             + 0.1 * np.sin(2 * np.pi * 7000 * t))
    p = Phase(sample_rate=48000, dtype=jnp.float64)
    rec = p.from_phase(p.to_phase(audio))
    n = min(len(audio), len(rec))
    # skip edge fade region (one frame length on both sides)
    sl = slice(4096, n - 4096)
    err = np.max(np.abs(rec[sl] - audio[sl]))
    assert err < 1e-5, f"round-trip error too large: {err}"


def test_volume_boost_scales_output():
    """Property 5 (design.md:189-193)."""
    audio = make_audio(30000)
    p1 = Phase(sample_rate=48000, dtype=jnp.float64)
    spec = p1.to_phase(audio)
    base = p1.from_phase(spec)
    p2 = Phase(sample_rate=48000, dtype=jnp.float64, volume_boost=2.0)
    boosted = p2.from_phase(spec)
    np.testing.assert_allclose(boosted, base * 2.0, rtol=1e-12, atol=1e-15)


def test_float32_close_to_float64():
    """The device dtype (f32) stays within quantization-irrelevant error of the
    f64 reference (SURVEY.md §7 hard parts)."""
    audio = make_audio(30000)
    p64 = Phase(sample_rate=48000, dtype=jnp.float64)
    p32 = Phase(sample_rate=48000, dtype=jnp.float32)
    s64 = p64.to_phase(audio)
    s32 = p32.to_phase(audio)
    scale = np.max(np.abs(s64))
    assert np.max(np.abs(s64 - s32)) < 1e-4 * scale
    w64 = p64.from_phase(s64)
    w32 = p32.from_phase(s64)
    assert np.max(np.abs(w64 - w32)) < 1e-4 * max(np.max(np.abs(w64)), 1.0)


def test_shapes_property():
    """Property 4 (design.md:183-187): output is (frames*num_freqs, 2)."""
    from gomel_tpu.core.framing import frames_for_padded
    for n in (100, 19199, 40000):
        audio = make_audio(max(n, 10))[:n]
        p = Phase(sample_rate=48000, dtype=jnp.float64)
        spec = p.to_phase(audio)
        f = frames_for_padded(n, 1280, 4096)
        assert spec.shape == (f * 768, 2)
