"""Randomized FILE-level differential vs the reference port.

test_oracle_fuzz.py pins the buffer-level ops against the imported
reference port; this fuzzes the full FILE APIs — ``to_phase_wav``
(WAV -> PNG: reconfigure_sr, zero-stuff upsample, samples_in_mel metadata,
save_image) and ``to_wav_png`` (PNG -> WAV: load_image, from_phase,
nearest-rate rounding, family main_rate write, trim;
/root/reference/phase.py:222-349) — across all 8 supported sample rates
x {8-bit, IHS, HDR}. The port's soundfile is stubbed by conftest with
read/write backed by the in-tree WAV codec using libsndfile conversion
conventions, so both stacks read/write identical PCM bytes and the
differential isolates the DSP orchestration.

Tolerance model: our to_phase matches the port to ~2e-4 (device kernels vs
numpy, test_compat.py), so a value within float-noise of a quantization
bin edge may land one bin apart — decoded pixels are compared PRE-sinh
(the quantization grid is linear there) within one bin step. Reading the
SAME file through both readers must be EXACT. Decoding the same PNG
through both stacks compares output WAVs in PCM-16 units.
"""
import os
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from conftest import load_reference_phase
from gomel_tpu.compat import phase as compat
from gomel_tpu.io import wavcodec

ref = load_reference_phase()
needs_ref = pytest.mark.skipif(ref is None, reason="reference port unavailable")

RATES = [8000, 16000, 24000, 32000, 48000, 11025, 22050, 44100]
MODES = ["8bit", "ihs", "hdr"]


def _synth(rng, length, sr):
    t = np.arange(length) / sr
    f1, f2 = rng.uniform(50.0, 0.4 * sr, size=2)
    a = (0.5 * np.sin(2 * np.pi * f1 * t)
         + 0.3 * np.sin(2 * np.pi * f2 * t + 1.0)
         + 0.1 * rng.standard_normal(length))
    return np.clip(a, -0.99, 0.99)


def _quant_step(spec, maxval):
    """Per-channel quantization step of a decoded (pre-sinh) spectrogram:
    normalization maps min -> pixel 0 and max -> pixel maxval, so the grid
    span is recoverable from the decoded extrema."""
    s = np.asarray(spec, dtype=np.float64)
    return (s.max(axis=(0,)) - s.min(axis=(0,))).reshape(-1, 2).max(axis=0) \
        / maxval if s.ndim == 3 else None


@needs_ref
@settings(max_examples=24, deadline=None, derandomize=True)
@given(sr=st.sampled_from(RATES), mode=st.sampled_from(MODES),
       seed=st.integers(0, 2**31 - 1), length=st.integers(2_000, 24_000))
def test_file_level_differential(sr, mode, seed, length):
    hdr, ihs = mode == "hdr", mode == "ihs"
    maxval = 65535.0 if hdr else 255.0
    rng = np.random.default_rng(seed)
    audio = _synth(rng, length, sr)
    with tempfile.TemporaryDirectory() as d:
        wav_in = os.path.join(d, "in.wav")
        compat.save_wav(wav_in, audio, sr)

        ours = compat.Phase(sample_rate=sr, HDR=hdr, IHS=ihs)
        theirs = ref.Phase(sample_rate=sr, HDR=hdr, IHS=ihs)
        assert ours.num_freqs == theirs.num_freqs
        assert ours.IHS == theirs.IHS  # stored as pass count (phase.py:41)
        png_o = os.path.join(d, "ours.png")
        png_r = os.path.join(d, "ref.png")
        ours.to_phase_wav(wav_in, png_o)
        theirs.to_phase_wav(wav_in, png_r)

        # -- PNG differential (pre-sinh: linear quantization grid) ---------
        oo = compat.load_image(png_o, True, hdr, 0)
        ro = ref.load_image(png_o, True, hdr, 0)
        rr = ref.load_image(png_r, True, hdr, 0)
        or_ = compat.load_image(png_r, True, hdr, 0)
        # same file, both readers: EXACT pixels + exact metadata
        np.testing.assert_array_equal(np.asarray(oo[0]), np.asarray(ro[0]))
        assert oo[1:] == ro[1:]
        np.testing.assert_array_equal(np.asarray(or_[0]), np.asarray(rr[0]))
        assert or_[1:] == rr[1:]
        # cross-writer: metadata identical (samples_in_mel is an exact
        # integer ratio; sr embedded verbatim), pixels within ONE bin step
        assert oo[1:] == rr[1:], (oo[1:], rr[1:])
        a, b = np.asarray(oo[0], np.float64), np.asarray(rr[0], np.float64)
        assert a.shape == b.shape
        step = (b.max(axis=0) - b.min(axis=0)) / maxval  # per-channel
        diff = np.abs(a - b).max(axis=0)
        assert np.all(diff <= step * 1.000001 + 1e-12), (diff, step)

        # -- WAV differential: decode the SAME png through both stacks -----
        wav_o = os.path.join(d, "out_ours.wav")
        wav_r = os.path.join(d, "out_ref.wav")
        rate_o = compat.Phase(sample_rate=sr, HDR=hdr,
                              IHS=ihs).to_wav_png(png_r, wav_o)
        rate_r = ref.Phase(sample_rate=sr, HDR=hdr,
                           IHS=ihs).to_wav_png(png_r, wav_r)
        assert rate_o == rate_r == sr  # nearest-standard-rate round trip
        pcm_o, sro = wavcodec.read_wav(wav_o)
        pcm_r, srr = wavcodec.read_wav(wav_r)
        assert sro == srr  # the family main_rate, not the embedded rate
        assert srr == (48000 if theirs.num_freqs in (768, 1536) else 44100)
        assert pcm_o.shape == pcm_r.shape
        d16 = np.abs(pcm_o.astype(np.int32) - pcm_r.astype(np.int32))
        # float-kernel noise through from_phase maps to a few PCM-16 LSB
        assert d16.max() <= 64, d16.max()
        denom = max(float(np.sqrt(np.mean(pcm_r.astype(np.float64) ** 2))),
                    1.0)
        assert float(np.sqrt(np.mean(d16.astype(np.float64) ** 2))) \
            <= 0.01 * denom + 1.0

        # -- full chain (our png -> our wav) stays on the same signal ------
        wav_full = os.path.join(d, "out_full.wav")
        compat.Phase(sample_rate=sr, HDR=hdr, IHS=ihs).to_wav_png(png_o,
                                                                  wav_full)
        pcm_f, _ = wavcodec.read_wav(wav_full)
        assert pcm_f.shape == pcm_r.shape
        n = len(pcm_f)
        if n > 8192:  # ignore edges; quantization-grid noise dominates
            x1 = pcm_f[4096:n - 4096].astype(np.float64)
            x2 = pcm_r[4096:n - 4096].astype(np.float64)
            if x1.std() > 10 and x2.std() > 10:
                assert np.corrcoef(x1, x2)[0, 1] > 0.99


@needs_ref
@settings(max_examples=24, deadline=None, derandomize=True)
@given(sr=st.sampled_from(RATES), mode=st.sampled_from(MODES),
       seed=st.integers(0, 2**31 - 1), length=st.integers(2_000, 24_000))
def test_file_level_differential_device_quantize(sr, mode, seed, length):
    """Same differential with the device-fused quantizer on OUR side
   : Phase(device_quantize=True) writes PNGs within one
    quantization step of the port's (HDR included at 65535 levels, where
    f32 rounding can reach 2 steps) with EXACT metadata, and its fused
    dequantize+decode of the port's own PNG matches the port's WAV within
    PCM-16 tolerance."""
    hdr, ihs = mode == "hdr", mode == "ihs"
    maxval = 65535.0 if hdr else 255.0
    rng = np.random.default_rng(seed)
    audio = _synth(rng, length, sr)
    with tempfile.TemporaryDirectory() as d:
        wav_in = os.path.join(d, "in.wav")
        compat.save_wav(wav_in, audio, sr)

        ours = compat.Phase(sample_rate=sr, HDR=hdr, IHS=ihs,
                            device_quantize=True)
        theirs = ref.Phase(sample_rate=sr, HDR=hdr, IHS=ihs)
        png_o = os.path.join(d, "ours.png")
        png_r = os.path.join(d, "ref.png")
        ours.to_phase_wav(wav_in, png_o)
        theirs.to_phase_wav(wav_in, png_r)

        # -- PNG differential (pre-sinh: linear quantization grid) ---------
        oo = ref.load_image(png_o, True, hdr, 0)   # port reads OUR file
        rr = ref.load_image(png_r, True, hdr, 0)
        # metadata identical (f16-packed bytes must agree exactly)
        assert oo[1:] == rr[1:], (oo[1:], rr[1:])
        a, b = np.asarray(oo[0], np.float64), np.asarray(rr[0], np.float64)
        assert a.shape == b.shape
        step = (b.max(axis=0) - b.min(axis=0)) / maxval  # per-channel
        diff = np.abs(a - b).max(axis=0)
        steps = 2 if hdr else 1  # f32 ulp at 65535 spans ~2 LSB
        assert np.all(diff <= step * (steps + 1e-6) + 1e-12), (diff, step)

        # -- WAV differential: fused decode of the PORT's png --------------
        wav_o = os.path.join(d, "out_ours.wav")
        wav_r = os.path.join(d, "out_ref.wav")
        rate_o = compat.Phase(sample_rate=sr, HDR=hdr, IHS=ihs,
                              device_quantize=True).to_wav_png(png_r, wav_o)
        rate_r = ref.Phase(sample_rate=sr, HDR=hdr,
                           IHS=ihs).to_wav_png(png_r, wav_r)
        assert rate_o == rate_r == sr
        pcm_o, sro = wavcodec.read_wav(wav_o)
        pcm_r, srr = wavcodec.read_wav(wav_r)
        assert sro == srr
        assert pcm_o.shape == pcm_r.shape
        d16 = np.abs(pcm_o.astype(np.int32) - pcm_r.astype(np.int32))
        assert d16.max() <= 64, d16.max()
        denom = max(float(np.sqrt(np.mean(pcm_r.astype(np.float64) ** 2))),
                    1.0)
        assert float(np.sqrt(np.mean(d16.astype(np.float64) ** 2))) \
            <= 0.01 * denom + 1.0
