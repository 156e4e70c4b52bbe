#!/usr/bin/env python
"""Smoke run of the codecs' main paths on one GPU, checked against the
float64 reference (gomel_tpu/reference.py).

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --four     # four cards: the multi-card paths only

Phases on one card, at the reference CLI widths (mel: 192 mels, hop 1280,
FFT 4096, fmax 16 kHz; phase: PhaseConfig.cli_default()):

  parity    Mel/Phase encode of a 30 s 48 kHz clip, phase decode and round
            trip, Griffin-Lim 2 and 64 from a fixed init, each against the
            float64 reference with a written-down tolerance (TOL below).
  cli       tomel, towav, tophase, fromphase on a 30 s 48 kHz WAV, called
            in-process through gomel_tpu.cli.tools.main.
  corpus    batch-tomel and batch-tophase over 64 seeded 16-bit WAVs (1-30 s,
            48 and 44.1 kHz, mono and stereo); every PNG is read back and
            compared with the reference within one quantization step.
  longform  a 10-minute 48 kHz file through LongFormMel (GL-64) and
            LongFormPhase, WAV -> PNG -> WAV, on a 1x1 mesh.
  serving   mel-enc, mel-dec, phase-rt and phase-enc-q artifacts at batch
            8 x 30 s with the builders' default platforms: save, load, call,
            compare with the live jit.

With --four: LongFormMel (GL-64) and LongFormPhase on a (data=1, frame=4)
mesh over the 10-minute signal, BatchedMel and BatchedPhase on a (data=4,
frame=1) mesh over 8 x 30 s, each compared with the same call on one card.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}. The script exits
nonzero, and prints no such line, when the default backend is not a GPU,
when a phase raises, when a check misses its tolerance, or when a native
host helper fell back to pure Python. One process drives every card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Tolerances, each with its reason (a check fails above its tolerance).
TOL = {
    # filterbank sums are non-negative; TF32 rounds each operand to 2^-11
    # relative, so log error stays ~1e-3 on every band with content
    "mel_log_ordinary": 2e-3,
    # bins near the 1e-5 clamp, where the f32 FFT's absolute error (relative
    # to the frame's peak, not to the bin) dominates: the worst-case input
    # (full-scale tone + -100 dB tones + silence) and mel band 0 of channel
    # 0, which holds the DC bin alone — tens of dB down for zero-mean audio
    # (the f32 class; TF32 and HIGHEST filterbanks read the same here)
    "mel_log_f32_floor": 0.25,
    # f32 rFFT, relative to the spectrogram's peak bin
    "phase_spec_rel": 1e-5,
    # half a PCM-16 step of full scale
    "phase_wave_abs": 1.5e-5,
    # two iterations from the same init, f32 cuFFT vs float64
    "gl2_rel_l2": 1e-4,
    # 64 iterations: spectral convergence within 1% of the reference's
    "gl64_sc_rel": 0.01,
    # artifact vs live jit of the same program on the same card
    "artifact_rel": 1e-6,
    # one-card vs four-card f32 results (other reduction orders)
    "four_rel": 1e-5,
    # a PNG read back: 8-bit truncation (one step), the extrema stored as
    # float16 (2^-11 relative: up to ~1/8 of a step) and the device error
    # above (< 0.05 of a step)
    "png_steps": 1.15,
}
SR = 48000
SECONDS = 30.0
LONG_SECONDS = 600.0
BATCH = 8
N_CORPUS = 64


class Smoke:
    """Per-phase timing, compile accounting and the parity ledger."""

    def __init__(self):
        self.compile_s = 0.0
        self.cache = {"hits": 0, "misses": 0}
        self.failures: list[str] = []

    def listen(self):
        import jax.monitoring as mon

        def on_duration(event, secs, **_):
            if event.startswith("/jax/core/compile/"):
                self.compile_s += secs

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.cache["hits"] += 1
            elif event == "/jax/compilation_cache/cache_misses":
                self.cache["misses"] += 1

        mon.register_event_duration_secs_listener(on_duration)
        mon.register_event_listener(on_event)

    @contextlib.contextmanager
    def phase(self, name: str):
        c0, t0 = self.compile_s, time.perf_counter()
        print(f"phase {name}: start", flush=True)
        yield
        print(f"phase {name}: wall {time.perf_counter() - t0:.2f} s, "
              f"compile {self.compile_s - c0:.2f} s", flush=True)

    def check(self, name: str, err: float, tol: float) -> None:
        ok = bool(np.isfinite(err)) and err <= tol
        print(f"  parity {name}: {err:.3e} <= {tol:.1e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(name)

    def require(self, name: str, cond: bool, detail: str = "") -> None:
        print(f"  check {name}: {'ok' if cond else 'FAIL'} {detail}".rstrip(),
              flush=True)
        if not cond:
            self.failures.append(name)


# -- inputs ------------------------------------------------------------------

def tonal(n: int, sr: int, seed: int, amp: float = 0.3) -> np.ndarray:
    """Band-limited test signal: two tones under a slow envelope + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = amp * (np.sin(2 * np.pi * 220.0 * t) * (1 + 0.5 * np.sin(0.7 * t))
               + 0.4 * np.sin(2 * np.pi * 2333.0 * t + 0.3))
    return x + 0.01 * rng.standard_normal(n)


def worst_case(n: int, sr: int) -> np.ndarray:
    """Full-scale tone + -100 dB tones for a third, the quiet tones alone
    for a third, digital silence for the last third."""
    t = np.arange(n) / sr
    x = sum(1e-5 * np.sin(2 * np.pi * f * t)
            for f in (1500.0, 5000.0, 9000.0, 14000.0))
    third = n // 3
    x[:third] += np.sin(2 * np.pi * 997.0 * t[:third])
    x[2 * third:] = 0.0
    return x


def pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(np.clip(x, -1, 1) * 32768.0), -32768,
                   32767).astype(np.int16)


def mel_log_errors(got, ref) -> tuple[float, float]:
    """(max |dlog| over every mel entry but the DC bin, max |dlog| on the
    DC bin): band 0 of channel 0 is the DC bin alone (core.filterbank)."""
    d = np.abs(np.asarray(got, np.float64) - ref)
    dc = float(d[..., 0, 0].max())
    d[..., 0, 0] = 0.0
    return float(d.max()), dc


def check_mel(s, name: str, got, ref) -> None:
    body, dc = mel_log_errors(got, ref)
    s.check(f"{name}, max |dlog|", body, TOL["mel_log_ordinary"])
    s.check(f"{name}, DC bin, max |dlog|", dc, TOL["mel_log_f32_floor"])


def decoded_length(n: int, hop: int, frame_len: int) -> int:
    """Length of the WAV a decoder writes for an n-sample input: the
    frames cover at most the padded input, and the output is trimmed to n."""
    from gomel_tpu.core.framing import frames_for_padded, output_length
    return min(n, output_length(frames_for_padded(n, hop, frame_len),
                                frame_len, hop))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out


# -- one-card phases -------------------------------------------------------------

def phase_parity(s: Smoke, scale: float) -> None:
    import jax
    import jax.numpy as jnp
    from gomel_tpu import Mel, MelConfig, Phase, PhaseConfig
    from gomel_tpu import reference as R
    from gomel_tpu.core.framing import pad_length
    from gomel_tpu.ops.griffinlim import griffin_lim

    mc, pc = MelConfig.cli_default(), PhaseConfig.cli_default()
    n = pad_length(int(SECONDS * scale * SR), mc.window)
    x = tonal(n, SR, seed=1)
    mel = Mel(mc)
    got = np.asarray(mel.encode(x.astype(np.float32)), np.float64)
    ref = R.mel_encode(x, mc.num_mels, mc.resolut, mc.window, mc.mel_fmin,
                       mc.mel_fmax)
    check_mel(s, "mel encode, 30 s", got, ref)
    w = worst_case(n, SR)
    got_w = np.asarray(mel.encode(w.astype(np.float32)), np.float64)
    ref_w = R.mel_encode(w, mc.num_mels, mc.resolut, mc.window, mc.mel_fmin,
                         mc.mel_fmax)
    s.check("mel encode, worst case, max |dlog|", np.abs(got_w - ref_w).max(),
            TOL["mel_log_f32_floor"])

    ph = Phase(pc)
    spec = np.asarray(ph.encode(x.astype(np.float32)), np.float64)
    spec_ref = R.phase_encode(x, pc.num_freqs, pc.resolut, pc.window)
    s.check("phase encode, max |d| / peak",
            np.abs(spec - spec_ref).max() / np.abs(spec_ref).max(),
            TOL["phase_spec_rel"])
    wave = np.asarray(ph.decode(spec_ref.astype(np.float32)), np.float64)
    wave_ref = R.phase_decode(spec_ref, pc.resolut, pc.window)
    s.check("phase decode, max |d| (full scale 1)",
            np.abs(wave - wave_ref).max(), TOL["phase_wave_abs"])
    rt = np.asarray(ph.decode(ph.encode(x.astype(np.float32))), np.float64)
    s.check("phase round trip, max |d| (full scale 1)",
            np.abs(rt - wave_ref).max(), TOL["phase_wave_abs"])

    mag = R.mel_magnitudes(ref, mc.resolut, mc.mel_fmin, mc.mel_fmax)
    init = np.random.default_rng(2).random(
        mc.resolut + (mag.shape[0] - 1) * mc.window)
    gl = jax.jit(lambda m, i, n_iter: griffin_lim(m, mc.window, n_iter, None,
                                                  init=i),
                 static_argnums=2)
    g2 = np.asarray(gl(jnp.asarray(mag, jnp.float32),
                       jnp.asarray(init, jnp.float32), 2), np.float64)
    r2 = R.griffin_lim(mag, mc.window, 2, init)
    s.check("Griffin-Lim 2, relative L2",
            np.linalg.norm(g2 - r2) / np.linalg.norm(r2), TOL["gl2_rel_l2"])
    g64 = np.asarray(gl(jnp.asarray(mag, jnp.float32),
                        jnp.asarray(init, jnp.float32), 64), np.float64)
    r64 = R.griffin_lim(mag, mc.window, 64, init)
    sc_dev = R.spectral_convergence(g64, mag, mc.window)
    sc_ref = R.spectral_convergence(r64, mag, mc.window)
    print(f"  Griffin-Lim 64 spectral convergence: device {sc_dev:.5f}, "
          f"reference {sc_ref:.5f}")
    s.check("Griffin-Lim 64, |sc - sc_ref| / sc_ref",
            abs(sc_dev - sc_ref) / sc_ref, TOL["gl64_sc_rel"])


def phase_cli(s: Smoke, tmp: str, scale: float) -> None:
    from gomel_tpu.cli.tools import main
    from gomel_tpu.io.audio import load_wav, save_wav

    n = int(SECONDS * scale * SR)
    x = tonal(n, SR, seed=3)
    wav = os.path.join(tmp, "clip.wav")
    save_wav(wav, x, SR)
    for argv in (["tomel", wav, "-o", wav + ".mel.png"],
                 ["towav", wav + ".mel.png", str(SR), "-o", wav + ".mel.wav"],
                 ["tophase", wav, "-o", wav + ".ph.png"],
                 ["fromphase", wav + ".ph.png", "-o", wav + ".ph.wav"]):
        rc = main(argv)
        s.require(f"{argv[0]} exit code", rc == 0, f"rc={rc}")
    m = decoded_length(n, 1280, 4096)
    mel_wave, mel_sr = load_wav(wav + ".mel.wav", mono="left")
    s.require("towav output", mel_sr == SR and len(mel_wave) == m
              and np.isfinite(mel_wave).all() and np.abs(mel_wave).max() > 0,
              f"sr={mel_sr} len={len(mel_wave)}/{m}")
    ph_wave, ph_sr = load_wav(wav + ".ph.wav", mono="left")
    ref = pcm16(x) / 32768.0
    edge = 4096  # the window-sum fade at both ends
    corr = np.corrcoef(ph_wave[edge:m - edge], ref[edge:m - edge])[0, 1]
    s.require("fromphase round trip", ph_sr == SR and len(ph_wave) == m
              and corr > 0.99, f"sr={ph_sr} len={len(ph_wave)}/{m} "
              f"corr={corr:.5f}")


def phase_corpus(s: Smoke, tmp: str, scale: float) -> None:
    from gomel_tpu import reference as R
    from gomel_tpu.cli.tools import main
    from gomel_tpu.core.config import (MelConfig, PhaseConfig,
                                       num_freqs_for_sample_rate)
    from gomel_tpu.core.framing import pad_length
    from gomel_tpu.io import imagecodec
    from gomel_tpu.io.audio import load_wav
    from gomel_tpu.io.wavcodec import write_wav

    rng = np.random.default_rng(7)
    src = os.path.join(tmp, "corpus")
    os.makedirs(src)
    n_files = max(8, int(N_CORPUS * min(1.0, scale * 10)))
    files = []
    for i in range(n_files):
        sr = (48000, 44100)[i % 2]
        secs = float(np.clip(np.exp(rng.uniform(0.0, np.log(30.0))), 1, 30))
        n = int(secs * scale * sr)
        chans = 1 + (i // 2) % 2
        x = np.stack([tonal(n, sr, seed=100 + i + c, amp=0.2 + 0.1 * c)
                      for c in range(chans)], axis=1)
        path = os.path.join(src, f"f{i:03d}.wav")
        write_wav(path, pcm16(x if chans == 2 else x[:, 0]), sr)
        files.append(path)
    print(f"  corpus: {n_files} files, "
          f"{sum(os.path.getsize(f) for f in files) / 1e6:.1f} MB")
    mel_out, ph_out = os.path.join(tmp, "mel_png"), os.path.join(tmp, "ph_png")
    s.require("batch-tomel exit code",
              main(["batch-tomel", src, "--out-dir", mel_out]) == 0)
    s.require("batch-tophase exit code",
              main(["batch-tophase", src, "--out-dir", ph_out]) == 0)

    mc = MelConfig.cli_default()
    worst_mel, worst_ph = 0.0, 0.0
    for path in files:
        buf, sr = load_wav(path, mono="left")
        x = np.pad(buf, (0, pad_length(len(buf), mc.window) - len(buf)))
        png = os.path.join(mel_out, os.path.basename(path) + ".png")
        spec, _, _ = imagecodec.load_mel_image(png, y_reverse=True)
        ref = R.mel_encode(x, mc.num_mels, mc.resolut, mc.window,
                           mc.mel_fmin, mc.mel_fmax)
        step = (ref.max() - ref.min()) / 255.0  # the PNG's 8-bit step
        worst_mel = max(worst_mel, np.abs(spec - ref).max() / step)
        nf = num_freqs_for_sample_rate(sr)
        pcfg = PhaseConfig(num_freqs=nf)
        png = os.path.join(ph_out, os.path.basename(path) + ".png")
        pspec, _, _, _ = imagecodec.load_phase_image(png, y_reverse=True)
        pref = R.phase_encode(x, nf, pcfg.resolut, pcfg.window)
        pstep = (pref.max(axis=(0, 1)) - pref.min(axis=(0, 1))) / 255.0
        worst_ph = max(worst_ph, (np.abs(pspec - pref) / pstep).max())
    s.check("batch-tomel PNGs vs reference, max |d| in 8-bit steps",
            worst_mel, TOL["png_steps"])
    s.check("batch-tophase PNGs vs reference, max |d| in 8-bit steps",
            worst_ph, TOL["png_steps"])


def phase_longform(s: Smoke, tmp: str, scale: float) -> None:
    import dataclasses

    from gomel_tpu import reference as R
    from gomel_tpu.core.config import MelConfig, PhaseConfig
    from gomel_tpu.core.framing import pad_length
    from gomel_tpu.io.audio import load_wav, save_wav
    from gomel_tpu.parallel.mesh import make_mesh
    from gomel_tpu.pipelines.longform import LongFormMel, LongFormPhase

    import jax
    mesh = make_mesh(data=1, frame=1, devices=jax.devices()[:1])
    n = int(LONG_SECONDS * scale * SR)
    x = tonal(n, SR, seed=11)
    wav = os.path.join(tmp, "long.wav")
    save_wav(wav, x, SR)
    mc = dataclasses.replace(MelConfig.cli_default(),
                             griffin_lim_iterations=64)
    lfm = LongFormMel(mc, mesh, device_quantize=True)
    lfm.to_mel_wav(wav, wav + ".mel.png")
    lfm.to_wav_png(wav + ".mel.png", wav + ".mel.wav")
    m = decoded_length(n, mc.window, mc.resolut)
    y, sr = load_wav(wav + ".mel.wav", mono="left")
    s.require("LongFormMel GL-64 WAV", sr == SR and len(y) == m
              and np.isfinite(y).all() and np.abs(y).max() > 0,
              f"len={len(y)}/{m}")
    xp = np.pad(x, (0, pad_length(n, mc.window) - n))
    got = np.asarray(lfm.encode(xp.astype(np.float32))[0], np.float64)
    ref = R.mel_encode(xp, mc.num_mels, mc.resolut, mc.window, mc.mel_fmin,
                       mc.mel_fmax)
    check_mel(s, "LongFormMel encode, 10 min", got, ref)
    del got, ref

    pc = PhaseConfig.cli_default()
    lfp = LongFormPhase(pc, mesh, device_quantize=True)
    lfp.to_phase_wav(wav, wav + ".ph.png")
    lfp.to_wav_png(wav + ".ph.png", wav + ".ph.wav")
    y, sr = load_wav(wav + ".ph.wav", mono="left")
    ref_pcm = pcm16(x) / 32768.0
    edge = 4096
    corr = np.corrcoef(y[edge:m - edge], ref_pcm[edge:m - edge])[0, 1]
    s.require("LongFormPhase WAV round trip", len(y) == m and corr > 0.99,
              f"len={len(y)}/{m} corr={corr:.5f}")
    spec = np.asarray(lfp.encode(xp.astype(np.float32))[0], np.float64)
    pref = R.phase_encode(xp, pc.num_freqs, pc.resolut, pc.window)
    s.check("LongFormPhase encode, 10 min, max |d| / peak",
            np.abs(spec - pref).max() / np.abs(pref).max(),
            TOL["phase_spec_rel"])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def phase_serving(s: Smoke, tmp: str, scale: float) -> None:
    import jax
    import jax.numpy as jnp
    from gomel_tpu import MelConfig, PhaseConfig, serving
    from gomel_tpu.core.filterbank import inverse_mel_weights, mel_weights
    from gomel_tpu.ops.mel_ops import mel_decode, mel_encode_batch
    from gomel_tpu.ops.phase_ops import phase_decode, phase_encode
    from gomel_tpu.ops.quantize import quantize_planes
    from gomel_tpu.ops.stft import hann_window

    mc, pc = MelConfig.cli_default(), PhaseConfig.cli_default()
    secs = SECONDS * scale
    f32 = jnp.float32

    def roundtrip(exp, kind):
        path = os.path.join(tmp, kind + ".jaxexp")
        serving.save_exported(exp, path, meta=serving.artifact_meta(
            exp, kind=kind))
        art = serving.load_exported(path)
        s.require(f"{kind} platforms", "cuda" in art.platforms,
                  str(art.platforms))
        return art

    n = serving.padded_samples(secs, SR, mc.window)
    xb = jnp.asarray(np.stack([tonal(n, SR, seed=20 + i)
                               for i in range(BATCH)]), f32)
    fwd = jnp.asarray(mel_weights(mc.n_bins, mc.num_mels, mc.mel_fmin,
                                  mc.mel_fmax), f32)
    inv = jnp.asarray(inverse_mel_weights(mc.n_bins, mc.num_mels,
                                          mc.mel_fmin, mc.mel_fmax), f32)
    win = jnp.asarray(hann_window(mc.resolut), f32)

    enc = roundtrip(serving.export_mel_encoder(
        mc, seconds=secs, sample_rate=SR, batch=BATCH), "mel-enc")
    live = jax.jit(lambda x: mel_encode_batch(x, mc.num_mels, mc.resolut,
                                              mc.window, fwd, win))(xb)
    got = enc.call(xb)
    s.check("mel-enc artifact vs live jit", _rel(got, live),
            TOL["artifact_rel"])

    keys = jnp.asarray(jax.random.split(jax.random.PRNGKey(0), BATCH))
    dec = roundtrip(serving.export_mel_decoder(
        mc, n_frames=live.shape[1], batch=BATCH), "mel-dec")
    want = jax.jit(jax.vmap(lambda m, k: mel_decode(
        m, mc.resolut, mc.window, inv, mc.griffin_lim_iterations, k,
        mc.tune_mul, mc.tune_add, None)))(live, keys)
    s.check("mel-dec artifact vs live jit", _rel(dec.call(live, keys), want),
            TOL["artifact_rel"])

    pwin = jnp.asarray(hann_window(pc.resolut), f32)
    rt = roundtrip(serving.export_phase_roundtrip(
        pc, seconds=secs, sample_rate=SR, batch=BATCH), "phase-rt")
    want = jax.jit(jax.vmap(lambda x: phase_decode(
        phase_encode(x, pc.num_freqs, pc.resolut, pc.window, pwin),
        pc.resolut, pc.window, pc.volume_boost, None)))(xb)
    s.check("phase-rt artifact vs live jit", _rel(rt.call(xb), want),
            TOL["artifact_rel"])

    encq = roundtrip(serving.export_phase_encoder_quantized(
        pc, seconds=secs, sample_rate=SR, batch=BATCH), "phase-enc-q")
    planes, mx, mn = encq.call(xb)
    lp, lmx, lmn = jax.jit(jax.vmap(lambda x: quantize_planes(
        phase_encode(x, pc.num_freqs, pc.resolut, pc.window, pwin),
        65535 if pc.hdr else 255, pc.ihs_passes)))(xb)
    flips = np.abs(np.asarray(planes, np.int64) - np.asarray(lp, np.int64))
    s.require("phase-enc-q planes vs live jit",
              flips.max() <= 1 and (flips > 0).mean() <= 1e-5,
              f"max {flips.max()}, share {(flips > 0).mean():.2e}")
    s.check("phase-enc-q extrema vs live jit",
            max(_rel(mx, lmx), _rel(mn, lmn)), TOL["artifact_rel"])


# -- four cards ------------------------------------------------------------------

def phase_four(s: Smoke, scale: float) -> None:
    import dataclasses

    import jax
    from gomel_tpu import reference as R
    from gomel_tpu.core.config import MelConfig, PhaseConfig
    from gomel_tpu.core.framing import pad_length
    from gomel_tpu.parallel import BatchedMel, BatchedPhase
    from gomel_tpu.parallel.mesh import make_mesh
    from gomel_tpu.pipelines.longform import LongFormMel, LongFormPhase

    devs = jax.devices()
    one = make_mesh(data=1, frame=1, devices=devs[:1])
    frames4 = make_mesh(data=1, frame=4, devices=devs[:4])
    data4 = make_mesh(data=4, frame=1, devices=devs[:4])

    def on_four(name, arr):
        n_dev = len(arr.sharding.device_set)
        s.require(f"{name} spans 4 devices", n_dev == 4, f"{n_dev}")
        return np.asarray(arr, np.float64)

    mc = dataclasses.replace(MelConfig.cli_default(),
                             griffin_lim_iterations=64)
    pc = PhaseConfig.cli_default()
    n = pad_length(int(LONG_SECONDS * scale * SR), mc.window)
    x = tonal(n, SR, seed=31).astype(np.float32)

    m4, m1 = LongFormMel(mc, frames4), LongFormMel(mc, one)
    lm4 = m4.encode(x)
    lm1 = np.asarray(m1.encode(x), np.float64)
    check_mel(s, "LongFormMel encode, 4 vs 1 card",
              on_four("LongFormMel encode", lm4), lm1)
    mag = R.mel_magnitudes(lm1[0], mc.resolut, mc.mel_fmin, mc.mel_fmax)
    y4 = on_four("LongFormMel GL-64", m4.decode(lm4, seed=0))[0]
    y1 = np.asarray(m1.decode(lm1, seed=0), np.float64)[0]
    sc4 = R.spectral_convergence(y4, mag, mc.window)
    sc1 = R.spectral_convergence(y1, mag, mc.window)
    print(f"  GL-64 spectral convergence: 4 cards {sc4:.5f}, 1 card {sc1:.5f}")
    s.check("LongFormMel GL-64, |sc4 - sc1| / sc1", abs(sc4 - sc1) / sc1,
            TOL["gl64_sc_rel"])

    p4, p1 = LongFormPhase(pc, frames4), LongFormPhase(pc, one)
    sp4 = p4.encode(x)
    sp1 = np.asarray(p1.encode(x), np.float64)
    s.check("LongFormPhase encode, 4 vs 1 card, max |d| / peak",
            _rel(on_four("LongFormPhase encode", sp4), sp1),
            TOL["four_rel"])
    w4 = on_four("LongFormPhase decode", p4.decode(sp4))
    w1 = np.asarray(p1.decode(sp1), np.float64)
    s.check("LongFormPhase round trip, 4 vs 1 card, max |d|",
            np.abs(w4 - w1).max(), TOL["phase_wave_abs"])

    nb = pad_length(int(SECONDS * scale * SR), mc.window)
    xb = np.stack([tonal(nb, SR, seed=40 + i) for i in range(BATCH)]
                  ).astype(np.float32)
    mcb = MelConfig.cli_default()
    bm4, bm1 = BatchedMel(mcb, mesh=data4), BatchedMel(mcb)
    e4, e1 = bm4.encode(xb), np.asarray(bm1.encode(xb), np.float64)
    check_mel(s, "BatchedMel encode, 4 vs 1 card",
              on_four("BatchedMel encode", e4), e1)
    d4 = on_four("BatchedMel decode", bm4.decode(e4, seed=0))
    d1 = np.asarray(bm1.decode(e1.astype(np.float32), seed=0), np.float64)
    s.check("BatchedMel GL-2, 4 vs 1 card, relative L2",
            np.linalg.norm(d4 - d1) / np.linalg.norm(d1), TOL["gl2_rel_l2"])
    bp4, bp1 = BatchedPhase(pc, mesh=data4), BatchedPhase(pc)
    q4 = bp4.encode(xb)
    q1 = np.asarray(bp1.encode(xb), np.float64)
    s.check("BatchedPhase encode, 4 vs 1 card, max |d| / peak",
            _rel(on_four("BatchedPhase encode", q4), q1), TOL["four_rel"])
    r4 = on_four("BatchedPhase decode", bp4.decode(q4))
    r1 = np.asarray(bp1.decode(q1.astype(np.float32)), np.float64)
    s.check("BatchedPhase round trip, 4 vs 1 card, max |d|",
            np.abs(r4 - r1).max(), TOL["phase_wave_abs"])


# -- driver ------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    ap.add_argument("--rehearse", action="store_true",
                    help="exercise the script on the CPU at 1/50 of the "
                         "durations; prints no result line")
    a = ap.parse_args(argv)

    import jax
    platform = jax.default_backend()
    if platform != "gpu" and not a.rehearse:
        print(f"chip_smoke: default backend is {platform!r}, not a GPU",
              file=sys.stderr)
        return 2
    scale = 0.02 if a.rehearse else 1.0
    need = 4 if a.four else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} devices, found {len(jax.devices())}",
              file=sys.stderr)
        return 2

    from gomel_tpu.io._native import native_status
    from gomel_tpu.utils.compile_cache import enable_compile_cache

    s = Smoke()
    cache_dir = enable_compile_cache()
    s.listen()
    dev = jax.devices()[0]
    print(card_line() if not a.rehearse else "cpu rehearsal")
    print(f"jax {jax.__version__}; device {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}; compile cache {cache_dir}")
    status = native_status()
    print(f"native helpers: {status}")
    s.require("native helpers loaded", all(status.values()), str(status))

    with tempfile.TemporaryDirectory(prefix="gomel_smoke_") as tmp:
        if a.four:
            with s.phase("four"):
                phase_four(s, scale)
        else:
            for name, fn, args in (
                    ("parity", phase_parity, (s, scale)),
                    ("cli", phase_cli, (s, tmp, scale)),
                    ("corpus", phase_corpus, (s, tmp, scale)),
                    ("longform", phase_longform, (s, tmp, scale)),
                    ("serving", phase_serving, (s, tmp, scale))):
                with s.phase(name):
                    fn(*args)
    print(f"compile cache: {s.cache['hits']} hits, "
          f"{s.cache['misses']} misses")
    if s.failures:
        print(f"FAILED: {s.failures}", file=sys.stderr)
        return 1
    if a.rehearse:
        print("rehearsal ok")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
