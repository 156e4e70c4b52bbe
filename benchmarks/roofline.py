"""Roofline accounting for the hot paths at the serving shape.

For each pipeline (mel encode, Griffin-Lim decode, phase encode, phase
decode) at batch 8 x 30 s this script reports:

  - FLOPs and bytes from XLA's own post-fusion cost model of the optimized
    HLO (``compiled.cost_analysis()``), with a hand count for mel encode,
  - measured steady-state time per call (bench.pipelined_time),
  - achieved FLOP/s and bytes/s, and their share of the device's published
    peaks (bench.DEVICE_PEAKS; an unknown device is an error).

XLA's "bytes accessed" sums every fused kernel's operand and result bytes,
so it approximates device-memory traffic; ``io_bytes`` is the lower bound
(inputs + outputs only).

Run from the repo root on the GPU:
    python benchmarks/roofline.py
"""
from __future__ import annotations

import math
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import jax
import jax.numpy as jnp
import numpy as np


def compiled_costs(jitted, *args) -> tuple[float, float]:
    """(flops, bytes accessed) from XLA's cost model of the optimized HLO."""
    ca = jitted.lower(*args).compile().cost_analysis()
    d = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(d.get("flops", 0.0)), float(d.get("bytes accessed", 0.0))


def hand_count_mel_encode(n_frames: int, n: int, num_mels: int) -> float:
    """Independent FLOP count for mel encode, to cross-check XLA's model.

    Per frame (N = frame length):
      window            N mul
      real FFT          ~2.5 N log2 N (split-radix class)
      |.|               ~4*(N/2+1)  (sq, sq, add, sqrt)
      mel matmul        extended-weight single matmul: 2*(N/2+1)*(2*mels)
      log-normalize     ~2*num_mels*2
    """
    per_frame = (n + 2.5 * n * math.log2(n) + 4 * (n // 2 + 1)
                 + 2 * (n // 2 + 1) * (2 * num_mels) + 4 * num_mels)
    return float(n_frames * per_frame)


def io_bytes(out, *args) -> float:
    """Device-memory traffic lower bound: input + output array bytes."""
    leaves = jax.tree_util.tree_leaves((out, args))
    return float(sum(x.size * x.dtype.itemsize for x in leaves))


def report(name: str, flops: float, nbytes: float, hbm_io: float,
           secs: float, audio_s: float, peaks: dict) -> None:
    print(f"{name:24s} {audio_s / secs:9.0f} a-s/s   "
          f"{flops / 1e9:7.2f} GFLOP  {nbytes / 1e6:8.1f} MB   "
          f"{flops / secs / 1e12:6.2f} TFLOP/s "
          f"({100 * flops / secs / peaks['f32_flops']:4.1f}% of f32 peak)   "
          f"{nbytes / secs / 1e9:6.0f} GB/s "
          f"({100 * nbytes / secs / peaks['hbm_bytes_per_s']:4.1f}% of HBM)"
          f"   I/O floor {hbm_io / secs / 1e9:5.1f} GB/s")


def main() -> None:
    import bench
    from gomel_tpu.core.config import MelConfig, PhaseConfig
    from gomel_tpu.core.filterbank import inverse_mel_weights, mel_weights
    from gomel_tpu.core.framing import pad_length
    from gomel_tpu.ops.mel_ops import mel_decode, mel_encode_batch
    from gomel_tpu.ops.phase_ops import phase_decode, phase_encode
    from gomel_tpu.ops.stft import hann_window
    from gomel_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = MelConfig.cli_default()
    sr, secs, batch = 48000, 30.0, 8  # the serving shape of chip_smoke.py
    n = pad_length(int(sr * secs), cfg.window)
    audio_s = batch * n / sr
    n_frames = (n - cfg.resolut) // cfg.window + 1

    dev = jax.devices()[0]
    peaks = bench.device_peaks(dev.device_kind)
    print(f"device: {dev.platform} {dev.device_kind}   shape: batch {batch} "
          f"x {secs:.0f} s @ {sr} Hz ({audio_s:.0f} audio-s/call)")
    print(f"peaks ({peaks['source']}): {peaks['f32_flops'] / 1e12:.0f} "
          f"TFLOP/s f32, {peaks['hbm_bytes_per_s'] / 1e12:.2f} TB/s HBM\n")

    fwd = jnp.asarray(mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                                  cfg.mel_fmax), jnp.float32)
    window = jnp.asarray(hann_window(cfg.resolut), jnp.float32)

    step = jax.jit(lambda xb: mel_encode_batch(
        xb, cfg.num_mels, cfg.resolut, cfg.window, fwd, window))
    rng = np.random.default_rng(0)
    xbs = [jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
           for _ in range(2)]

    flops, nbytes = compiled_costs(step, xbs[0])
    hand = hand_count_mel_encode(batch * n_frames, cfg.resolut, cfg.num_mels)
    t = bench.pipelined_time(step, [(x,) for x in xbs], n_lo=20, n_hi=120)
    report("mel encode", flops, nbytes, io_bytes(step(xbs[0]), xbs[0]), t,
           audio_s, peaks)
    print(f"{'':24s} hand count {hand / 1e9:.2f} GFLOP "
          f"(XLA/hand = {flops / hand:.2f})")

    inv = jnp.asarray(inverse_mel_weights(cfg.n_bins, cfg.num_mels,
                                          cfg.mel_fmin, cfg.mel_fmax),
                      jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    logmels = [step(x) for x in xbs]
    gl = jax.jit(jax.vmap(
        lambda s, k: mel_decode(s, cfg.resolut, cfg.window, inv,
                                cfg.griffin_lim_iterations, k, 1.0, 0.0,
                                None)))
    flops, nbytes = compiled_costs(gl, logmels[0], keys)
    t = bench.pipelined_time(gl, [(m, keys) for m in logmels], n_lo=5,
                             n_hi=25)
    report(f"griffin-lim({cfg.griffin_lim_iterations}) decode", flops,
           nbytes, io_bytes(gl(logmels[0], keys), logmels[0], keys), t,
           audio_s, peaks)

    pc = PhaseConfig.cli_default()
    pwin = jnp.asarray(hann_window(pc.resolut), jnp.float32)
    pe = jax.jit(jax.vmap(lambda x: phase_encode(
        x, pc.num_freqs, pc.resolut, pc.window, pwin)))
    pd = jax.jit(jax.vmap(lambda s: phase_decode(
        s, pc.resolut, pc.window, 0.0, None)))
    specs = [pe(x) for x in xbs]
    flops, nbytes = compiled_costs(pe, xbs[0])
    t = bench.pipelined_time(pe, [(x,) for x in xbs], n_lo=8, n_hi=40)
    report("phase encode", flops, nbytes, io_bytes(specs[0], xbs[0]), t,
           audio_s, peaks)
    flops, nbytes = compiled_costs(pd, specs[0])
    t = bench.pipelined_time(pd, [(s,) for s in specs], n_lo=8, n_hi=40)
    report("phase decode", flops, nbytes, io_bytes(pd(specs[0]), specs[0]),
           t, audio_s, peaks)


if __name__ == "__main__":
    main()
