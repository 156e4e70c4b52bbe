"""Scaling-efficiency harness: audio-seconds/s at 1 device vs N devices.

BASELINE.json requires >0.9 scaling efficiency at N >= 2 hosts. On real pods
run this under ``jax.distributed`` (one process per host); without a pod it
self-validates on an N-virtual-device CPU mesh
(``--xla_force_host_platform_device_count``), which exercises the identical
shard_map/collective code path (SURVEY.md §4 multi-node strategy).

Usage:
  python benchmarks/scaling.py                 # real backend, all devices
  python benchmarks/scaling.py --virtual 8     # 8 virtual CPU devices
Prints a JSON report.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (test mode)")
    ap.add_argument("--secs", type=float, default=30.0)
    ap.add_argument("--batch-per-device", type=int, default=4)
    ap.add_argument("--mode", choices=["data", "frame", "overhead"],
                    default="data",
                    help="scale via data-parallel batch or frame sharding; "
                         "'overhead' measures sharding overhead at FIXED "
                         "total work (the meaningful quantity on virtual "
                         "devices that time-slice the same cores)")
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={args.virtual}")
    import jax
    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from gomel_tpu.core.config import MelConfig
    from gomel_tpu.core.filterbank import mel_weights
    from gomel_tpu.core.framing import num_frames, pad_length
    from gomel_tpu.parallel import batch as pbatch
    from gomel_tpu.parallel import sharded as sh
    from gomel_tpu.parallel.mesh import make_mesh
    from gomel_tpu.utils.metrics import measure_throughput, scaling_efficiency

    cfg = MelConfig.cli_default()
    sr = 48000
    n = pad_length(int(sr * args.secs), cfg.window)
    devices = jax.devices()
    n_dev = len(devices)
    rng = np.random.default_rng(0)

    def run(n_devices: int):
        if args.mode == "data":
            mesh = make_mesh(data=n_devices, frame=1,
                             devices=devices[:n_devices])
            bm = pbatch.BatchedMel(cfg, mesh=mesh)
            b = args.batch_per_device * n_devices
            xb = rng.standard_normal((b, n)).astype(np.float32)
            xs = bm._shard(jnp.asarray(xb))
            return measure_throughput(bm._encode, (xs,), b * n / sr,
                                      n_devices=n_devices)
        mesh = make_mesh(data=1, frame=n_devices, devices=devices[:n_devices])
        f = num_frames(n, cfg.resolut, cfg.window)
        plan = sh.plan_frame_sharding(f, cfg.resolut, cfg.window, n_devices)
        w = mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin, cfg.mel_fmax)
        enc = sh.sharded_mel_encode_fn(mesh, plan, cfg.num_mels, w)
        b = args.batch_per_device
        xb = sh.pad_signal_for_plan(
            jnp.asarray(rng.standard_normal((b, n)), jnp.float32), plan)
        return measure_throughput(enc, (xb,), b * n / sr, n_devices=n_devices)

    if args.mode == "overhead":
        # Fixed TOTAL work, unsharded vs sharded over all devices. On a
        # virtual CPU mesh the N "devices" time-slice the same cores, so a
        # wall-clock speedup is unmeasurable — but the sharding OVERHEAD
        # (halo exchange, collectives, padding skew) shows up directly as
        # T_sharded / T_unsharded - 1 at equal total work. Combined with
        # the analytic ICI cost model (docs/SCALING.md) this bounds real-pod
        # efficiency: eff >= 1 / (1 + overhead_fraction).
        from gomel_tpu.core.filterbank import inverse_mel_weights
        from gomel_tpu.ops.mel_ops import mel_decode, mel_encode

        b = args.batch_per_device
        xb = jnp.asarray(rng.standard_normal((b, n)), jnp.float32)
        xb2 = jnp.asarray(rng.standard_normal((b, n)), jnp.float32)
        audio_s = b * n / sr
        w = mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin, cfg.mel_fmax)
        wj = jnp.asarray(w, jnp.float32)
        iw = jnp.asarray(inverse_mel_weights(
            cfg.n_bins, cfg.num_mels, cfg.mel_fmin, cfg.mel_fmax), jnp.float32)
        keys = jax.random.split(jax.random.PRNGKey(0), b)

        # unsharded baselines (single logical device); inputs alternate
        # between two batches
        enc1 = jax.jit(jax.vmap(lambda x: mel_encode(
            x, cfg.num_mels, cfg.resolut, cfg.window, wj)))
        dec1 = jax.jit(jax.vmap(lambda m, k: mel_decode(
            m, cfg.resolut, cfg.window, iw, cfg.griffin_lim_iterations, k)))
        logmel = enc1(xb)
        logmel2 = enc1(xb2)
        t_enc1 = measure_throughput(enc1, (xb,), audio_s, alt_args=(xb2,))
        t_dec1 = measure_throughput(dec1, (logmel, keys), audio_s,
                                    alt_args=(logmel2, keys))

        # frame-sharded over the full mesh, same total work
        mesh = make_mesh(data=1, frame=n_dev, devices=devices)
        f = num_frames(n, cfg.resolut, cfg.window)
        plan = sh.plan_frame_sharding(f, cfg.resolut, cfg.window, n_dev)
        encN = sh.sharded_mel_encode_fn(mesh, plan, cfg.num_mels, w)
        xpad = sh.pad_signal_for_plan(xb, plan)
        xpad2 = sh.pad_signal_for_plan(xb2, plan)
        t_encN = measure_throughput(encN, (xpad,), audio_s,
                                    n_devices=n_dev, alt_args=(xpad2,))
        glN = sh.sharded_griffin_lim_fn(mesh, plan,
                                        cfg.griffin_lim_iterations)
        mag = jnp.abs(jnp.asarray(rng.standard_normal(
            (b, plan.n_frames_padded, cfg.resolut // 2 + 1)), jnp.float32))
        mag2 = jnp.abs(jnp.asarray(rng.standard_normal(
            (b, plan.n_frames_padded, cfg.resolut // 2 + 1)), jnp.float32))
        sig0 = jnp.asarray(rng.uniform(size=(
            b, plan.n_frames_padded * cfg.window)), jnp.float32)
        t_glN = measure_throughput(glN, (mag, sig0), audio_s,
                                   n_devices=n_dev, alt_args=(mag2, sig0))
        # unsharded GL on the same padded magnitudes (identical total work)
        from gomel_tpu.ops.griffinlim import griffin_lim
        gl1 = jax.jit(jax.vmap(lambda m, k: griffin_lim(
            m, cfg.window, cfg.griffin_lim_iterations, k)))
        t_gl1 = measure_throughput(gl1, (mag, keys), audio_s,
                                   alt_args=(mag2, keys))

        report = {
            "mode": "overhead",
            "config": {"secs": args.secs, "batch": b,
                       "platform": devices[0].platform, "n_devices": n_dev},
            "encode": {"unsharded": t_enc1.json(),
                       "frame_sharded": t_encN.json(),
                       "overhead_fraction": round(
                           t_encN.wall_seconds / t_enc1.wall_seconds - 1, 4)},
            "griffin_lim": {"unsharded": t_gl1.json(),
                            "frame_sharded": t_glN.json(),
                            "overhead_fraction": round(
                                t_glN.wall_seconds / t_gl1.wall_seconds - 1,
                                4)},
            "decode_unsharded_reference": t_dec1.json(),
        }
        print(json.dumps(report, indent=2))
        return

    single = run(1)
    report = {
        "mode": args.mode,
        "config": {"secs": args.secs, "batch_per_device": args.batch_per_device,
                   "platform": devices[0].platform, "n_devices": n_dev},
        "single": single.json(),
    }
    if n_dev > 1:
        multi = run(n_dev)
        report["multi"] = multi.json()
        report["scaling_efficiency"] = round(
            scaling_efficiency(single, multi), 4)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
