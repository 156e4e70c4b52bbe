"""Sharding-overhead guard on the 8-device virtual mesh.

True pod scaling efficiency cannot be measured here (the 8 virtual CPU
devices time-slice the same 4 host cores — weak scaling measures core
contention, not communication). What IS measurable and meaningful is the
sharding OVERHEAD at fixed total work: T_sharded / T_unsharded - 1 contains
the halo exchanges, collectives, and padding skew that a multi-card run
would pay. docs/SCALING.md combines this with the analytic NVLink model
(benchmarks/scaling.py --mode overhead measures it).

This test pins the overhead to a generous CI-safe bound: a pathological
regression (e.g. a full-signal all-gather sneaking into the per-iteration
loop) blows past 1.0 immediately; normal runs measure ~0.1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gomel_tpu.core.config import MelConfig
from gomel_tpu.core.framing import num_frames, pad_length
from gomel_tpu.ops.griffinlim import griffin_lim
from gomel_tpu.parallel import sharded as sh
from gomel_tpu.parallel.mesh import make_mesh
from gomel_tpu.utils.metrics import measure_throughput


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_griffin_lim_overhead_bounded():
    cfg = MelConfig.cli_default()
    n_dev = 8
    sr = 48000
    n = pad_length(int(sr * 6.0), cfg.window)
    f = num_frames(n, cfg.resolut, cfg.window)
    plan = sh.plan_frame_sharding(f, cfg.resolut, cfg.window, n_dev)
    mesh = make_mesh(data=1, frame=n_dev, devices=jax.devices()[:n_dev])

    rng = np.random.default_rng(0)
    mag = jnp.abs(jnp.asarray(rng.standard_normal(
        (1, plan.n_frames_padded, cfg.resolut // 2 + 1)), jnp.float32))
    sig0 = jnp.asarray(rng.uniform(
        size=(1, plan.n_frames_padded * cfg.window)), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 1)

    glN = sh.sharded_griffin_lim_fn(mesh, plan, 2, dtype=jnp.float32)
    gl1 = jax.jit(jax.vmap(
        lambda m, k: griffin_lim(m.astype(jnp.float32), cfg.window, 2, k)))

    # Wall-clock measurement on a shared CI core: under full-suite load a
    # single sample can blow the bound spuriously (observed: best-of-3 all
    # bad once in a full-suite run, fine alone), so take the best of 6
    # attempts — a genuine regression (per-iteration all-gather) fails all.
    overhead = float("inf")
    for _ in range(6):
        t1 = measure_throughput(gl1, (mag, keys), 1.0, min_seconds=0.3)
        tN = measure_throughput(glN, (mag, sig0), 1.0, min_seconds=0.3,
                                n_devices=n_dev)
        overhead = min(overhead, tN.wall_seconds / t1.wall_seconds - 1.0)
        if overhead < 1.0:
            break
    assert overhead < 1.0, f"sharding overhead {overhead:.2f} exceeds bound"
