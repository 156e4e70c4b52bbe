"""Real multi-process multihost smoke: ``jax.distributed`` bring-up + parity.

SURVEY.md §2.6 mandates a collective backend (``jax.distributed.initialize``
replacing a launcher+NCCL bootstrap). The virtual 8-device mesh used by the
test suite runs in ONE process, so it never exercises the actual bring-up,
cross-process device enumeration, or collectives that cross a process
boundary. This script does, on CPU, with no pod:

    python benchmarks/multiprocess_smoke.py              # launcher: spawns 2
    python benchmarks/multiprocess_smoke.py --process-id 0 --coordinator ...

Each worker process:
  1. calls ``gomel_tpu.parallel.mesh.initialize_multihost`` (the production
     bring-up path) against a local coordinator,
  2. checks global device enumeration (num_processes x local_devices),
  3. runs the frame-sharded direct iSTFT on a mesh whose FRAME axis spans
     both processes — the halo ``ppermute`` and the global window-sum
     ``pmax`` (parallel/sharded.py) cross the process boundary, standing in
     for DCN on a real pod,
  4. runs the sharded Griffin-Lim on a mesh whose DATA axis spans the
     processes (each process owns one batch row end to end),
  5. compares every locally-addressable output shard against a redundantly
     computed single-device reference, exact to the same tolerances as
     tests/test_sharded.py,
  6. drives the HIGH-LEVEL user-facing APIs (not the sharded_* builders)
     across the process boundary: ``LongFormPhase.encode/decode`` and
     ``LongFormMel.encode/decode`` with replicated host input, and
     ``BatchedMel.encode/decode`` with ``input_mode="process_local"`` fed by
     ``io.dataset.shard_files_for_process`` (each process contributes only
     its own rows), with shard-level parity against the single-chip
     pipelines.

tests/test_multiprocess.py runs the launcher form and asserts both workers
print the OK marker. Kept under benchmarks/ because it doubles as the
runnable multihost demo referenced by docs/MULTIHOST.md.

``--kill-drill`` is the real elastic-recovery drill:
phase A starts a fresh 2-process mesh running ``LongFormMel.decode_resumable``
with per-segment ``save_gl_checkpoint_sharded`` checkpoints, the launcher
delivers an uncatchable SIGKILL to worker 1's exact PID right after the first
globally-complete checkpoint lands (a genuine unclean death: no atexit, no
distributed shutdown — worker 0 subsequently fails or hangs in the next
cross-process collective and is reaped by the launcher), and phase B brings
up two FRESH processes on a NEW coordinator, reassembles the carry via
``load_gl_checkpoint_sharded`` (global-min agreement across the restarted
mesh), resumes, and asserts the result is bit-equal to an uninterrupted run
(momentum=0 executes the identical iteration sequence, longform.py).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRAME_LEN, HOP, BATCH = 256, 64, 2
N_FRAMES_SIGNAL = FRAME_LEN + 41 * HOP  # same shape class as tests/test_sharded.py

OK_MARKER = "MULTIHOST-SMOKE OK"


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process-id", type=int, default=None,
                    help="worker mode; omit to self-launch all workers")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (worker mode)")
    ap.add_argument("--local-devices", type=int, default=4,
                    help="virtual CPU devices per process")
    ap.add_argument("--measure-overhead", action="store_true",
                    help="measure cross-process sharding overhead at fixed "
                         "total work instead of running the parity checks")
    ap.add_argument("--four-proc", action="store_true",
                    help="with --measure-overhead: also measure the "
                         "4-process leg (same 8 global devices)")
    ap.add_argument("--kill-drill", action="store_true",
                    help="launcher: run the SIGKILL + restart + resume "
                         "elastic-recovery drill")
    ap.add_argument("--kill-drill-phase", choices=("run", "resume"),
                    default=None, help="worker mode for the kill drill")
    ap.add_argument("--ckpt-dir", default=None,
                    help="sharded-checkpoint directory (kill drill workers)")
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(num_processes: int, local_devices: int) -> int:
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--process-id", str(i), "--num-processes", str(num_processes),
             "--coordinator", coord, "--local-devices", str(local_devices)],
            env=env, cwd=REPO_ROOT)
        for i in range(num_processes)
    ]
    rc = 0
    for p in procs:
        rc = max(rc, p.wait())
    return rc


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

def _global_array(arr, mesh, spec):
    """Build a process-spanning global jax.Array from an identical host copy
    (every worker computes the same seeded input redundantly)."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def _check_shards(got, want, valid_len: int, atol: float, label: str,
                  pid: int) -> None:
    """Compare every addressable shard of the global output against the
    single-device reference, ignoring the padded tail past ``valid_len``."""
    import numpy as np

    checked = 0
    for s in got.addressable_shards:
        data = np.asarray(s.data)
        b_sl, t_sl = s.index
        t0 = t_sl.start or 0
        t1 = t_sl.stop if t_sl.stop is not None else got.shape[1]
        t1 = min(t1, valid_len)
        if t1 <= t0:
            continue
        np.testing.assert_allclose(data[:, : t1 - t0], want[b_sl, t0:t1],
                                   atol=atol, rtol=atol, err_msg=label)
        checked += 1
    if checked == 0:
        raise AssertionError(f"{label}: no addressable shard held real output")
    print(f"[p{pid}] parity ok: {label} ({checked} local shards)", flush=True)


def run_worker(args) -> None:
    # Fresh XLA_FLAGS (replace, not append — the parent may carry the test
    # suite's 8-device flag) before any JAX import.
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.local_devices}")
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)

    import jax
    jax.config.update("jax_platforms", "cpu")  # CPU + gloo by design
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from gomel_tpu.core.framing import num_frames
    from gomel_tpu.ops.stft import stft, hann_window
    from gomel_tpu.ops.istft import istft_direct
    from gomel_tpu.ops.griffinlim import griffin_lim
    from gomel_tpu.parallel import sharded as sh
    from gomel_tpu.parallel.mesh import (DATA_AXIS, FRAME_AXIS,
                                         initialize_multihost, is_multihost,
                                         make_mesh)

    pid = args.process_id
    # the data-axis section shards the batch over num_processes positions
    BATCH = max(2, args.num_processes)
    initialize_multihost(args.coordinator, args.num_processes, pid)
    assert jax.process_count() == args.num_processes, jax.process_count()
    assert jax.local_device_count() == args.local_devices
    assert is_multihost()
    n = jax.device_count()
    assert n == args.num_processes * args.local_devices
    print(f"[p{pid}] bring-up ok: {jax.process_count()} processes, "
          f"{n} global devices", flush=True)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, N_FRAMES_SIGNAL)).astype(np.float32)
    f = num_frames(N_FRAMES_SIGNAL, FRAME_LEN, HOP)
    win = jnp.asarray(hann_window(FRAME_LEN), jnp.float32)
    spec = np.asarray(jax.vmap(
        lambda s: stft(jnp.asarray(s), FRAME_LEN, HOP))(jnp.asarray(x)))

    # --- 1. frame axis spans the processes: cross-process halo + pmax ------
    mesh_f = make_mesh(data=1, frame=n)
    plan_f = sh.plan_frame_sharding(f, FRAME_LEN, HOP, n)
    spec_pad = np.zeros((BATCH, plan_f.n_frames_padded, spec.shape[2]),
                        spec.dtype)
    spec_pad[:, :f] = spec
    spec_g = _global_array(spec_pad, mesh_f, P(DATA_AXIS, FRAME_AXIS, None))
    want = np.asarray(jax.vmap(
        lambda s: istft_direct(jnp.asarray(s), HOP, win))(jnp.asarray(spec)))
    got = sh.sharded_istft_fn(mesh_f, plan_f)(spec_g)
    got.block_until_ready()
    _check_shards(got, want, plan_f.out_len, 1e-4,
                  f"frame-axis iSTFT across {args.num_processes} processes",
                  pid)

    # --- 2. data axis spans the processes: one batch row per process -------
    mesh_d = make_mesh(data=args.num_processes,
                       frame=n // args.num_processes)
    plan_d = sh.plan_frame_sharding(f, FRAME_LEN, HOP,
                                    n // args.num_processes)
    mag = np.abs(spec)
    mag_pad = np.zeros((BATCH, plan_d.n_frames_padded, mag.shape[2]),
                       mag.dtype)
    mag_pad[:, :f] = mag
    init = np.random.default_rng(7).random(
        (BATCH, plan_d.sharded_signal_len)).astype(np.float32)
    want_gl = np.asarray(jax.vmap(lambda m, s0: griffin_lim(
        jnp.asarray(m), HOP, 3, jax.random.PRNGKey(0), win,
        init=jnp.asarray(s0[: plan_d.out_len])))(jnp.asarray(mag),
                                                 jnp.asarray(init)))
    mag_g = _global_array(mag_pad, mesh_d, P(DATA_AXIS, FRAME_AXIS, None))
    init_g = _global_array(init, mesh_d, P(DATA_AXIS, FRAME_AXIS))
    got_gl = sh.sharded_griffin_lim_fn(mesh_d, plan_d, 3)(mag_g, init_g)
    got_gl.block_until_ready()
    _check_shards(got_gl, want_gl, plan_d.out_len, 2e-3,
                  f"data-axis Griffin-Lim across {args.num_processes} "
                  "processes", pid)

    # --- 3. HIGH-LEVEL APIs across the process boundary ----
    def _check_global(got, want, atol, label):
        """Every addressable shard of an already-trimmed global result must
        equal the corresponding slice of the redundant reference."""
        checked = 0
        for s in got.addressable_shards:
            data = np.asarray(s.data)
            if data.size == 0:
                continue
            np.testing.assert_allclose(data, want[s.index], atol=atol,
                                       rtol=atol, err_msg=label)
            checked += 1
        assert checked > 0, f"{label}: no addressable shard held output"
        print(f"[p{pid}] parity ok: {label} ({checked} local shards)",
              flush=True)

    from gomel_tpu.core.config import MelConfig, PhaseConfig
    from gomel_tpu.core.framing import pad_length
    from gomel_tpu.io.dataset import shard_files_for_process
    from gomel_tpu.ops.mel_ops import mel_encode
    from gomel_tpu.core.filterbank import mel_weights
    from gomel_tpu.parallel.batch import BatchedMel, local_rows
    from gomel_tpu.pipelines.longform import LongFormMel, LongFormPhase
    from gomel_tpu.pipelines.mel import Mel
    from gomel_tpu.pipelines.phase import Phase

    CFG = dict(window=HOP, resolut=FRAME_LEN)

    # 3a. LongFormPhase: replicated host input, frame axis spans processes
    pcfg = PhaseConfig(num_freqs=96, **CFG)
    lfp = LongFormPhase(pcfg, mesh_f)
    single_p = Phase(pcfg)
    spec_lf = lfp.encode(x)
    want_spec_lf = np.stack(
        [np.asarray(single_p.encode(x[i])) for i in range(BATCH)])
    _check_global(spec_lf, want_spec_lf, 1e-4,
                  f"LongFormPhase.encode across {args.num_processes} "
                  "processes")
    dec_lf = lfp.decode(spec_lf)  # global-array input path
    want_dec_lf = np.stack(
        [np.asarray(single_p.decode(want_spec_lf[i])) for i in range(BATCH)])
    _check_global(dec_lf, want_dec_lf[:, : dec_lf.shape[1]], 1e-3,
                  f"LongFormPhase.decode across {args.num_processes} "
                  "processes")

    # 3b. LongFormMel: encode parity; decode runs sharded Griffin-Lim with
    # per-shard noise init (no single-chip bit-parity by construction —
    # check determinism + finiteness through the high-level API instead)
    mcfg = MelConfig(num_mels=24, griffin_lim_iterations=3, **CFG)
    lfm = LongFormMel(mcfg, mesh_f)
    single_m = Mel(mcfg)
    logmel = lfm.encode(x)
    want_logmel = np.stack(
        [np.asarray(single_m.encode(x[i])) for i in range(BATCH)])
    _check_global(logmel, want_logmel, 1e-4,
                  f"LongFormMel.encode across {args.num_processes} "
                  "processes")
    gl_a = lfm.decode(logmel, seed=0)
    gl_b = lfm.decode(logmel, seed=0)
    for sa, sb in zip(gl_a.addressable_shards, gl_b.addressable_shards):
        da, db = np.asarray(sa.data), np.asarray(sb.data)
        assert np.isfinite(da).all()
        np.testing.assert_array_equal(da, db)
    print(f"[p{pid}] LongFormMel.decode: sharded Griffin-Lim deterministic "
          "and finite across processes", flush=True)

    # 3c. BatchedMel with process-local ingest: each process encodes ONLY the
    # files its shard_files_for_process slice assigns to it
    all_files = [f"utt{i:02d}" for i in range(2 * args.num_processes)]
    mine = shard_files_for_process(all_files)
    assert len(mine) == 2 and all(
        int(f[3:]) % args.num_processes == pid for f in mine)

    def synth(name: str) -> np.ndarray:  # deterministic per-file audio
        r = np.random.default_rng(1000 + int(name[3:]))
        return r.standard_normal(
            pad_length(FRAME_LEN + 17 * HOP, HOP)).astype(np.float32)

    local_batch = np.stack([synth(f) for f in mine])
    bm = BatchedMel(mcfg, mesh=mesh_d, input_mode="process_local")
    enc_g = bm.encode(local_batch)
    got_rows = local_rows(enc_g, len(mine))
    want_rows = np.stack(
        [np.asarray(single_m.encode(synth(f))) for f in mine])
    np.testing.assert_allclose(got_rows[:, : want_rows.shape[1]], want_rows,
                               atol=1e-4, rtol=1e-4)
    print(f"[p{pid}] parity ok: BatchedMel.encode(process_local) — "
          f"{len(mine)} local rows via shard_files_for_process", flush=True)
    dec_g = bm.decode(enc_g, seed=0)
    dec_rows = local_rows(dec_g, len(mine))
    assert np.isfinite(dec_rows).all() and dec_rows.shape[0] == len(mine)
    print(f"[p{pid}] BatchedMel.decode(process_local) ran end to end",
          flush=True)

    # 3d. elastic recovery across the process boundary: every process
    # persists ITS shards mid-decode, a simulated preemption aborts the run,
    # fresh pipeline objects reassemble the carry and finish — bit-equal to
    # the uninterrupted run (pipelines.longform sharded checkpointing)
    import tempfile

    from gomel_tpu.pipelines.longform import (load_gl_checkpoint_sharded,
                                              save_gl_checkpoint_sharded)

    ckpt_dir = os.path.join(tempfile.gettempdir(),
                            f"gomel-elastic-{args.coordinator.split(':')[1]}")
    mcfg6 = MelConfig(num_mels=24, griffin_lim_iterations=6, **CFG)
    lfm6 = LongFormMel(mcfg6, mesh_f)
    logmel6 = lfm6.encode(x)
    want_gl6 = lfm6.decode_resumable(logmel6, seed=0, segment_iters=3)
    want_shards = {str(s.index): np.asarray(s.data)
                   for s in want_gl6.addressable_shards}

    class _Preempted(Exception):
        pass

    def _cb(done_iters, carry):
        save_gl_checkpoint_sharded(ckpt_dir, done_iters, carry)
        if done_iters == 3:
            raise _Preempted

    try:
        LongFormMel(mcfg6, mesh_f).decode_resumable(
            logmel6, seed=0, segment_iters=3, callback=_cb)
        raise AssertionError("preemption did not fire")
    except _Preempted:
        pass
    done_iters, carry = load_gl_checkpoint_sharded(ckpt_dir, mesh_f)
    assert done_iters == 3
    resumed = LongFormMel(mcfg6, mesh_f).decode_resumable(
        logmel6, seed=0, segment_iters=3, resume=(done_iters, carry))
    for s in resumed.addressable_shards:
        np.testing.assert_array_equal(np.asarray(s.data),
                                      want_shards[str(s.index)])
    print(f"[p{pid}] elastic recovery ok: per-process shard checkpoints, "
          "resume bit-equal across the process boundary", flush=True)

    # --- 3e. 2x2 mesh: BOTH axes cross the process boundary (np >= 4) ------
    # data=2 x frame=2, so each data block is co-owned by
    # a GROUP of processes (frame halves) — the ingest model generalized by
    # parallel.mesh.data_group_for_process / io.dataset.shard_files_for_group.
    if args.num_processes >= 4 and n % 2 == 0:
        from gomel_tpu.io.dataset import shard_files_for_group
        from gomel_tpu.parallel.mesh import data_group_for_process

        mesh_22 = make_mesh(data=2, frame=n // 2)
        lfm22 = LongFormMel(mcfg, mesh_22)
        logmel22 = lfm22.encode(x)
        _check_global(logmel22, want_logmel, 1e-4,
                      f"LongFormMel.encode on the 2x2 mesh across "
                      f"{args.num_processes} processes (data AND frame axes "
                      "cross processes)")

        gi, ng = data_group_for_process(mesh_22)
        assert ng == 2 and gi == (pid * 2) // args.num_processes, (gi, ng)
        files22 = [f"utt{i:02d}" for i in range(2 * ng)]
        mine22 = shard_files_for_group(files22, mesh_22)
        assert len(mine22) == 2 and all(
            int(f[3:]) % ng == gi for f in mine22), mine22
        local22 = np.stack([synth(f) for f in mine22])
        bm22 = BatchedMel(mcfg, mesh=mesh_22, input_mode="process_local")
        enc22 = bm22.encode(local22)
        got22 = local_rows(enc22, len(mine22))
        want22 = np.stack(
            [np.asarray(single_m.encode(synth(f))) for f in mine22])
        np.testing.assert_allclose(got22[:, : want22.shape[1]], want22,
                                   atol=1e-4, rtol=1e-4)
        print(f"[p{pid}] parity ok: BatchedMel.encode(process_local) on the "
              f"2x2 mesh — group {gi}/{ng} via shard_files_for_group",
              flush=True)

    print(f"{OK_MARKER} process {pid}/{args.num_processes}: {n} global "
          "devices, cross-process halo exchange + global pmax verified, "
          "high-level LongForm/Batched APIs verified across processes",
          flush=True)


# ---------------------------------------------------------------------------
# Cross-process sharding overhead
# ---------------------------------------------------------------------------
#
# Fixed TOTAL work, unsharded-in-one-process vs frame-sharded across the
# 2-process mesh. All virtual devices time-slice the same physical cores, so
# a wall-clock speedup is unmeasurable here; what IS measurable is the
# sharding OVERHEAD (gloo collectives crossing the OS-process boundary, halo
# exchange, padding skew): T_sharded / T_unsharded - 1 at equal total work.
# Combined with the docs/SCALING.md ICI cost model this bounds real-pod
# efficiency from below: eff >= 1 / (1 + overhead_fraction).

OH_FRAME_LEN, OH_HOP, OH_BATCH, OH_FRAMES = 1024, 320, 2, 1200
OH_ITERS, OH_TRIALS, OH_GL_ITERS = 5, 3, 4


def _timed_fixed(fn, argsets, iters, trials):
    """Best-of-trials wall time for a FIXED iteration count — every process
    must dispatch the identical sequence of global programs (an adaptively
    chosen count would diverge across processes and deadlock)."""
    import time
    import jax

    out = fn(*argsets[0])
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for i in range(iters):
            out = fn(*argsets[i % len(argsets)])
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best / iters


def run_overhead_worker(args) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.local_devices}")
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    import json

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from gomel_tpu.core.config import MelConfig
    from gomel_tpu.core.filterbank import mel_weights
    from gomel_tpu.ops.mel_ops import mel_encode
    from gomel_tpu.ops.griffinlim import griffin_lim
    from gomel_tpu.ops.stft import hann_window
    from gomel_tpu.parallel import sharded as sh
    from gomel_tpu.parallel.mesh import initialize_multihost, make_mesh

    pid = args.process_id
    initialize_multihost(args.coordinator, args.num_processes, pid)
    n = jax.device_count()
    cfg = MelConfig(num_mels=64, window=OH_HOP, resolut=OH_FRAME_LEN)
    w = mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin, cfg.mel_fmax)
    plan = sh.plan_frame_sharding(OH_FRAMES, OH_FRAME_LEN, OH_HOP,
                                  max(n, 1) if args.num_processes > 1 else 1)
    rng = np.random.default_rng(0)
    sig = rng.standard_normal(
        (OH_BATCH, plan.sharded_signal_len)).astype(np.float32)
    sig2 = rng.standard_normal(sig.shape).astype(np.float32)
    mag = np.abs(rng.standard_normal(
        (OH_BATCH, plan.n_frames_padded,
         OH_FRAME_LEN // 2 + 1))).astype(np.float32)
    mag2 = np.abs(rng.standard_normal(mag.shape)).astype(np.float32)
    init = rng.random((OH_BATCH, plan.sharded_signal_len)).astype(np.float32)

    if args.num_processes == 1:
        # unsharded single-device baseline at the SAME total work
        wj = jnp.asarray(w, jnp.float32)
        win = jnp.asarray(hann_window(OH_FRAME_LEN), jnp.float32)
        enc1 = jax.jit(jax.vmap(lambda x: mel_encode(
            x, cfg.num_mels, OH_FRAME_LEN, OH_HOP, wj, win)))
        # same padded magnitudes as the sharded run = identical total work
        gl1 = jax.jit(jax.vmap(lambda m: griffin_lim(
            m, OH_HOP, OH_GL_ITERS, jax.random.PRNGKey(0), win)))
        t_enc = _timed_fixed(enc1, [(jnp.asarray(sig),), (jnp.asarray(sig2),)],
                             OH_ITERS, OH_TRIALS)
        t_gl = _timed_fixed(
            gl1, [(jnp.asarray(mag),), (jnp.asarray(mag2),)],
            OH_ITERS, OH_TRIALS)
        print("OVERHEAD-BASELINE " + json.dumps(
            {"encode_s": t_enc, "griffin_lim_s": t_gl}), flush=True)
        return

    mesh = make_mesh(data=1, frame=n)
    encN = sh.sharded_mel_encode_fn(mesh, plan, cfg.num_mels, w)
    glN = sh.sharded_griffin_lim_fn(mesh, plan, OH_GL_ITERS)
    from jax.sharding import PartitionSpec as P
    from gomel_tpu.parallel.mesh import DATA_AXIS, FRAME_AXIS, host_to_global
    sig_g = host_to_global(sig, mesh, P(DATA_AXIS, FRAME_AXIS))
    sig2_g = host_to_global(sig2, mesh, P(DATA_AXIS, FRAME_AXIS))
    mag_g = host_to_global(mag, mesh, P(DATA_AXIS, FRAME_AXIS, None))
    mag2_g = host_to_global(mag2, mesh, P(DATA_AXIS, FRAME_AXIS, None))
    init_g = host_to_global(init, mesh, P(DATA_AXIS, FRAME_AXIS))
    t_enc = _timed_fixed(encN, [(sig_g,), (sig2_g,)], OH_ITERS, OH_TRIALS)
    t_gl = _timed_fixed(glN, [(mag_g, init_g), (mag2_g, init_g)],
                        OH_ITERS, OH_TRIALS)
    if pid == 0:
        print("OVERHEAD-SHARDED " + json.dumps(
            {"encode_s": t_enc, "griffin_lim_s": t_gl,
             "n_devices": n, "n_processes": args.num_processes}), flush=True)


# ---------------------------------------------------------------------------
# Elastic-recovery kill drill: SIGKILL + restart + resume
# ---------------------------------------------------------------------------

KD_GL_ITERS, KD_SEGMENT_ITERS, KD_NUM_MELS = 12, 3, 24
KD_RESUME_MARKER = "KILL-DRILL-RESUME OK"
KD_OK_MARKER = "KILL-DRILL OK"


def _kd_setup(args):
    """Shared kill-drill worker bring-up: mesh, deterministic input, encoder.

    Both phases (and both the interrupted and the uninterrupted run) derive
    the IDENTICAL logmel from the same seeded signal, so bit-equality of the
    decodes is meaningful across the process restart."""
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.local_devices}")
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from gomel_tpu.core.config import MelConfig
    from gomel_tpu.parallel.mesh import initialize_multihost, make_mesh
    from gomel_tpu.pipelines.longform import LongFormMel

    initialize_multihost(args.coordinator, args.num_processes,
                         args.process_id)
    mesh = make_mesh(data=1, frame=jax.device_count())
    cfg = MelConfig(num_mels=KD_NUM_MELS, griffin_lim_iterations=KD_GL_ITERS,
                    window=HOP, resolut=FRAME_LEN)
    x = np.random.default_rng(0).standard_normal(
        (BATCH, N_FRAMES_SIGNAL)).astype(np.float32)
    lfm = LongFormMel(cfg, mesh)
    logmel = lfm.encode(x)
    return jax, np, mesh, cfg, lfm, logmel


def run_kill_drill_run_worker(args) -> None:
    """Phase A worker: resumable decode with per-segment sharded checkpoints.
    Worker 1 is SIGKILLed by the launcher mid-run; worker 0 then fails or
    hangs in the next cross-process collective and is reaped."""
    import time
    jax, np, mesh, cfg, lfm, logmel = _kd_setup(args)
    from gomel_tpu.pipelines.longform import save_gl_checkpoint_sharded

    def cb(done, carry):
        save_gl_checkpoint_sharded(args.ckpt_dir, done, carry)
        # widen the launcher's kill window so the SIGKILL deterministically
        # lands mid-run (pod segments are minutes; these test shapes are ms)
        time.sleep(0.75)

    out = lfm.decode_resumable(logmel, seed=0,
                               segment_iters=KD_SEGMENT_ITERS, callback=cb)
    jax.block_until_ready(out)
    # only reached if the launcher failed to interrupt the run
    print(f"KILL-DRILL-RUN FINISHED p{args.process_id}", flush=True)


def run_kill_drill_resume_worker(args) -> None:
    """Phase B worker (fresh process, NEW coordinator): reassemble the carry
    from the per-process shard files (global-min agreement), finish the
    decode, and assert bit-equality with an uninterrupted run."""
    jax, np, mesh, cfg, lfm, logmel = _kd_setup(args)
    from gomel_tpu.pipelines.longform import (LongFormMel,
                                              load_gl_checkpoint_sharded)

    done, carry = load_gl_checkpoint_sharded(args.ckpt_dir, mesh)
    assert 0 < done < KD_GL_ITERS and done % KD_SEGMENT_ITERS == 0, done
    resumed = lfm.decode_resumable(logmel, seed=0,
                                   segment_iters=KD_SEGMENT_ITERS,
                                   resume=(done, carry))
    want = LongFormMel(cfg, mesh).decode_resumable(
        logmel, seed=0, segment_iters=KD_SEGMENT_ITERS)
    checked = 0
    for sr, sw in zip(resumed.addressable_shards, want.addressable_shards):
        assert sr.index == sw.index
        np.testing.assert_array_equal(np.asarray(sr.data),
                                      np.asarray(sw.data))
        checked += 1
    assert checked > 0
    print(f"{KD_RESUME_MARKER} p{args.process_id} resumed_from_iter={done} "
          f"({checked} local shards bit-equal)", flush=True)


def launch_kill_drill(local_devices: int) -> int:
    import json
    import shutil
    import tempfile
    import time

    ckpt_dir = tempfile.mkdtemp(prefix="gomel-kill-drill-")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)

    def spawn(phase: str, coord: str, **popen_kw):
        return [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--kill-drill-phase", phase, "--ckpt-dir", ckpt_dir,
                 "--process-id", str(i), "--num-processes", "2",
                 "--coordinator", coord,
                 "--local-devices", str(local_devices)],
                env=env, cwd=REPO_ROOT, **popen_kw)
            for i in range(2)
        ]

    # --- phase A: run + SIGKILL worker 1 after the first complete ckpt ----
    procs = spawn("run", f"127.0.0.1:{_free_port()}")
    first = os.path.join(ckpt_dir, f"iter_{KD_SEGMENT_ITERS:08d}")
    deadline = time.time() + 300
    interrupted = False
    while time.time() < deadline:
        if (os.path.exists(os.path.join(first, "COMPLETE.p0"))
                and os.path.exists(os.path.join(first, "COMPLETE.p1"))):
            procs[1].kill()  # SIGKILL the exact victim PID, mid-run
            interrupted = True
            break
        if any(p.poll() is not None for p in procs):
            break  # a worker ended before the first checkpoint: drill broken
        time.sleep(0.05)
    if not interrupted:
        for p in procs:
            p.kill()
        raise SystemExit("kill-drill: no complete checkpoint appeared — "
                         "nothing to interrupt")
    victim_rc = procs[1].wait()
    try:  # the survivor fails or hangs in its next cross-process collective
        survivor_rc = procs[0].wait(timeout=180)
        survivor_reaped = False
    except subprocess.TimeoutExpired:
        procs[0].kill()
        survivor_rc = procs[0].wait()
        survivor_reaped = True

    # --- phase B: FRESH processes, NEW coordinator, reassemble + resume ---
    procs2 = spawn("resume", f"127.0.0.1:{_free_port()}",
                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                   text=True)
    out = ""
    rc = 0
    for p in procs2:
        stdout, _ = p.communicate(timeout=300)
        out += stdout
        rc = max(rc, p.returncode)
    sys.stdout.write(out)
    if rc != 0 or out.count(KD_RESUME_MARKER) != 2:
        raise SystemExit(f"kill-drill resume failed rc={rc}:\n{out}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(KD_OK_MARKER + " " + json.dumps({
        "victim_rc": victim_rc, "survivor_rc": survivor_rc,
        "survivor_reaped_by_launcher": survivor_reaped,
        "resumed_processes": 2}), flush=True)
    return 0


def _launch_capture(num_processes: int, local_devices: int) -> str:
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--measure-overhead",
             "--process-id", str(i), "--num-processes", str(num_processes),
             "--coordinator", coord, "--local-devices", str(local_devices)],
            env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE, text=True)
        for i in range(num_processes)
    ]
    out = ""
    for p in procs:
        stdout, _ = p.communicate()
        out += stdout
        if p.returncode != 0:
            raise SystemExit(f"overhead worker failed rc={p.returncode}")
    return out


def launch_overhead(local_devices: int, four_proc: bool = False) -> int:
    import json
    base = json.loads(_launch_capture(1, 1).split(
        "OVERHEAD-BASELINE ", 1)[1].splitlines()[0])
    shard = json.loads(_launch_capture(2, local_devices).split(
        "OVERHEAD-SHARDED ", 1)[1].splitlines()[0])
    report = {
        "mode": "cross_process_overhead",
        "fixed_total_work": {"batch": OH_BATCH, "frames": OH_FRAMES,
                             "frame_len": OH_FRAME_LEN, "hop": OH_HOP,
                             "gl_iters": OH_GL_ITERS},
        "unsharded_1proc": base,
        "sharded_2proc": shard,
        "encode_overhead_fraction": round(
            shard["encode_s"] / base["encode_s"] - 1, 4),
        "griffin_lim_overhead_fraction": round(
            shard["griffin_lim_s"] / base["griffin_lim_s"] - 1, 4),
    }
    if four_proc:
        # same 8 global devices, 4 process boundaries instead of 2
        #
        shard4 = json.loads(_launch_capture(4, max(local_devices // 2, 1))
                            .split("OVERHEAD-SHARDED ", 1)[1].splitlines()[0])
        report["sharded_4proc"] = shard4
        report["encode_overhead_fraction_4proc"] = round(
            shard4["encode_s"] / base["encode_s"] - 1, 4)
        report["griffin_lim_overhead_fraction_4proc"] = round(
            shard4["griffin_lim_s"] / base["griffin_lim_s"] - 1, 4)
    print(json.dumps(report, indent=2))
    return 0


def main(argv=None) -> int:
    args = _parse(argv)
    if args.process_id is None:
        if args.kill_drill:
            return launch_kill_drill(args.local_devices)
        if args.measure_overhead:
            return launch_overhead(args.local_devices, args.four_proc)
        return launch(args.num_processes, args.local_devices)
    if args.coordinator is None:
        raise SystemExit("--coordinator is required in worker mode")
    if args.kill_drill_phase is not None:
        if args.ckpt_dir is None:
            raise SystemExit("--ckpt-dir is required for kill-drill workers")
        if args.kill_drill_phase == "run":
            run_kill_drill_run_worker(args)
        else:
            run_kill_drill_resume_worker(args)
        return 0
    if args.measure_overhead:
        run_overhead_worker(args)
        return 0
    run_worker(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
