"""Real multi-process ``jax.distributed`` bring-up (SURVEY.md §2.6 item 3).

Everything else in the suite runs the 8-device virtual mesh inside ONE
process; this is the one test where collectives actually cross a process
boundary: two workers each own 4 CPU devices, form one 8-device global mesh
through ``gomel_tpu.parallel.mesh.initialize_multihost``, and run the
frame-sharded iSTFT (halo ppermute + global pmax across the boundary) and
the data-sharded Griffin-Lim with shard-level parity checks. The worker
logic lives in benchmarks/multiprocess_smoke.py (doubles as the runnable
multihost demo, docs/MULTIHOST.md).
"""
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO_ROOT, "benchmarks", "multiprocess_smoke.py")


def test_two_process_bringup_and_parity():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers pick their own device count
    proc = subprocess.run(
        [sys.executable, SMOKE, "--num-processes", "2"],
        capture_output=True, text=True, timeout=540, env=env, cwd=REPO_ROOT)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert out.count("MULTIHOST-SMOKE OK") == 2, out
    assert "frame-axis iSTFT across 2 processes" in out, out
    assert "data-axis Griffin-Lim across 2 processes" in out, out
    # high-level user-facing APIs (not the sharded_* builders) across the
    # process boundary
    for marker in ("LongFormPhase.encode across 2 processes",
                   "LongFormPhase.decode across 2 processes",
                   "LongFormMel.encode across 2 processes",
                   "BatchedMel.encode(process_local)",
                   "elastic recovery ok"):
        assert out.count(marker) == 2, (marker, out)


def test_four_process_2x2():
    """Four-process bring-up with a 2x2 ``(data, frame)`` mesh where BOTH
    axes cross process boundaries: full parity suite at
    4 processes plus process-GROUP local ingest (shard_files_for_group /
    data_group_for_process — two processes co-own each data block)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, SMOKE, "--num-processes", "4",
         "--local-devices", "1"],
        capture_output=True, text=True, timeout=540, env=env, cwd=REPO_ROOT)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert out.count("MULTIHOST-SMOKE OK") == 4, out
    for marker in ("LongFormMel.encode on the 2x2 mesh across 4 processes",
                   "BatchedMel.encode(process_local) on the 2x2 mesh",
                   "elastic recovery ok"):
        assert out.count(marker) == 4, (marker, out)
    # the two ingest groups must both appear (processes 0,1 -> group 0;
    # processes 2,3 -> group 1)
    assert out.count("group 0/2 via shard_files_for_group") == 2, out
    assert out.count("group 1/2 via shard_files_for_group") == 2, out


def test_kill_drill_elastic_recovery():
    """Real elastic-recovery drill: SIGKILL one worker of
    a live 2-process jax.distributed mesh mid-decode_resumable, then bring up
    two FRESH processes on a new coordinator, reassemble the carry from the
    per-process sharded checkpoints (load_gl_checkpoint_sharded global-min
    agreement), resume, and require bit-equality with an uninterrupted run."""
    import json
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, SMOKE, "--kill-drill"],
        capture_output=True, text=True, timeout=540, env=env, cwd=REPO_ROOT)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert out.count("KILL-DRILL-RESUME OK") == 2, out
    assert "KILL-DRILL OK" in out, out
    report = json.loads(out.split("KILL-DRILL OK ", 1)[1].splitlines()[0])
    assert report["victim_rc"] == -9, report  # a genuine SIGKILL death
    assert report["resumed_processes"] == 2, report


def test_cross_process_overhead():
    """Fixed-total-work sharding overhead across a real 2-process bring-up
    (CPU, gloo). CI-noise-tolerant: the guard only requires cross-process
    overhead to stay below +50%. The measurement oversubscribes a small
    host (2 workers x 4 CPU devices), so an unrelated co-running process
    can blow the wall-clock ratio past the bound; retry up to 3 attempts
    before declaring a real regression."""
    import json
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    report = None
    for attempt in range(3):
        proc = subprocess.run(
            [sys.executable, SMOKE, "--measure-overhead"],
            capture_output=True, text=True, timeout=540, env=env,
            cwd=REPO_ROOT)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        report = json.loads(proc.stdout[proc.stdout.index("{"):])
        assert report["sharded_2proc"]["n_processes"] == 2, report
        if (report["encode_overhead_fraction"] < 0.5
                and report["griffin_lim_overhead_fraction"] < 0.5):
            return
    assert report["encode_overhead_fraction"] < 0.5, report
    assert report["griffin_lim_overhead_fraction"] < 0.5, report
