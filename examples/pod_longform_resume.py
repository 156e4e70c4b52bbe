#!/usr/bin/env python
"""Pod long-form decode with elastic recovery — the checkpoint/resume recipe.

The production pattern for the hour-scale Griffin-Lim class of workloads
(SURVEY.md §5 "failure detection / elastic recovery"): frame-shard the audio
across the mesh, run the decode in preemption-safe segments, persist each
process's OWN shards after every segment (no host ever holds the full
signal), and — after a preemption kills the job — reassemble the carry on a
fresh bring-up and finish. With ``momentum=0`` the segmented run executes
the identical iteration sequence as a one-call decode, so the resumed
result is BIT-EQUAL (pipelines/longform.py).

Runnable anywhere: with GOMEL_FORCE_CPU=1 it simulates a pod with 8 virtual
CPU devices in one process, on a GPU host it uses the visible cards (the
same code runs unmodified on a real multi-host mesh — each process then
writes/reads only its own shard files; see
benchmarks/multiprocess_smoke.py --kill-drill for the real
SIGKILL-and-restart drill, and docs/MULTIHOST.md for bring-up).

    python examples/pod_longform_resume.py
"""
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
# GOMEL_FORCE_CPU (set by tests/test_examples.py) runs on the 8 virtual CPU
# devices; otherwise the example runs on the default backend, e.g. the GPU
if os.environ.get("GOMEL_FORCE_CPU"):
    jax.config.update("jax_platforms", "cpu")
import numpy as np


def main():
    from gomel_tpu.core.config import MelConfig
    from gomel_tpu.parallel.mesh import make_mesh
    from gomel_tpu.pipelines.longform import (LongFormMel,
                                              load_gl_checkpoint_sharded,
                                              prune_gl_checkpoints,
                                              save_gl_checkpoint_sharded)

    n_dev = len(jax.devices())
    mesh = make_mesh(data=1, frame=n_dev)
    print(f"mesh: 1 x {n_dev} (data x frame)")

    # a "long" input: every process of a real pod passes the identical host
    # batch (replicated-ingest model); here one process owns all shards
    cfg = MelConfig(num_mels=48, window=256, resolut=1024,
                    griffin_lim_iterations=16)
    x = np.random.default_rng(0).standard_normal((1, 120_000)).astype(
        np.float32)
    lfm = LongFormMel(cfg, mesh)
    logmel = lfm.encode(x)
    print(f"log-mel: {logmel.shape}")

    ckpt_dir = tempfile.mkdtemp(prefix="gomel-pod-gl-")

    # --- the serving job: segments + per-process sharded checkpoints -------
    class Preempted(Exception):
        pass

    def checkpoint(done_iters, carry):
        # every process persists the shards its devices own; the marker file
        # publishes only after all of this process's shards landed, so a
        # kill mid-save can never corrupt the previous checkpoint
        save_gl_checkpoint_sharded(ckpt_dir, done_iters, carry)
        prune_gl_checkpoints(ckpt_dir, keep_last=2)
        print(f"  checkpoint @ {done_iters} GL iterations")
        if done_iters == 8:
            raise Preempted  # stand-in for the pod preemption / SIGKILL

    try:
        lfm.decode_resumable(logmel, seed=0, segment_iters=4,
                             callback=checkpoint)
    except Preempted:
        print("preempted mid-decode (8/16 iterations done)")

    # --- the restarted job: fresh objects, reassemble, finish --------------
    # on a real pod this is a NEW process set after re-bring-up; every
    # process loads only the shard files its own devices need, and the
    # processes agree on the newest GLOBALLY-complete iteration (a
    # preemption that interrupted some saves rolls everyone back together)
    done, carry = load_gl_checkpoint_sharded(ckpt_dir, mesh)
    print(f"restart: resuming from iteration {done}")
    resumed = LongFormMel(cfg, mesh).decode_resumable(
        logmel, seed=0, segment_iters=4, resume=(done, carry))

    # momentum=0 guarantees the identical iteration sequence -> bit-equality
    one_call = LongFormMel(cfg, mesh).decode(logmel, seed=0)
    same = bool(np.array_equal(np.asarray(resumed), np.asarray(one_call)))
    print(f"resumed == uninterrupted one-call decode: {same}")
    assert same
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # the frontier recommendation for this workload class: momentum-0.99 at
    # 24 iterations matches plain GL-64 quality in 2.7x fewer iterations
    # (ops.griffinlim.recommended_gl)
    from gomel_tpu.ops.griffinlim import recommended_gl
    mom, iters = recommended_gl(64)
    print(f"serving tip: recommended_gl(64) -> momentum={mom}, "
          f"iterations={iters}")
    print("OK")


if __name__ == "__main__":
    main()
