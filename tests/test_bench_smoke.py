"""bench.py is the driver-run metric producer — a broken import or helper
means no recorded benchmark for the round. Pin its machinery on CPU."""
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

import bench


def test_pipelined_time_measures_positive_rate():
    xs = [jnp.asarray(np.full((64, 64), float(i + 1))) for i in range(2)]
    per = bench.pipelined_time(lambda x: x * 2.0, [(x,) for x in xs],
                               n_lo=2, n_hi=6, trials=1)
    assert per > 0


def test_pipelined_time_rejects_nonfinite():
    bad = jnp.asarray(np.full((4, 4), np.nan))
    try:
        bench.pipelined_time(lambda x: x, [(bad,)], n_lo=2, n_hi=4)
    except RuntimeError as e:
        assert "non-finite" in str(e)
    else:
        raise AssertionError("non-finite input must be rejected")


def test_bench_constants_shape():
    # the driver parses ONE json line with these exact keys
    assert bench.BASELINE_AUDIO_S_PER_S == 10_000.0
    line = json.dumps({"metric": "mel_extract_throughput", "value": 1.0,
                       "unit": "audio-seconds/s per chip", "vs_baseline": 1.0})
    parsed = json.loads(line)
    assert set(parsed) == {"metric", "value", "unit", "vs_baseline"}


def test_bench_main_importable_and_compiles_nothing_at_import():
    # importing bench must not trigger jax device work (it is imported by
    # benchmarks/roofline.py and by these tests)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import bench; print('IMPORT_OK')"],
        capture_output=True, text=True, timeout=120, cwd=".")
    assert "IMPORT_OK" in out.stdout
