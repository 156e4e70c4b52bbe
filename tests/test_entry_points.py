"""Process-level entry points: the persistent compilation cache, the
benchmark's peak table, the native helpers, and chip_smoke.py's refusal to
run without a GPU."""
import conftest  # noqa: F401  (forces CPU)

import os
import shutil
import subprocess
import sys

import jax
import pytest

import bench
from gomel_tpu.utils import compile_cache

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set_is_left_to_jax(monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_unset_uses_fixed_checkout_dir(monkeypatch,
                                                     restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same path from every process: nothing per-run in it
    assert compile_cache.enable_compile_cache() == path


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_console_entry_enables_cache_before_the_tool(monkeypatch):
    from gomel_tpu.cli import tools
    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: calls.append("cache") or "dir")
    run = tools._process_entry(lambda: calls.append("tool") or 0)
    assert run() == 0
    assert calls == ["cache", "tool"]


def test_device_peaks_h100():
    p = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in p["source"]


@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "NVIDIA A100"])
def test_device_peaks_unknown_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks(kind)


def test_native_helpers_build_and_load():
    from gomel_tpu.io._native import native_status
    status = native_status()
    assert set(status) == {"pngfilter.cpp", "flacdec.cpp"}
    assert all(status.values()), status


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_chip_smoke_refuses_the_cpu():
    proc = _run_smoke(os.path.join(REPO_ROOT, "chip_smoke.py"), REPO_ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not a GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script cannot pass."""
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_rehearsal_passes(tmp_path):
    """Every phase of chip_smoke.py, on the CPU at 1/50 of the durations:
    the script's own control flow, parity checks and tolerances."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "chip_smoke.py"),
         "--rehearse"], capture_output=True, text=True, timeout=900,
        cwd=REPO_ROOT, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "rehearsal ok" in proc.stdout
    assert "FAIL" not in proc.stdout
