"""Throughput and scaling-efficiency metrics.

The reference has no observability at all (SURVEY.md §5); BASELINE.json's
headline metric is audio-seconds/s per chip and >0.9 multi-host scaling
efficiency — these helpers measure and report exactly that.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax


@dataclasses.dataclass
class ThroughputResult:
    audio_seconds: float
    wall_seconds: float
    iters: int
    n_devices: int

    @property
    def audio_seconds_per_second(self) -> float:
        return self.audio_seconds / self.wall_seconds

    @property
    def per_chip(self) -> float:
        return self.audio_seconds_per_second / max(self.n_devices, 1)

    def json(self) -> dict:
        return {
            "audio_seconds_per_second": round(self.audio_seconds_per_second, 1),
            "per_chip": round(self.per_chip, 1),
            "iters": self.iters,
            "n_devices": self.n_devices,
            "wall_seconds": round(self.wall_seconds, 4),
        }


def measure_throughput(fn: Callable, args: tuple, audio_seconds_per_call: float,
                       n_devices: int = 1, warmup: int = 2,
                       min_seconds: float = 1.0, max_iters: int = 100,
                       trials: int = 3, alt_args: Optional[tuple] = None
                       ) -> ThroughputResult:
    """Steady-state throughput of a jitted call (compile excluded).

    Best-of-``trials`` batches: each batch runs ``iters`` calls back to back
    and waits for the last with ``jax.block_until_ready``, so the time
    covers the device work, not only the dispatch. ``alt_args``: a second
    argument tuple to alternate with ``args``.
    """
    argsets = [args] if alt_args is None else [args, alt_args]
    out = None
    for a in argsets:
        for _ in range(max(warmup, 1)):
            out = fn(*a)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    once = time.perf_counter() - t0
    iters = max(3, min(max_iters, int(min_seconds / max(once, 1e-5))))
    best = float("inf")
    for _ in range(max(trials, 1)):
        t0 = time.perf_counter()
        for i in range(iters):
            out = fn(*argsets[i % len(argsets)])
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return ThroughputResult(audio_seconds=audio_seconds_per_call * iters,
                            wall_seconds=best, iters=iters,
                            n_devices=n_devices)


def scaling_efficiency(single: ThroughputResult, multi: ThroughputResult
                       ) -> float:
    """Throughput(N devices) / (N * throughput(1 device))."""
    base = single.audio_seconds_per_second
    return multi.audio_seconds_per_second / (multi.n_devices * base)


def spectral_convergence(signal, mag_target, frame_len: int, hop: int,
                         window=None, scale_invariant: bool = True) -> float:
    """Reconstruction-quality metric: relative L2 distance between the
    windowed-STFT magnitudes of ``signal`` and target magnitudes
    ``mag_target`` [F, frame_len//2+1] (lower is better).

    ``scale_invariant=True`` (default) factors out the overall amplitude
    with the least-squares optimal scale c — required when judging the
    reference-parity Griffin-Lim, whose overlap-add is NOT window-sum
    normalized (/root/reference/mel/mel.go:127-132) and therefore carries a
    constant gain that would otherwise dominate the metric.
    """
    import jax.numpy as jnp

    from ..ops.stft import frame_signal, hann_window

    if window is None:
        window = jnp.asarray(hann_window(frame_len), signal.dtype)
    frames = frame_signal(signal, frame_len, hop)
    n_f = min(frames.shape[0], mag_target.shape[0])
    a = jnp.abs(jnp.fft.rfft(frames[:n_f] * window, axis=-1))
    mag = mag_target[:n_f]
    if scale_invariant:
        denom = jnp.vdot(mag, mag)
        c = jnp.where(denom > 0,
                      jnp.vdot(a, mag) / jnp.where(denom > 0, denom, 1.0),
                      1.0)
        # an all-zero or uncorrelated reconstruction drives c -> 0 and the
        # |c|-normalized metric to inf/nan, poisoning downstream comparisons
        # — fall back to the plain (c=1) distance there
        c = jnp.where(jnp.abs(c) > 1e-12, c, jnp.asarray(1.0, c.dtype))
    else:
        c = jnp.asarray(1.0, a.dtype)
    return float(jnp.linalg.norm(a - c * mag)
                 / (jnp.abs(c) * jnp.linalg.norm(mag)))
