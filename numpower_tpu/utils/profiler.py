"""Profiling / tracing hooks.

SURVEY.md §5: the reference has NO in-process tracing (only phpbench
microbenchmarks); this build adds jax.profiler traces and per-solve
timing. This module provides:

 - trace(dir):      context manager around jax.profiler.trace (TensorBoard-
                    compatible xplane dumps)
 - annotate(name):  TraceAnnotation for labelling solver phases
 - Timer:           wall-clock phase timer with summary statistics
 - time_compiled:   steady-state timing for jitted fns that cancels the
                    host<->device round-trip constant (slope method)
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace -> TensorBoard xplane dump in log_dir."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Label a region so it shows up in profiler timelines."""
    return jax.profiler.TraceAnnotation(name)


class Timer:
    """Accumulating phase timer: with timer.phase("backward"): ..."""

    def __init__(self):
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self._times.items():
            arr = np.asarray(ts)
            out[name] = {
                "count": len(ts),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(
                f"{name}: n={s['count']} mean={s['mean_ms']:.3f}ms "
                f"p50={s['p50_ms']:.3f}ms p99={s['p99_ms']:.3f}ms"
            )
        return "\n".join(lines)


def _readback(out):
    leaf = jax.tree_util.tree_leaves(out)[0]
    return float(leaf.ravel()[0])


def time_compiled(fn: Callable, *args, reps: int = 5, inner=(5, 55),
                  return_stats: bool = False):
    """Steady-state seconds-per-call for a jitted fn (slope method: the
    difference between inner[1] and inner[0] pipelined dispatches divided by
    the count, cancelling the readback RTT).

    Returns the MEDIAN over reps (best-of reads are optimistic). With
    return_stats=True also returns the IQR."""
    _readback(fn(*args))
    n1, n2 = inner
    samples = []
    for _ in range(max(int(reps), 3)):
        t = time.perf_counter()
        out = None
        for _ in range(n1):
            out = fn(*args)
        _readback(out)
        t1 = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(n2):
            out = fn(*args)
        _readback(out)
        t2 = time.perf_counter() - t
        samples.append(max((t2 - t1) / (n2 - n1), 1e-12))
    med = float(np.median(samples))
    if return_stats:
        q25, q75 = np.percentile(samples, [25, 75])
        return med, float(q75 - q25)
    return med
