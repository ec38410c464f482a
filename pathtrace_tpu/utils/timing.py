"""Timing + throughput instrumentation.

The reference brackets each kernel with cudaEvents and prints ms/fps
(``include/Renderer.h:63-75``, ``src/main.cu:183``). The JAX equivalent is
``block_until_ready`` walls around jitted calls, plus the derived
throughput metric used across this repo:

    Mrays/s = W * H * spp * max_bounces / time

(path segments per second; SURVEY.md §5 "Tracing / profiling").
``jax.profiler`` traces can be captured with the ``trace`` helper.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from typing import Callable

import jax


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 10, **kwargs):
    """Median wall time of ``fn(*args)`` over ``iters`` calls, each ended
    by ``block_until_ready`` (JAX returns before the device finishes), after
    ``warmup`` untimed calls that absorb compilation. Returns
    (median seconds, sorted list of all times, last result)."""
    result = None
    for _ in range(max(warmup, 1)):
        result = jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return statistics.median(times), times, result


def mrays_per_sec(width: int, height: int, spp: int, max_bounces: int, seconds: float):
    return width * height * spp * max_bounces / seconds / 1e6


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (the reference has no profiler hooks;
    its analog would be nvprof/NVTX ranges)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class MetricsLogger:
    """Structured per-frame/per-step metrics to stdout and optional JSONL
    (SURVEY.md §5 'Metrics / logging')."""

    def __init__(self, jsonl_path=None, quiet=False):
        self.path = jsonl_path
        self.quiet = quiet
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def log(self, **fields):
        fields.setdefault("ts", time.time())
        if not self.quiet:
            printable = {k: v for k, v in fields.items() if k != "ts"}
            print(" ".join(f"{k}={v}" for k, v in printable.items()))
        if self._fh:
            self._fh.write(json.dumps(fields) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
