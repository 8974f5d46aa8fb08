"""Profiling and timing helpers (port of neurofluid_tpu/utils/profiling.py;
the reference has none).

`trace` records a `torch.profiler` trace (the JAX package's `xla_trace`);
`block_and_time` waits for the card where the JAX package blocks on its
result.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace of the block (the CPU, and the card
    when there is one) and write it to `logdir` as a Chrome trace, which
    TensorBoard's profiler plugin and chrome://tracing read. Yields the
    profiler, whose `key_averages()` sums the block by operator."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


class StepTimer:
    """Wall-clock EMA step timer with a throughput helper."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else (
            self.ema * self.avg + (1 - self.ema) * dt)

    def rate(self, items_per_step: float) -> float:
        return items_per_step / self.avg if self.avg else 0.0


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def block_and_time(fn, *args, iters: int = 10, warmup: int = 2, **kwargs):
    """(median wall seconds of `fn(*args, **kwargs)`, the last output),
    each call timed to the end of its work on the card."""
    times = []
    out = None
    for i in range(warmup + iters):
        _synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out
