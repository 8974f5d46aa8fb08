"""Profiling helpers (port of neurofluid_tpu/utils/profiling.py; the
reference has none).

`trace` records a `torch.profiler` trace (the JAX package's `xla_trace`).

`span(name)` marks a stretch of the program: while a torch profiler is
recording, it enters `torch.profiler.record_function(name)` (so the
profiler's trace shows the range) and appends a `Span` to an in-memory
record, stamped with `time.time_ns()`, the clock the profiler stamps its
events on; otherwise it does one check and returns a shared no-op
context. `spans()` reads the record and `reset()` clears it. There is no
other switch: a profiler recording is the switch.

The program's spans, by layer:
- the entry points: `step.transition`, `step.e2e`, `step.warmup` (one
  train step each) and `frame` (a chunked full-image render);
  `E2ETrainer.train_iteration` opens `step.e2e` around the whole
  iteration, its train step's inside it recording none of its own;
- the e2e trainer's loop, inside its iteration: `loop.data` (the frame's
  arrays, the pixel draw, the copies to the device and the box check),
  `loop.log` (`log_step`) and, inside it, `loop.pred2gt` (the host's
  nearest-neighbour Pred2GT);
- the model: `particle_net` (child `particle_net.plan`: the search
  structures and sorts; on the list backends its children
  `particle_net.search`, both searches with their grid builds, and
  `particle_net.geometry`, the adjoint plans, the conv geometry and the
  tap matrix), `render` (children `render.features`: search,
  ball-feature sums and encodings; `render.nerf`: an MLP call),
  `backward` (a `loss.backward()`), `optimizer` (gradient norms, clipping
  and the optimizer steps);
- `sync.<site>`: one call that blocks the host until the device has
  drained its queue (a read of a device value, or a host-to-device copy
  from pageable memory; `sync_span` records a copy only where it goes to
  a CUDA device). Their number is the port's count of host syncs. The
  units of the `fused_cconv` backend and of the dense render make none.
  The list backends make four kinds: `sync.grid_origin` and
  `sync.grid_dims` once per query chunk of the grid search
  (`neighbor_search._grid_chunk`, the list render's too), and
  `sync.tap_sizes` and `sync.tap_corner_max` once per conv geometry
  (`cconv.trilinear_taps`; `trilinear_taps_vjp` on the plain fused
  conv's backward). Outside the units, `sync.overflow` is the trainers'
  read of the search-overflow flag after a step. The e2e trainer's
  iteration makes two more kinds, inside its unit: `sync.data`, each copy
  of a host array to the card in `loop.data`, and `sync.log`, each read
  of a device value in `log_step` (its overflow read stays
  `sync.overflow`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_spans: list = []
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns(), the profiler's clock
    end_ns: int
    parent: str | None  # the enclosing span's name on the same thread


class _Recorded:
    __slots__ = ("name", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack = _local.__dict__.setdefault("stack", [])
        stack.append(self.name)
        self.start = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = _local.stack
        stack.pop()
        _spans.append(Span(self.name, self.start, end,
                           stack[-1] if stack else None))
        self.range.__exit__(*exc)


def span(name: str):
    """A context that records the stretch it encloses as `name` while a
    torch profiler records, and does nothing otherwise. Inside an open
    span of the same name on this thread it records nothing: a train
    step called by a trainer's iteration, which opens `step.e2e` itself,
    makes one span of the unit."""
    if not _recording() or name in getattr(_local, "stack", ()):
        return _OFF
    return _Recorded(name)


def sync_span(name: str, device: torch.device):
    """`span(name)` around a host-to-device copy from pageable memory to
    `device`: a CUDA device, where the copy waits for the stream; on the
    CPU nothing waits, and the context does nothing."""
    return span(name) if device.type == "cuda" else _OFF


def spans() -> list:
    """The spans recorded since the last `reset`, each appended when it
    ended (a child before its parent)."""
    return list(_spans)


def reset() -> None:
    _spans.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace of the block (the CPU, and the card
    when there is one) and write it to `logdir` as a Chrome trace, which
    TensorBoard's profiler plugin and chrome://tracing read; the program's
    spans show in it as ranges. Yields the profiler, whose
    `key_averages()` sums the block by operator. The span record is
    cleared on entry, so `spans()` afterwards holds the block's own."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof
