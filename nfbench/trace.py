"""Reading torch.profiler's device trace of a window: the device
operations (kernels, copies, sets) and the host's operations, taken from
the profiler's raw events without building its per-operator tables.

- busy_s: the union of the device operations' intervals;
- kernel_s(pattern): the summed time of the kernels whose name matches;
- launches(): how many kernels ran;
- breakdown(): the ten device operations that took most time, by name,
  and the ten largest sums of idle gaps, each gap named by the innermost
  host operation running at its middle. Ranges annotated on the device's
  timeline (the optimizer's step) are not operations and are left out.
"""

from __future__ import annotations

import bisect
import re
from typing import NamedTuple

COPY = re.compile(r"^(Memcpy|Memset)")


class Op(NamedTuple):
    name: str
    start: int  # ns
    end: int


def _span(e) -> tuple:
    start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)
    if hasattr(e, "end_ns"):
        end = e.end_ns()
    elif hasattr(e, "duration_ns"):
        end = start + e.duration_ns()
    else:
        end = start + int(e.duration_us() * 1e3)
    return start, end


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymous
    marks, template arguments and parameters:
    'void (anonymous namespace)::walk_fwd_kernel<8, false>(float const*)'
    -> 'walk_fwd_kernel'."""
    depth, out = 0, []
    for ch in name.replace("(anonymous namespace)::", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    words = "".join(out).split("(")[0].split()
    return (words[-1] if words else name)[:120]


class DeviceTrace:
    def __init__(self, device_ops: list, host_ops: list):
        self.device = sorted(device_ops, key=lambda o: o.start)
        self.host = sorted(host_ops, key=lambda o: o.start)
        self._host_starts = [o.start for o in self.host]

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        cpu = torch.autograd.DeviceType.CPU
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            kind = e.device_type()
            if getattr(e, "is_user_annotation", lambda: False)():
                continue  # a range over other operations, not one itself
            if kind == cuda:
                dev.append(Op(e.name(), *_span(e)))
            elif kind == cpu and not e.is_async():
                host.append(Op(e.name(), *_span(e)))
        return cls(dev, host)

    def kernels(self):
        return [o for o in self.device if not COPY.match(o.name)]

    def busy_s(self) -> float:
        total, cur_s, cur_e = 0, None, None
        for o in self.device:
            if cur_e is None or o.start > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = o.start, o.end
            else:
                cur_e = max(cur_e, o.end)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-9

    def kernel_s(self, pattern: str, exclude: str | None = None) -> float:
        rx = re.compile(pattern)
        ex = re.compile(exclude) if exclude else None
        return 1e-9 * sum(o.end - o.start for o in self.kernels()
                          if rx.search(o.name)
                          and not (ex and ex.search(o.name)))

    def launches(self) -> int:
        return len(self.kernels())

    def gaps(self) -> list:
        """(seconds, middle ns) of each idle interval between device
        operations."""
        out, cur_e = [], None
        for o in self.device:
            if cur_e is not None and o.start > cur_e:
                out.append(((o.start - cur_e) * 1e-9, (o.start + cur_e) // 2))
            cur_e = o.end if cur_e is None else max(cur_e, o.end)
        return out

    def host_at(self, t: int) -> str:
        """The innermost host operation running at `t`."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - 256, -1), -1):
            if self.host[j].end >= t:
                return self.host[j].name
        return "(Python between operators)"

    def breakdown(self) -> dict:
        ops = {}
        for o in self.device:
            name = (o.name.split(" (")[0] if COPY.match(o.name)
                    else short_name(o.name))
            ops[name] = ops.get(name, 0.0) + (o.end - o.start) * 1e-9
        named = {}
        for sec, mid in self.gaps():
            label = self.host_at(mid)
            named[label] = named.get(label, 0.0) + sec
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(named)}
