"""Reading the program's spans (`neurofluid_torch.utils.profiling`) of a
traced window beside its device trace. Both are stamped on the
profiler's clock, so a device-idle gap (`DeviceTrace.gaps`: seconds and
the middle in ns) is put down to the layer the host was in at its
middle.

A span belongs to layer X when it is named X or X.<anything>: `render`
holds `render.features` and `render.nerf`, `sync` every `sync.<site>`,
`step` every train step. The window's units are the last `run.units`
spans of the layer named by the run's unit (`step` or `frame`), and only
spans inside them count. Each result is per unit, and None where the
program recorded no span of the unit (a program without spans)."""

from __future__ import annotations

import bisect


def recorded() -> list:
    """The program's spans, or [] where it records none."""
    from neurofluid_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read else []


def in_layer(name: str, layer: str) -> bool:
    return name == layer or name.startswith(layer + ".")


def union(intervals) -> list:
    """The sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covers(merged: list, t: int) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def window_spans(run, spans=None):
    """(the unit spans of the window, the spans inside them), or None
    where no span of the run's unit was recorded."""
    spans = recorded() if spans is None else spans
    units = [s for s in spans if in_layer(s.name, run.unit)]
    if not units or run.units < 1:
        return None
    units = sorted(units, key=lambda s: s.start_ns)[-run.units:]
    merged = union((s.start_ns, s.end_ns) for s in units)
    inside = [s for s in spans
              if covers(merged, s.start_ns) and covers(merged, s.end_ns)]
    return units, inside


def count_per_unit(run, layer: str, spans=None):
    """Spans of `layer` inside the window's units, per unit."""
    found = window_spans(run, spans)
    if found is None:
        return None
    _, inside = found
    return sum(in_layer(s.name, layer) for s in inside) / run.units


def idle_ms_per_unit(run, layer: str, spans=None):
    """Milliseconds per unit of device-idle gaps whose middle lies inside
    a span of `layer` within the window's units; each gap counts once,
    however deeply the layer's spans nest there."""
    found = window_spans(run, spans)
    if found is None:
        return None
    _, inside = found
    merged = union((s.start_ns, s.end_ns) for s in inside
                   if in_layer(s.name, layer))
    idle = sum(sec for sec, mid in run.trace.gaps() if covers(merged, mid))
    return 1e3 * idle / run.units
