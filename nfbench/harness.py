"""One run of one cell: find its configuration, traffic mix, limits and
metrics by name, set up, measure a window, check the outputs, and build
the result line.

Everything a cell is made of is found by the names in `BENCHMARK.json`:
- `nfbench/configs/<config>.json`: the model, its precision and its
  control precision, the scene, the optimizer, the peak its operations
  divide by;
- `nfbench/traffic/<traffic>.json`: the entry the window drives (its
  `entry`) and its load;
- `nfbench/entries/<entry>.py`: the class `Entry` that builds the
  program's object, runs one unit of the window at a time and compares
  its outputs with the reference (`nfbench/cells.py` holds what entries
  share);
- `nfbench/limits/<workload>.json`: the numbers compared, each with its
  limit;
- `nfbench/metrics/<metric>.py`: one per-layer metric, `read(run)` ->
  a number or None.
End-to-end metrics are read from the window by their names: `setup_s`,
`<unit>_ms` (the window over the units it completed) and `<unit>_pNN_ms`
(the NN-th percentile of every unit's time, nearest rank).
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from nfbench.trace import DeviceTrace

FORBIDDEN = ("jax", "jaxlib", "flax", "neurofluid_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(root: Path, workload: str) -> dict:
    bench = load_json(root / "BENCHMARK.json")
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return {"cell": cell, "bench": bench}
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_parts(root: Path, workload: str) -> SimpleNamespace:
    found = cell_of(root, workload)
    cell, bench, here = found["cell"], found["bench"], root / "nfbench"
    return SimpleNamespace(
        root=root, cell=cell, bench=bench,
        config=load_json(here / "configs" / f"{cell['config']}.json"),
        traffic=load_json(here / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(here / "limits" / f"{workload}.json"))


def metrics_of(bench: dict, group: str, workload: str) -> list:
    return [m for m in bench[group]
            if "workloads" not in m or workload in m["workloads"]]


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(root: Path, name: str):
    """The `read` function of the per-layer metric `name`."""
    return _load_module(root / "nfbench" / "metrics" / f"{name}.py",
                        f"nfbench_metric_{name}").read


def load_entry(root: Path, name: str):
    """The class `Entry` of the entry `name` that a traffic mix names."""
    return _load_module(root / "nfbench" / "entries" / f"{name}.py",
                        f"nfbench_entry_{name}").Entry


def make_entry(parts: SimpleNamespace, seed: int, device):
    return load_entry(parts.root, parts.traffic["entry"])(
        parts.config, parts.traffic, seed, device)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def end_to_end(name: str, unit: str, setup_s: float, window_s: float,
               times_s: list):
    """The value of the end-to-end metric `name`, or None where it does
    not apply to this unit."""
    if name == "setup_s":
        return setup_s
    if name == f"{unit}_ms":
        return 1e3 * window_s / len(times_s)
    m = re.fullmatch(rf"{unit}_p(\d+)_ms", name)
    if m:
        ordered = sorted(times_s)
        rank = math.ceil(int(m.group(1)) / 100.0 * len(ordered))
        return 1e3 * ordered[max(rank, 1) - 1]
    return None


class HostMark:
    """The host clock in the place of a CUDA event, for runs on the CPU
    (the harness's own tests)."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


def window(entry, seconds: float, device) -> tuple:
    """Run units until `seconds` have passed and the entry has taken what
    it compares from the window; returns (window seconds, every unit's
    seconds). Each unit's end is a CUDA event recorded after it on the
    stream: the window adds no synchronisation of its own but the last.
    A unit is told the share of the window passed when it starts."""
    cuda = device.type == "cuda"
    mark = (lambda: torch.cuda.Event(enable_timing=True)) if cuda \
        else HostMark
    if cuda:
        torch.cuda.synchronize(device)
    marks = [mark()]
    marks[0].record()
    t0 = time.perf_counter()
    i = 0
    while True:
        share = (time.perf_counter() - t0) / seconds
        if i and share >= 1.0 and entry.settled():
            break
        entry.run_unit(i, share)
        i += 1
        marks.append(mark())
        marks[-1].record()
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    times = [1e-3 * a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return window_s, times


def run(parts: SimpleNamespace, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda") -> tuple:
    """(result dict, check lines) of one run of the cell whose pieces
    `load_parts` found."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    workload, config, traffic = parts.cell["name"], parts.config, parts.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = make_entry(parts, seed, dev)
    entry.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            window_s, times = window(entry, seconds, dev)
    else:
        window_s, times = window(entry, seconds, dev)

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    entry.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    work = entry.work()
    numbers = entry.numbers()
    check_s = time.perf_counter() - t_check
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in parts.limits.items()}
    correct = entry.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": entry.attempted,
              "failed": entry.failed}
    metrics = {}
    if trace:
        dtrace = DeviceTrace.from_profiler(prof)
        ctx = SimpleNamespace(workload=workload, config=config,
                              traffic=traffic, unit=entry.unit,
                              units=len(times), window_s=window_s,
                              trace=dtrace, work=work)
        for m in metrics_of(parts.bench, "per_layer", workload):
            value = load_reader(parts.root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = dtrace.busy_s()
        device_info["window_s"] = window_s
        result["breakdown"] = dtrace.breakdown()
    else:
        for m in metrics_of(parts.bench, "end_to_end", workload):
            value = end_to_end(m["name"], entry.unit, setup_s, window_s,
                               times)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    lines = [f"nfbench: set-up {setup_s:.1f} s, window {window_s:.1f} s, "
             f"{len(times)} {entry.unit}s, the check {check_s:.1f} s"]
    lines += [f"check {name}: {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    lines.append(f"check failed units: {entry.failed} limit 0")
    return result, lines
