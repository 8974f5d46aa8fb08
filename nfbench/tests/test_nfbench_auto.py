"""The `transition-train-auto` cell: the trainers' list path (search
backend 'auto': grid search, list conv, K8) through the harness. On the
CPU at a tiny scene: a run is correct, its traced line carries the new
span metrics, the control and the faults fail a limit, the span readers
read nothing from a program without the spans, and `list_conv_ms` reads
the products and K8 alone. On the card: the cell's
`sync.*` spans are the syncs that `set_sync_debug_mode('warn')` reports,
and the benchmark's command runs the cell."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from neurofluid_torch.utils.profiling import Span
from nfbench import harness
from nfbench.faults import planted
from nfbench.tests.conftest import ROOT, SEED
from nfbench.tests.test_nfbench_spans import (
    test_sync_spans_are_the_syncs_the_card_reports as _sync_check,
)
from nfbench.trace import DeviceTrace, Op

CELL = "transition-train-auto"
NEW_METRICS = ("search_idle_ms", "geometry_idle_ms")
# 216 fluid particles on the container's floor, whose 720 particles lie
# close enough for the box conv to see pairs
TINY_SCENE = {"fluid_side": 6, "box_side": 12}


def tiny_parts():
    parts = harness.load_parts(ROOT, CELL)
    parts.config["scene"].update(TINY_SCENE)
    return parts


def run_tiny(trace=False, seed=SEED):
    torch.manual_seed(0)
    return harness.run(tiny_parts(), seed, 0.3, trace,
                       t_start=time.perf_counter(), device="cpu")


def test_the_cell_runs_the_trainers_default_path():
    parts = harness.load_parts(ROOT, CELL)
    pn = parts.config["particle_net"]
    assert pn["search_backend"] == "auto"
    assert pn["conv_precision"] == "highest"
    assert parts.traffic["entry"] == "transition_train"
    assert not any(k.startswith("fused_") for k in pn)


@pytest.mark.parametrize("seed", [SEED, 7])
def test_tiny_run_is_correct(seed):
    result, _ = run_tiny(seed=seed)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 3
    assert set(result["metrics"]) == {"setup_s", "step_ms"}


def test_traced_tiny_run_reports_the_span_metrics():
    result, _ = run_tiny(trace=True)
    metrics = result["metrics"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in harness.metrics_of(bench, "per_layer", CELL)}
    # a CPU run has no device trace: no launches or kernel time, nothing
    # idle to put down
    assert listed - {"launches_per_step", "list_conv_ms"} <= set(metrics)
    for name in NEW_METRICS:
        assert metrics[name]["value"] == 0.0
    # on the CPU no copy waits for a device
    assert metrics["host_syncs.train"]["value"] == 0.0


def test_control_fails_a_limit():
    parts = tiny_parts()
    dev = torch.device("cpu")
    entry = harness.make_entry(parts, SEED, dev)
    entry.setup()
    harness.window(entry, 0.1, dev)
    entry.release()
    control = entry.control_numbers()
    assert set(parts.limits) <= set(control)
    assert any(control[name] > limit for name, limit in parts.limits.items())


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_broken_program_is_not_correct(fault):
    with planted(fault):
        result, _ = run_tiny()
    assert not result["correct"]


US = 1000  # ns
# two steps; the first holds a search [100, 300] and a geometry [300,
# 400] us inside its plan; idle gaps with middles at 200 (the search),
# 350 (the geometry) and 1,500 us (outside both)
SPANS = [Span("particle_net.search", 100 * US, 300 * US, "particle_net.plan"),
         Span("particle_net.geometry", 300 * US, 400 * US,
              "particle_net.plan"),
         Span("particle_net.plan", 50 * US, 450 * US, "particle_net"),
         Span("particle_net", 0, 900 * US, "step.transition"),
         Span("step.transition", 0, 1000 * US, None),
         Span("step.transition", 1000 * US, 2000 * US, None)]
DEVICE = DeviceTrace([Op("k", a * US, b * US) for a, b in
                      ((0, 150), (250, 320), (380, 1400), (1600, 2000))], [])


def test_readers_read_the_spans_or_nothing(monkeypatch):
    from nfbench import spans as sp

    run = SimpleNamespace(unit="step", units=2, trace=DEVICE)
    read = {n: harness.load_reader(ROOT, n) for n in NEW_METRICS}
    monkeypatch.setattr(sp, "recorded", lambda: SPANS)
    assert read["search_idle_ms"](run) == pytest.approx(0.05)
    assert read["geometry_idle_ms"](run) == pytest.approx(0.03)
    # the parent's program: unit spans, but no search or geometry span
    monkeypatch.setattr(sp, "recorded", lambda: SPANS[3:])
    assert all(r(run) is None for r in read.values())
    monkeypatch.setattr(sp, "recorded", lambda: [])
    assert all(r(run) is None for r in read.values())
    frame = SimpleNamespace(unit="frame", units=2, trace=DEVICE)
    assert all(r(frame) is None for r in read.values())


def test_list_conv_reader_reads_the_products_and_k8():
    read = harness.load_reader(ROOT, "list_conv_ms")
    ops = [("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8", 2000),
           ("void cutlass::Kernel2<cutlass_80_simt_sgemm>(Params)", 500),
           ("void segment_sum_kernel<4>(float const*, int const*)", 300),
           # the gathers (the search's too), the fused conv's own product
           ("void at::native::vectorized_gather_kernel<16, long>()", 4000),
           ("void split_gemm_kernel<64, false, false>(float const*)", 900)]
    at, trace = 0, []
    for name, us in ops:
        trace.append(Op(name, at * US, (at + us) * US))
        at += us + 10
    run = SimpleNamespace(unit="step", units=2, trace=DeviceTrace(trace, []))
    assert read(run) == pytest.approx(1.4)  # (2 + 0.5 + 0.3) ms / 2 steps
    run.trace = DeviceTrace(trace[3:], [])
    assert read(run) is None
    assert read(SimpleNamespace(unit="frame", units=2, trace=DEVICE)) is None


@pytest.mark.cuda
def test_sync_spans_are_the_syncs_the_card_reports():
    _sync_check(CELL)


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "nfbench.run", "--workload", CELL,
         "--seed", "5000000011", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
