"""The span readers (`nfbench/spans.py` and the metrics that use it) on a
synthetic device trace and synthetic spans, a traced tiny run on the CPU,
and on the card: each cell's `sync.*` spans against the syncs that
`torch.cuda.set_sync_debug_mode` reports."""

import time
import traceback
import warnings
from types import SimpleNamespace

import pytest
import torch

from neurofluid_torch.utils.profiling import Span
from nfbench import harness
from nfbench import spans as sp
from nfbench.tests.conftest import ROOT, SEED
from nfbench.trace import DeviceTrace, Op

US = 1000  # ns


def trace(*busy):
    return DeviceTrace([Op("k", a * US, b * US) for a, b in busy], [])


def run_of(unit, units, dtrace):
    return SimpleNamespace(unit=unit, units=units, trace=dtrace)


# a step [0, 1000] us: render [100, 450] holding render.features
# [120, 420] and a sync in it, backward [700, 900]; a second step
# [1000, 2000] with an optimizer [1500, 1600]
STEPS = [Span("sync.ball_features", 140 * US, 160 * US, "render.features"),
         Span("render.features", 120 * US, 420 * US, "render"),
         Span("render", 100 * US, 450 * US, "step.e2e"),
         Span("backward", 700 * US, 900 * US, "step.e2e"),
         Span("step.e2e", 0, 1000 * US, None),
         Span("optimizer", 1500 * US, 1600 * US, "step.e2e"),
         Span("step.e2e", 1000 * US, 2000 * US, None)]
# gaps: [100, 200] (middle 150, in render.features), [300, 500] (400,
# in render.features), [600, 1000] (800, backward), [1100, 1900] (1500,
# the optimizer's start), [2100, 3000] (2550, outside every span)
DEVICE = trace((0, 100), (200, 300), (500, 600), (1000, 1100), (1900, 2100),
               (3000, 3100))


def test_nested_gap_counts_once_for_its_top_layer():
    run = run_of("step", 2, DEVICE)
    # 100 + 200 us, both inside render.features inside render, over 2 steps
    assert sp.idle_ms_per_unit(run, "render", STEPS) == pytest.approx(0.15)
    assert sp.idle_ms_per_unit(run, "render.features", STEPS) == \
        pytest.approx(0.15)
    assert sp.idle_ms_per_unit(run, "backward", STEPS) == pytest.approx(0.2)
    assert sp.idle_ms_per_unit(run, "optimizer", STEPS) == pytest.approx(0.4)


def test_gap_outside_every_span_counts_nowhere():
    run = run_of("step", 2, DEVICE)
    named = sum(sp.idle_ms_per_unit(run, layer, STEPS)
                for layer in ("render", "backward", "optimizer",
                              "particle_net"))
    total = 1e3 * sum(sec for sec, _ in DEVICE.gaps()) / 2
    assert total - named == pytest.approx(0.45)  # the gap at 2,550 us
    assert sp.idle_ms_per_unit(run, "particle_net", STEPS) == 0.0


def test_results_are_per_unit_of_the_window():
    assert sp.count_per_unit(run_of("step", 2, DEVICE), "sync", STEPS) == 0.5
    # an earlier run's spans before the window's last unit do not count
    one = run_of("step", 1, DEVICE)
    assert sp.count_per_unit(one, "sync", STEPS) == 0.0
    assert sp.idle_ms_per_unit(one, "optimizer", STEPS) == pytest.approx(0.8)
    assert sp.idle_ms_per_unit(one, "render", STEPS) == 0.0


def test_no_span_of_the_unit_reads_none(monkeypatch):
    run = run_of("step", 2, DEVICE)
    assert sp.count_per_unit(run, "sync", []) is None
    assert sp.idle_ms_per_unit(run, "render", []) is None
    frame = run_of("frame", 2, DEVICE)
    assert sp.count_per_unit(frame, "sync", STEPS) is None
    monkeypatch.setattr(sp, "recorded", lambda: [])
    for name in ("host_syncs.train", "render_idle_ms.train",
                 "particle_net_idle_ms", "backward_idle_ms",
                 "optimizer_idle_ms", "host_syncs.frame",
                 "render_idle_ms.frame"):
        assert harness.load_reader(ROOT, name)(run) is None
        assert harness.load_reader(ROOT, name)(frame) is None


def test_readers_read_the_program_spans(monkeypatch):
    monkeypatch.setattr(sp, "recorded", lambda: STEPS)
    run = run_of("step", 2, DEVICE)
    read = {n: harness.load_reader(ROOT, n)(run)
            for n in ("host_syncs.train", "render_idle_ms.train",
                      "backward_idle_ms", "optimizer_idle_ms",
                      "particle_net_idle_ms", "host_syncs.frame")}
    assert read == pytest.approx({
        "host_syncs.train": 0.5, "render_idle_ms.train": 0.15,
        "backward_idle_ms": 0.2, "optimizer_idle_ms": 0.4,
        "particle_net_idle_ms": 0.0, "host_syncs.frame": None})


def test_traced_tiny_frame_reports_the_span_metrics(run_tiny):
    result, _ = run_tiny("eval-frame", trace=True)
    metrics = result["metrics"]
    assert {"host_syncs.frame", "render_idle_ms.frame"} <= set(metrics)
    # two K3 calls a chunk, seven sync sites each (a CPU run has no
    # device gaps to put down)
    chunks = -(-16 * 16 // 64)
    assert metrics["host_syncs.frame"]["value"] == 14 * chunks
    assert metrics["render_idle_ms.frame"]["value"] == 0.0
    assert "host_syncs.train" not in metrics


CELLS = ["transition-train", "e2e-train", "warmup-train", "eval-frame"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_sync_spans_are_the_syncs_the_card_reports(workload):
    """Over 3 units of the cell's entry at its full size, the `sync.*`
    spans inside the unit spans equal the synchronizing calls that
    `set_sync_debug_mode('warn')` reports inside them, and each reported
    call lies inside a `sync.*` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neurofluid_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = harness.make_entry(harness.load_parts(ROOT, workload), SEED,
                               torch.device("cuda"))
    entry.setup()
    torch.cuda.synchronize()
    reported = []

    def hook(message, *args, **kwargs):
        if "synchroniz" in str(message):
            where = [f"{f.filename.split('/repo/')[-1]}:{f.lineno} {f.name}"
                     for f in traceback.extract_stack()[:-1]
                     if "neurofluid_torch" in f.filename][-3:]
            reported.append((time.time_ns(), " <- ".join(reversed(where))))

    profiling.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                for i in range(3):
                    entry.run_unit(i, 0.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    entry.release()
    run = SimpleNamespace(unit=entry.unit, units=3)
    units, inside = sp.window_spans(run, profiling.spans())
    in_units = sp.union((s.start_ns, s.end_ns) for s in units)
    syncs = [s for s in inside if sp.in_layer(s.name, "sync")]
    in_syncs = sp.union((s.start_ns, s.end_ns) for s in syncs)
    seen = [w for t, w in reported if sp.covers(in_units, t)]
    bare = sorted({w for t, w in reported
                   if sp.covers(in_units, t) and not sp.covers(in_syncs, t)})
    print(f"{workload}: {len(syncs) / 3} sync spans and {len(seen) / 3} "
          f"reported syncs per unit; outside a sync span: {bare}")
    assert not bare
    assert len(syncs) == len(seen)
