"""The port's spans (`neurofluid_torch.utils.profiling`): recorded only
while a torch profiler records, with their parents, on the profiler's
clock; placed at the layer boundaries of the four entry points (a
transition, an end-to-end and a warm-up train step, a chunked frame);
cleared by `trace`.

Imports no JAX: the card test here runs with

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

from collections import Counter

import pytest
import torch

from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.train import e2e, losses, transition, warmup
from neurofluid_torch.train.trainer_base import TrainerBase
from neurofluid_torch.utils import profiling

CPU = torch.profiler.ProfilerActivity.CPU
TIGHT = dict(grid_lower=(-0.5, -0.5, -0.65), grid_upper=(0.5, 0.5, 0.55),
             fused_cell_scale=2.0, layer_channels=(8, 24, 3))
RENDER = dict(near=1.0, far=3.0, n_samples=16, n_importance=16, nerf_depth=6,
              nerf_width=32, grid_lower=(-0.5, -0.5, -0.65),
              grid_upper=(0.5, 0.5, 0.55), grid_max_per_cell=64, xyz_freqs=5)


def profiled(*activities):
    return torch.profiler.profile(activities=[CPU, *activities])


def test_span_off_records_nothing():
    profiling.reset()
    ctx = profiling.span("step.e2e")
    assert ctx is profiling.span("render")  # one shared no-op
    with ctx:
        torch.ones(4) + 1
    assert profiling.spans() == []


def test_nested_spans_are_user_annotations_on_the_profilers_clock():
    profiling.reset()
    with profiled() as prof:
        with profiling.span("warm"):  # the first range pays the set-up
            pass
        with profiling.span("outer"):
            torch.ones(8) + 1
            with profiling.span("outer.inner"):
                torch.ones(8) * 2
    rec = {s.name: s for s in profiling.spans()}
    assert [s.name for s in profiling.spans()] == ["warm", "outer.inner",
                                                   "outer"]
    assert rec["outer"].parent is None
    assert rec["outer.inner"].parent == "outer"
    assert (rec["outer"].start_ns <= rec["outer.inner"].start_ns
            <= rec["outer.inner"].end_ns <= rec["outer"].end_ns)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    for name in ("outer", "outer.inner"):
        assert abs(events[name].start_ns() - rec[name].start_ns) < 100_000


def test_trace_resets_the_record(tmp_path):
    with profiled():
        with profiling.span("before"):
            pass
    assert "before" in [s.name for s in profiling.spans()]
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("inside"):
            pass
    assert [s.name for s in profiling.spans()] == ["inside"]
    profiling.reset()
    assert profiling.spans() == []


def _scene(n_views: int, device):
    g = torch.Generator().manual_seed(3)
    n, m, r = 160, 24, 8
    pos = torch.rand(n, 3, generator=g) * 0.5 - 0.25
    vel = torch.randn(n, 3, generator=g) * 0.1
    box = torch.rand(m, 3, generator=g) * 0.9 - 0.45
    box[:, 2] = -0.45
    nrm = torch.tensor([[0.0, 0.0, 1.0]]).repeat(m, 1)
    o = torch.tensor([0.0, 0.02, 2.0]).repeat(r, 1)
    d = torch.tensor([0.0, 0.0, -1.0]).repeat(r, 1)
    d[:, 0] += torch.linspace(-0.1, 0.1, r)
    rays = torch.cat([o, d / d.norm(dim=-1, keepdim=True)], -1)
    rays_v = rays[None].repeat(n_views, 1, 1)
    views = (rays_v[:, 0, :3].clone(), rays_v,
             torch.rand(n_views, r, 3, generator=g))
    return (pos.to(device), vel.to(device), box.to(device), nrm.to(device),
            tuple(t.to(device) for t in views))


def _models(device):
    g = torch.Generator().manual_seed(0)
    net = ParticleNet(gravity=(0.0, 0.0, -9.81), search_backend="fused_cconv",
                      device=device, generator=g, **TIGHT)
    return net, RenderNet(device=device, generator=g, **RENDER)


def _run_entry(entry: str, device="cpu"):
    """One unit of an entry point at small sizes, as a closure: a
    transition, an end-to-end or a warm-up train step, or a chunked frame
    (also run on the card by `tests/test_torch_cuda.py`)."""
    net, ren = _models(device)
    bounds = losses.default_box_bounds(device=device)
    pos, vel, box, nrm, views = _scene(4 if entry == "warmup" else 1, device)
    if entry == "transition":
        step = transition.make_transition_train_step(
            net, torch.optim.Adam(net.parameters(), 1e-5), bounds)
        return lambda: step(pos, vel, pos + 0.01, pos + 0.02, box, nrm)
    if entry == "e2e":
        step = e2e.make_e2e_train_step(
            net, ren, torch.optim.Adam(ren.parameters(), 1e-4),
            torch.optim.Adam(net.parameters(), 1e-5), bounds, 1.0)
        return lambda: step(pos, vel, box, nrm, *views)
    if entry == "warmup":
        step = warmup.make_warmup_train_step(
            ren, torch.optim.Adam(ren.parameters(), 1e-4))
        return lambda: step(pos, *views)
    render_full = TrainerBase.make_chunk_renderer(None, ren, chunk=4)
    return lambda: render_full(pos, views[0][0], views[1][0])


# per entry: (spans by name, as they nest under their parents), then the
# number of `sync.*` spans: none, since no unit of the model waits for the
# device (the grid constants are fills, K3's compaction a fixed-size
# scatter)
EXPECTED = {
    "transition": ({("step.transition", None): 1,
                    ("particle_net", "step.transition"): 2,
                    ("particle_net.plan", "particle_net"): 2,
                    ("backward", "step.transition"): 1,
                    ("optimizer", "step.transition"): 1}, 0),
    "e2e": ({("step.e2e", None): 1, ("particle_net", "step.e2e"): 1,
             ("particle_net.plan", "particle_net"): 1,
             ("render", "step.e2e"): 1, ("render.features", "render"): 2,
             ("render.nerf", "render"): 2, ("backward", "step.e2e"): 1,
             ("optimizer", "step.e2e"): 1}, 0),
    "warmup": ({("step.warmup", None): 1, ("render", "step.warmup"): 4,
                ("render.features", "render"): 8,
                ("render.nerf", "render"): 8, ("backward", "step.warmup"): 1,
                ("optimizer", "step.warmup"): 1}, 0),
    "frame": ({("frame", None): 1, ("render", "frame"): 2,
               ("render.features", "render"): 4,
               ("render.nerf", "render"): 4}, 0),
}


@pytest.mark.parametrize("entry", list(EXPECTED))
def test_entry_spans_at_the_layer_boundaries(entry):
    run = _run_entry(entry)
    profiling.reset()
    run()
    assert profiling.spans() == []  # no profiler, no record
    with profiled():
        run()
    got = profiling.spans()
    nesting, n_sync = EXPECTED[entry]
    pairs = Counter((s.name, s.parent) for s in got)
    assert {k: pairs[k] for k in nesting} == nesting
    names = {s.name for s in got}
    assert ("particle_net" in names) == (entry in ("transition", "e2e"))
    assert sum(s.name.startswith("sync.") for s in got) == n_sync
    assert all(s.start_ns <= s.end_ns for s in got)


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_profilers_clock():
    """The span's recorded interval holds the device interval of the sleep
    kernel it launched and waited for, both on the profiler's clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    profiling.reset()
    with profiled(torch.profiler.ProfilerActivity.CUDA) as prof:
        with profiling.span("warm"):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        with profiling.span("sleep"):
            torch.cuda._sleep(4_000_000)  # about 2 ms
            torch.cuda.synchronize()
    rec = {s.name: s for s in profiling.spans()}["sleep"]
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()]
    k = max(kernels, key=lambda e: e.end_ns() - e.start_ns())
    assert k.end_ns() - k.start_ns() > 500_000, k.name()
    assert rec.start_ns - 50_000 <= k.start_ns(), (rec, k.start_ns())
    assert k.end_ns() <= rec.end_ns + 50_000, (rec, k.end_ns())
