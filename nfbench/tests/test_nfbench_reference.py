"""The plain reference agrees with the port's plain versions at small
size: piece by piece, and through each cell's whole comparison on the
CPU (where the port runs its plain versions)."""

import math

import pytest
import torch

from nfbench.reference import particle_net as ref_pn
from nfbench.reference import render_net as ref_rn
from nfbench.tests.conftest import SEED


def test_ball_to_cube_and_taps_match_the_port():
    from neurofluid_torch.ops import cconv

    g = torch.Generator().manual_seed(1)
    off = torch.rand((4000, 3), generator=g) * 2 - 1
    off = off[(off * off).sum(-1) <= 1.0]
    got = ref_pn.ball_to_cube(off)
    want = cconv.ball_to_cube_volume_preserving(off)
    assert torch.allclose(got, want, atol=2e-6)
    c_got, w_got = ref_pn.taps(off)
    c_want, w_want = cconv.tap_weights(off, (4, 4, 4))
    assert torch.equal(c_got, c_want)
    assert torch.allclose(w_got, w_want, atol=2e-6)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_conv_matches_the_fused_conv(name):
    from neurofluid_torch.ops import fused_cconv as fc

    g = torch.Generator().manual_seed(2)
    pos = torch.rand((300, 3), generator=g) * 0.4 - 0.2
    feats = torch.randn((300, 8), generator=g)
    kernel = torch.randn((4, 4, 4, 8, 5), generator=g) * 0.1
    radius = 0.1125
    plan = fc.build_plan(pos, (-1.05,) * 3, (1.05, 1.05, 2.55), radius)
    pos_s = fc.sort_values(pos, plan, plan.slab_cap, fc.SENTINEL)
    f_s = fc.sort_values(feats, plan, plan.slab_cap)
    prec = "default" if name == "bf16" else "highest"
    want, cnt = fc.fused_cconv(kernel, plan, pos_s, plan, pos_s, f_s, radius,
                               True, prec)
    want = fc.unsort_values(want, plan)
    pairs = ref_pn.radius_pairs(pos, pos, radius, True)
    got = ref_pn.conv(kernel, torch.zeros(5), pos, pos, feats, pairs, radius,
                      name)
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < (1e-5 if name == "f32"
                                                      else 2e-2)
    assert torch.equal(torch.bincount(pairs.qi, minlength=300).float(),
                       fc.unsort_values(cnt, plan))


def test_local_geometry_matches_the_ball_sums():
    from neurofluid_torch.ops import ball_features as bf

    g = torch.Generator().manual_seed(3)
    parts = torch.rand((900, 3), generator=g) * 0.6 - 0.3
    q = torch.rand((500, 3), generator=g) * 0.9 - 0.45
    lower, upper, r, k = (-1.05,) * 3, (1.05, 1.05, 2.55), 0.225, 20
    sums, _ = bf.ball_feature_sums(q, parts, r, k, lower, upper,
                                   capacity_frac=1.0)
    d, s, v, n = bf.assemble_features(sums, q, r, k)[:3] + (sums[:, 0],)
    d2, s2, v2, n2 = ref_rn.local_geometry(q, parts, r, k, lower, upper)
    assert torch.equal(n2.float(), n)
    for a, b in ((d2, d), (s2, s), (v2, v)):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["tf32", "bf16"])
def test_a_lower_precision_rounds_every_nerf_product(name, monkeypatch):
    from nfbench.reference import precision

    calls = []
    apply = precision.RoundedMatmul.apply

    def counted(a, b, prec):
        calls.append(prec)
        return apply(a, b, prec)

    monkeypatch.setattr(precision.RoundedMatmul, "apply", counted)
    g = torch.Generator().manual_seed(4)
    w = {}
    for prefix in ("nerf_coarse.", "nerf_fine."):
        w.update({k: torch.randn(s, generator=g) * 0.1 for k, s in
                  _nerf_shapes(prefix).items()})
    parts = torch.rand((200, 3), generator=g) * 0.2 - 0.1
    rays = torch.cat([torch.tensor([[0.0, -10.5, 0.0]]).expand(6, 3),
                      torch.tensor([[0.0, 1.0, 0.0]]).expand(6, 3)], 1)
    rcfg = {"near": 9.0, "far": 13.0, "n_samples": 8, "n_importance": 8,
            "num_neighbors": 20, "grid_lower": (-1.05,) * 3,
            "grid_upper": (1.05, 1.05, 2.55), "search_radius": 0.225}
    ref_rn.render(w, parts, rays[0, :3], rays, rcfg, name)
    # 12 products a NeRF (8 trunk layers, sigma, the final feature, the
    # direction layer, rgb), the coarse NeRF and the fine one
    assert calls == [name] * 24


def _nerf_shapes(prefix: str) -> dict:
    from nfbench import inputs

    rn = {"nerf_width": 256, "nerf_depth": 8, "sigma_bias": 10.0}
    return {n: s for n, s, _ in inputs.render_net_specs(rn)
            if n.startswith(prefix)}


@pytest.mark.parametrize("workload", ["transition-train", "e2e-train",
                                      "warmup-train", "eval-frame"])
def test_each_cell_agrees_with_the_reference_on_the_cpu(workload, run_tiny):
    result, _ = run_tiny(workload)
    assert result["correct"] and result["failed"] == 0
    for name, check in result["checks"].items():
        assert math.isfinite(check["value"]) and check["value"] < 1e-4, name
