"""work.py's counts on a tiny scene equal a count made by brute force."""

import itertools
import math

import torch

from nfbench import inputs, work
from nfbench.reference import particle_net as ref_pn
from nfbench.tests.conftest import ROOT, SEED
from nfbench.harness import load_parts


def parts():
    p = load_parts(ROOT, "e2e-train")
    p.config["scene"].update(fluid_side=4, box_side=4)
    return p


def test_pairs_equal_a_double_loop():
    cfg = parts().config
    pn = cfg["particle_net"]
    pos = inputs.fluid_frames(cfg["scene"], pn, 1, SEED, "cpu")[0][0]
    box, _ = inputs.container(cfg["scene"], "cpu")
    r = 3.0 * pn["radius_scale"] * pn["particle_radius"]
    for cands, excl in ((pos, True), (box, False)):
        brute = sum(1 for a, b in itertools.product(pos.tolist(),
                                                    cands.tolist())
                    if 0 < math.dist(a, b) ** 2 / r ** 2 <= 1
                    or (not excl and math.dist(a, b) == 0))
        assert ref_pn.radius_pairs(pos, cands, r, excl).qi.numel() == brute


def test_conv_work_equals_a_sum_over_pairs_and_taps():
    pn = parts().config["particle_net"]
    n, nb, ff, fb = 64, 80, 700, 90
    ops, _ = work.conv_work(pn, n, nb, ff, fb, backward=False)
    brute = 0
    for name, cin, cout, cand in work.conv_layers(pn):
        pairs = ff if cand == "fluid" else fb
        for _ in range(pairs):  # a pair adds 8 taps x Cin multiply-adds
            brute += 2 * 8 * cin
        brute += 2 * n * 64 * cin * cout  # the fold, per query
    assert ops == brute
    ops_b, _ = work.conv_work(pn, n, nb, ff, fb, backward=True)
    assert ops_b == 3 * brute


def test_nerf_work_equals_the_programs_layers():
    from neurofluid_torch.models.render_net import RenderNet

    rn = parts().config["render_net"]
    net = RenderNet(device="cpu")
    in_xyz, in_dir = inputs.nerf_in_channels()
    assert (in_xyz, in_dir) == (net.in_channels_xyz, net.in_channels_dir)
    macs = sum(m.weight.numel() for m in net.nerf_fine.modules()
               if isinstance(m, torch.nn.Linear))
    assert work.nerf_macs(in_xyz, in_dir, rn["nerf_depth"],
                          rn["nerf_width"]) == macs
    rays = 10
    assert work.render_ops(rn, in_xyz, in_dir, rays, False) == \
        2 * macs * rays * (2 * rn["n_samples"] + rn["n_importance"])


def test_particle_net_specs_match_the_program():
    from neurofluid_torch.models.particle_net import ParticleNet

    pn = parts().config["particle_net"]
    net = ParticleNet(device="cpu")
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert {n: tuple(s) for n, s, _ in inputs.particle_net_specs(pn)} == shapes
    assert sum(v.numel() for v in net.parameters() if v.dim() == 5) == sum(
        64 * cin * cout for _, cin, cout, _ in work.conv_layers(pn))
