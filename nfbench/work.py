"""The yardstick's arithmetic: operations and bytes of the work a cell
does, counted from the configuration's widths and the run's shapes and
pairs, never from how a kernel computes it.

Conventions (copied in spirit from the bench script's `bound_ms` and
`nbytes`, with the operations counted at the configuration's precision):
- bytes: each input read once and each output written once, at the width
  the layer is given it (f32 tensors: 4 bytes);
- operations: a multiply-add is 2. A continuous conv does, per in-radius
  pair, 8 trilinear taps times Cin multiply-adds, and per query the fold,
  taps * Cin * Cout; its backward twice that (the filter's and the
  features' cotangents: d_acc and dW the size of the fold, the tap-weight
  cotangent and dfeats the size of the taps). The pair geometry, padding
  and recomputation (K2 recomputes K1's sums) are not counted, so a share
  can only read low;
- a dense layer is 2 * in * out per row forward, three times that with
  its backward.
"""

from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
F32 = 4

CONV_KERNELS = r"walk_fwd|walk_bwd|split_gemm|sum_splits|to_bf16_kernel"
RENDER_KERNELS = r"ball_sums_kernel|ball_sums_bwd_kernel|" \
                 r"composite_weights_kernel|composite_weights_bwd_kernel"


def bound_s(n_bytes: float, n_ops: float, peak_flops: float) -> float:
    """The least time the card could take: bytes at the memory's rate or
    operations at `peak_flops`, whichever is longer."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / peak_flops)


def conv_layers(pn: dict) -> list:
    """(name, Cin, Cout, candidate set) of ParticleNet's convs."""
    c0 = pn["layer_channels"][0]
    layers = [("conv0_fluid", 4, c0, "fluid"), ("conv0_obstacle", 3, c0, "box")]
    width = 3 * c0
    for i, ch in enumerate(pn["layer_channels"][1:], start=1):
        layers.append((f"conv{i}", width, ch, "fluid"))
        width = ch
    return layers


def conv_work(pn: dict, n_fluid: int, n_box: int, fluid_pairs: float,
              box_pairs: float, backward: bool) -> tuple:
    """(ops, bytes) of one ParticleNet step's five convs, forward and, with
    `backward`, their backward."""
    taps = math.prod(pn["kernel_size"])
    ops = n_bytes = 0.0
    for _, cin, cout, cand in conv_layers(pn):
        pairs = fluid_pairs if cand == "fluid" else box_pairs
        nc = n_fluid if cand == "fluid" else n_box
        tap_ops = 2.0 * 8 * cin * pairs
        fold_ops = 2.0 * n_fluid * taps * cin * cout
        io = F32 * (3 * (n_fluid + nc) + nc * cin + taps * cin * cout)
        ops += tap_ops + fold_ops
        n_bytes += io + F32 * n_fluid * cout
        if backward:
            ops += 2.0 * (tap_ops + fold_ops)
            n_bytes += io + F32 * (n_fluid * cout + taps * cin * cout
                                   + nc * cin + 3 * (n_fluid + nc))
    return ops, n_bytes


def dense_ops(pn: dict, n_fluid: int, backward: bool) -> float:
    """Operations of ParticleNet's dense layers on one step."""
    c0 = pn["layer_channels"][0]
    macs = 4 * c0
    width = 3 * c0
    for ch in pn["layer_channels"][1:]:
        macs += width * ch
        width = ch
    return 2.0 * n_fluid * macs * (3 if backward else 1)


def nerf_macs(in_xyz: int, in_dir: int, depth: int, width: int) -> int:
    """Multiply-adds of one NeRF evaluation of one sample."""
    macs = 0
    for i in range(depth):
        cin = in_xyz if i == 0 else width + (in_xyz if i == 4 else 0)
        macs += cin * width
    macs += width * width + width + (width + in_dir) * (width // 2) \
        + (width // 2) * 3
    return macs


def render_ops(rn: dict, in_xyz: int, in_dir: int, rays: int,
               backward: bool) -> float:
    """NeRF operations of one coarse + fine render of `rays` rays."""
    macs = nerf_macs(in_xyz, in_dir, rn["nerf_depth"], rn["nerf_width"])
    samples = rays * (2 * rn["n_samples"] + rn["n_importance"])
    return 2.0 * macs * samples * (3 if backward else 1)


def render_kernel_bytes(rn: dict, rays: int, n_particles: int,
                        particle_grad: bool, backward: bool) -> float:
    """Bytes K3 and K5 (and with `backward` K6, and K4 where the particles
    take a gradient) move in one coarse + fine render."""
    s0, s1 = rn["n_samples"], rn["n_importance"]
    total = 0.0
    for q in (rays * s0, rays * s1):  # K3 per pass, and K4
        total += F32 * (3 * q + 3 * n_particles + 13 * q)
        if backward and particle_grad:
            total += F32 * (13 * q + 3 * q + 3 * n_particles + 3 * n_particles)
    for s in (s0, s0 + s1):  # K5 per pass, and K6
        total += F32 * (3 * rays * s + rays)
        if backward:
            total += F32 * (4 * rays * s + rays)
    return total
