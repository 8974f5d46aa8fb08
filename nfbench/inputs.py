"""What a cell feeds both the program and the reference, made from the seed
on the device in a few bulk draws: the weights (by the program's parameter
names, at the configuration's widths), the fluid frames, the container,
the cameras and the rays.

The scene is the watercube stand-in of the configurations: a block of
side^3 fluid particles at the rest spacing, jittered, with small random
velocities, on the floor of NeuroFluid's container (floor and four walls
of particles with inward normals); the targets one and two steps on are
the ballistic positions plus noise. Every seed draws the same sizes; only
the values move.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream `name` of the run seeded `seed` (any
    whole number, negative or above 2**32 too)."""
    words = [ord(ch) for ch in name]
    ss = np.random.SeedSequence([abs(int(seed)) % (2 ** 128), int(seed < 0),
                                 *words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, name))


# -- weights -------------------------------------------------------------

def particle_net_specs(pn: dict) -> list:
    """(name, shape, init) of ParticleNet's parameters; init is ('glorot',
    fan) for conv kernels (Glorot uniform over taps * (Cin + Cout)),
    ('fan_in', n) for dense weights and biases (U(+-1/sqrt(n)), PyTorch's
    default), ('zero',) for conv biases."""
    ks = list(pn["kernel_size"])
    taps = math.prod(ks)
    c0 = pn["layer_channels"][0]
    specs = []

    def conv(name, cin, cout):
        specs.append((f"{name}.kernel", (*ks, cin, cout),
                      ("glorot", taps * (cin + cout))))
        specs.append((f"{name}.bias", (cout,), ("zero",)))

    def dense(name, cin, cout):
        specs.append((f"{name}.weight", (cout, cin), ("fan_in", cin)))
        specs.append((f"{name}.bias", (cout,), ("fan_in", cin)))

    conv("conv0_fluid", 4, c0)
    conv("conv0_obstacle", 3, c0)
    dense("dense0_fluid", 4, c0)
    width = 3 * c0
    for i, ch in enumerate(pn["layer_channels"][1:], start=1):
        conv(f"conv{i}", width, ch)
        dense(f"dense{i}", width, ch)
        width = ch
    return specs


def nerf_in_channels() -> tuple:
    """(xyz, direction) input widths of the NeRF: the sample (10
    frequencies), density (4), smoothed position and variance (10 each);
    the ray direction and the smoothed direction (4 each)."""
    pe = lambda c, f: c * (2 * f + 1)  # noqa: E731
    return (pe(3, 10) + pe(1, 4) + pe(3, 10) + pe(3, 10),
            pe(3, 4) + pe(3, 4))


def render_net_specs(rn: dict) -> list:
    """(name, shape, init) of RenderNet's two NeRFs: dense layers at
    PyTorch's default, the sigma bias the constant ('const', v)."""
    width, depth = rn["nerf_width"], rn["nerf_depth"]
    in_xyz, in_dir = nerf_in_channels()
    specs = []
    for prefix in ("nerf_coarse.", "nerf_fine."):
        def dense(name, cin, cout, bias=None):
            specs.append((f"{prefix}{name}.weight", (cout, cin),
                          ("fan_in", cin)))
            specs.append((f"{prefix}{name}.bias", (cout,),
                          ("const", bias) if bias is not None
                          else ("fan_in", cin)))

        for i in range(depth):
            cin = in_xyz if i == 0 else width + (in_xyz if i == 4 else 0)
            dense(f"xyz_encoding_{i + 1}.0", cin, width)
        dense("xyz_encoding_final", width, width)
        dense("sigma", width, 1, rn["sigma_bias"])
        dense("dir_encoding.0", width + in_dir, width // 2)
        dense("rgb.0", width // 2, 3)
    return specs


def draw_weights(specs: list, seed: int, name: str, device) -> dict:
    """{name: tensor} for `specs`, from one uniform draw on the device."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    u = torch.rand(total, generator=generator(seed, name, device),
                   device=device) * 2.0 - 1.0
    out, at = {}, 0
    for pname, shape, init in specs:
        n = math.prod(shape)
        if init[0] == "glorot":
            t = u[at:at + n] * math.sqrt(6.0 / init[1])
        elif init[0] == "fan_in":
            t = u[at:at + n] / math.sqrt(init[1])
        elif init[0] == "const":
            t = torch.full((n,), float(init[1]), device=device)
        else:
            t = torch.zeros(n, device=device)
        out[pname] = t.reshape(shape).contiguous()
        at += n
    return out


# -- scene ---------------------------------------------------------------

def container(scene: dict, device) -> tuple:
    """(positions (M, 3), inward normals (M, 3)) of the container's floor
    and four walls, `box_side`^2 particles each."""
    side, half, top = scene["box_side"], scene["box_half"], scene["wall_top"]
    u = np.linspace(-half, half, side, dtype=np.float32)
    a, b = (g.reshape(-1) for g in np.meshgrid(u, u, indexing="ij"))
    zw = np.linspace(-half, top, side, dtype=np.float32)
    c, h = (g.reshape(-1) for g in np.meshgrid(u, zw, indexing="ij"))
    n = a.shape[0]
    full = lambda v: np.full(n, v, np.float32)  # noqa: E731
    faces = [np.stack([a, b, full(-half)], 1),
             np.stack([full(-half), c, h], 1), np.stack([full(half), c, h], 1),
             np.stack([c, full(-half), h], 1), np.stack([c, full(half), h], 1)]
    normals = [(0, 0, 1), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)]
    pos = np.concatenate(faces)
    nrm = np.concatenate([np.tile(np.float32(v), (n, 1)) for v in normals])
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(nrm.astype(np.float32)).to(device))


def fluid_frames(scene: dict, model: dict, count: int, seed: int, device):
    """`count` frames, each (pos0, vel0, pos1, pos2) of (N, 3): the
    jittered block, its velocities, and the ballistic positions one and two
    steps on plus noise."""
    side, h = scene["fluid_side"], scene["spacing"]
    xs = (torch.arange(side, device=device) - (side - 1) / 2.0) * h
    zs = torch.arange(side, device=device) * h + scene["fluid_floor"]
    gx, gy, gz = torch.meshgrid(xs, xs, zs, indexing="ij")
    lattice = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    n = lattice.shape[0]
    noise = torch.randn((count, 4, n, 3), generator=generator(
        seed, "frames", device), device=device)
    dt = model["timestep"]
    g = torch.tensor(model["gravity"], device=device)
    frames = []
    for i in range(count):
        pos0 = lattice + scene["jitter"] * noise[i, 0]
        vel0 = scene["speed"] * noise[i, 1]
        pos1 = pos0 + vel0 * dt + 0.5 * g * dt ** 2 \
            + scene["target_noise"] * noise[i, 2]
        pos2 = pos0 + 2.0 * vel0 * dt + 2.0 * g * dt ** 2 \
            + scene["target_noise"] * noise[i, 3]
        frames.append(tuple(t.contiguous() for t in (pos0, vel0, pos1, pos2)))
    return frames


def cameras(camera: dict, count: int, seed: int, device) -> list:
    """`count` (c2w (3, 4)) poses on a circle around the container at a
    seeded azimuth, looking at the target, in the Blender convention (the
    camera looks along its -z)."""
    az = torch.rand(count, generator=generator(seed, "cameras", "cpu"),
                    dtype=torch.float64) * 2.0 * math.pi
    target = np.asarray(camera["target"], np.float64)
    out = []
    for a in az.tolist():
        eye = np.asarray([camera["distance"] * math.sin(a),
                          -camera["distance"] * math.cos(a),
                          camera["height"]])
        fwd = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.stack([right, up, -fwd, eye], 1).astype(np.float32)
        out.append(torch.from_numpy(c2w).to(device))
    return out


def pixel_rays(camera: dict, c2w: torch.Tensor) -> torch.Tensor:
    """(H * W, 6) rays [origin, unit direction] of every pixel, row-major,
    without a half-pixel offset (NeuroFluid's `get_ray_directions`)."""
    size = camera["image"]
    focal = 0.5 * size / math.tan(0.5 * camera["camera_angle_x"])
    j, i = torch.meshgrid(torch.arange(size, device=c2w.device,
                                       dtype=torch.float32),
                          torch.arange(size, device=c2w.device,
                                       dtype=torch.float32), indexing="ij")
    d = torch.stack([(i - size / 2) / focal, -(j - size / 2) / focal,
                     -torch.ones_like(i)], -1).reshape(-1, 3) @ c2w[:, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.cat([c2w[:, 3].expand(d.shape), d], -1).contiguous()


def ray_batches(camera: dict, count: int, views: int, rays: int, seed: int,
                device) -> list:
    """`count` batches of (ro (V, 3), rays (V, R, 6), target rgb (V, R, 3)):
    `views` seeded cameras each, `rays` distinct seeded pixels per view,
    targets uniform in [0, 1]."""
    poses = cameras(camera, count * views, seed, device)
    gen = generator(seed, "pixels", device)
    n_pix = camera["image"] ** 2
    rgb = torch.rand((count, views, rays, 3), generator=gen, device=device)
    out = []
    for b in range(count):
        ro, rv = [], []
        for v in range(views):
            c2w = poses[b * views + v]
            pick = torch.randperm(n_pix, generator=gen, device=device)[:rays]
            rv.append(pixel_rays(camera, c2w)[pick])
            ro.append(c2w[:, 3])
        out.append((torch.stack(ro), torch.stack(rv).contiguous(),
                    rgb[b].contiguous()))
    return out
