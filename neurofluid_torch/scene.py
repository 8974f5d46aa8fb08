"""The bench working point of the repository (a copy of
`bench.build_problem`, numpy only, so the port needs neither bench.py nor
the JAX package).

- fluid: 14,336 particles of a jittered lattice at the rest spacing 0.05;
- box: 2,520 container floor and wall particles with inward normals (at
  most N_BOX; the two y-walls keep 84 particles each, since their axis swap
  indexes the wrong axis of the (28, 28, 3) face as `bench.py` does);
- rays: 1,024 random pixels of a 400 x 400 pinhole camera at the
  reference's viewing distance (near 9, far 13).
"""

from __future__ import annotations

import numpy as np

N_PARTICLES = 14_336
N_BOX = 4_096
N_RAYS = 1024
N_VIEWS = 1


def particle_net_kwargs() -> dict:
    """ParticleNet settings of the bench point (z-up gravity)."""
    return dict(gravity=(0.0, 0.0, -9.81), fused_group_size=16,
                fused_slab_cap=128, fused_cell_scale=1.0)


def build_problem():
    """(pos, vel, box, normals, ro (V, 3), rays (V, R, 6), rgbs (V, R, 3)),
    all float32, from seed 10."""
    rng = np.random.default_rng(10)
    # 24 x 24 x 25 lattice at 0.05 spacing = 14400 sites; keep N_PARTICLES
    xs = (np.arange(24) - 11.5) * 0.05
    zs = np.arange(25) * 0.05 - 0.9
    gx, gy, gz = np.meshgrid(xs, xs, zs, indexing="ij")
    pos = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    pos += rng.normal(scale=0.004, size=pos.shape).astype(np.float32)
    pos = pos[rng.permutation(len(pos))[:N_PARTICLES]]
    vel = (rng.normal(size=(N_PARTICLES, 3)) * 0.1).astype(np.float32)

    # container walls (floor + 4 sides), inward normals
    side = int(np.sqrt(N_BOX / 5))
    u = np.linspace(-0.975, 0.975, side, dtype=np.float32)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    faces, normals = [], []
    floor = np.stack([uu, vv, np.full_like(uu, -0.975)], -1).reshape(-1, 3)
    faces.append(floor)
    normals.append(np.tile([0, 0, 1.0], (len(floor), 1)))
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
        w = np.stack([uu * 0 + 0.975 * -sign, vv, uu * 0.7], -1)
        if axis == 1:
            w = w[:, [1, 0, 2]]
        wall = w.reshape(-1, 3)
        n = np.zeros(3, np.float32)
        n[axis] = sign
        faces.append(wall)
        normals.append(np.tile(n, (len(wall), 1)))
    box = np.concatenate(faces)[:N_BOX].astype(np.float32)
    nrm = np.concatenate(normals)[:N_BOX].astype(np.float32)

    # pinhole camera at the reference viewing distance, random pixel subset
    cam = np.asarray([0.0, -10.5, 1.0], np.float32)
    fwd = np.asarray([0.0, 0.0, -0.2], np.float32) - cam
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    w_img, focal = 400, 400 * 2.2  # box spans ~1/5 of the image like the ref
    ro = np.tile(cam, (N_VIEWS, 1))
    rays_all = []
    for _ in range(N_VIEWS):
        px = rng.integers(0, w_img, N_RAYS)
        py = rng.integers(0, w_img, N_RAYS)
        d = (
            (px[:, None] - w_img / 2) / focal * right[None]
            + (py[:, None] - w_img / 2) / focal * up[None]
            + fwd[None]
        ).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rays_all.append(np.concatenate([np.tile(cam, (N_RAYS, 1)), d], -1))
    rays = np.stack(rays_all)
    rgbs = rng.uniform(size=(N_VIEWS, N_RAYS, 3)).astype(np.float32)
    return pos, vel, box, nrm, ro, rays, rgbs
