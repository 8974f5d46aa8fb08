"""Synthetic fluid scene generator (host-side, numpy; a copy of
neurofluid_tpu/data/synthetic.py, which the port cannot import: importing
that package imports JAX). From the same seed both write the same files.

The reference ships no data generator that runs without the SPlisHSPlasH C++
binaries (reference data_generation/create_physics_scenes.py drives
`DynamicBoundarySimulator`). This module provides a dependency-free stand-in
producing the SAME on-disk layouts the datasets consume, so the full training
/ eval stack can run end-to-end (tests, demos, benchmarks):

- Blender layout (reference datasets/dataset.py): per-view dirs with
  transforms_{split}.json, RGBA frame PNGs, per-frame particle .npz, and a
  scene-level bounding-box file,
- raw layout (reference datasets/dataset_splishsplash_rawdata.py:103-122):
  sim*/output/fluid_*.npz + box file.

Scene scale mirrors the reference protocol: z-up container x,y in [-1, 1],
z in [-1, 2.4552], gravity (0, 0, -9.81), dt = 1/50, particle radius 0.025,
cameras ~11 units away (near 9, far 13) looking at the container
(reference configs/dataset.yaml:1-20, trainer/basetrainer.py:58-62).

Images are rendered with a painter's-algorithm particle splatter — enough
optical structure (silhouette + depth shading) for renderer training to have
a learnable signal.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle

import numpy as np

DT = 1.0 / 50.0
GRAVITY = np.asarray([0.0, 0.0, -9.81], np.float32)
PARTICLE_RADIUS = 0.025
BOX_MIN = np.asarray([-0.975, -0.975, -0.975], np.float32)
BOX_MAX = np.asarray([0.975, 0.975, 2.4302], np.float32)


def make_fluid_blob(n_side: int = 8, center=(0.0, 0.0, 0.8), spacing=0.05, jitter=0.002,
                    seed: int = 10):
    rng = np.random.default_rng(seed)
    g = np.arange(n_side, dtype=np.float32) * spacing
    g -= g.mean()
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([x, y, z], -1).reshape(-1, 3) + np.asarray(center, np.float32)
    pos += rng.normal(scale=jitter, size=pos.shape).astype(np.float32)
    vel = np.zeros_like(pos)
    return pos, vel


def make_box(spacing: float = 0.1, wall_height: float = 1.2):
    """Boundary particles on the floor + 4 walls with inward normals."""
    xs = np.arange(BOX_MIN[0], BOX_MAX[0] + 1e-6, spacing, dtype=np.float32)
    ys = np.arange(BOX_MIN[1], BOX_MAX[1] + 1e-6, spacing, dtype=np.float32)
    zs = np.arange(BOX_MIN[2], wall_height + 1e-6, spacing, dtype=np.float32)

    pts, nrm = [], []
    fx, fy = np.meshgrid(xs, ys, indexing="ij")
    floor = np.stack([fx, fy, np.full_like(fx, BOX_MIN[2])], -1).reshape(-1, 3)
    pts.append(floor)
    nrm.append(np.tile([0.0, 0.0, 1.0], (len(floor), 1)))

    for sign, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
        u, v = np.meshgrid(xs if axis == 1 else ys, zs, indexing="ij")
        wall = np.zeros((u.size, 3), np.float32)
        wall[:, axis] = BOX_MIN[axis] if sign > 0 else BOX_MAX[axis]
        wall[:, 1 - axis] = u.reshape(-1)
        wall[:, 2] = v.reshape(-1)
        normal = np.zeros(3, np.float32)
        normal[axis] = float(sign)
        pts.append(wall)
        nrm.append(np.tile(normal, (len(wall), 1)))

    return (
        np.concatenate(pts).astype(np.float32),
        np.concatenate(nrm).astype(np.float32),
    )


def simulate(pos, vel, n_frames: int, restitution: float = 0.3, seed: int = 10,
             gravity=None, bounds=None):
    """Ballistic fall with damped floor/wall bounces + mild pressure jitter.

    `gravity` (3,) and `bounds` ((lower, upper)) default to the z-up container
    constants; the randomized scene generator passes the reference's y-up sim
    convention instead.

    Returns (positions (F, N, 3), velocities (F, N, 3)) including the initial
    state as frame 0.
    """
    rng = np.random.default_rng(seed)
    g = GRAVITY if gravity is None else np.asarray(gravity, np.float32)
    bmin, bmax = (BOX_MIN, BOX_MAX) if bounds is None else (
        np.asarray(bounds[0], np.float32), np.asarray(bounds[1], np.float32)
    )
    p, v = pos.copy(), vel.copy()
    out_p, out_v = [p.copy()], [v.copy()]
    lo = bmin + PARTICLE_RADIUS
    hi = bmax - PARTICLE_RADIUS
    for _ in range(n_frames - 1):
        v = v + g * DT
        p = p + v * DT
        for ax in range(3):
            low = p[:, ax] < lo[ax]
            high = p[:, ax] > hi[ax]
            p[low, ax] = lo[ax]
            p[high, ax] = hi[ax]
            v[low, ax] *= -restitution
            v[high, ax] *= -restitution
        v += rng.normal(scale=1e-3, size=v.shape).astype(np.float32)
        out_p.append(p.copy())
        out_v.append(v.copy())
    return np.stack(out_p), np.stack(out_v)


def _poly6(r2, h):
    """Poly6 density kernel (unnormalized mass=1 convention)."""
    k = 315.0 / (64.0 * np.pi * h**9)
    return np.where(r2 < h * h, k * (h * h - r2) ** 3, 0.0)


def _spiky_grad_coeff(r, h):
    """|gradW_spiky| / r coefficient (safe at r -> 0)."""
    k = -45.0 / (np.pi * h**6)
    out = np.where(r < h, k * (h - r) ** 2 / np.maximum(r, 1e-8), 0.0)
    return out


def _rest_density(h, spacing):
    """Self-calibrated rest density: poly6 sum over a filled lattice at the
    rest spacing (mass = 1), evaluated at an interior particle."""
    n = int(np.ceil(h / spacing)) + 1
    g = np.arange(-n, n + 1, dtype=np.float64) * spacing
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    r2 = (x**2 + y**2 + z**2).reshape(-1)
    return float(np.sum(_poly6(r2, h)))


def simulate_pbf(
    pos,
    vel,
    n_frames: int,
    gravity=None,
    bounds=None,
    seed: int = 10,
    rest_spacing: float = 0.05,
    substeps: int = 2,
    iterations: int = 4,
    xsph_c: float = 0.05,
):
    """Position-based fluids (Macklin & Mueller 2013) — the fluid-realistic
    stand-in for the reference's DFSPH ground truth (role of reference
    data_generation/create_physics_scenes.py:257-263 when no SPlisHSPlasH
    binary exists). Unlike `simulate` (ballistic fall + damped bounces), this
    produces incompressible sloshing: per substep, predict positions under
    gravity, then solve `iterations` Jacobi iterations of the density
    constraint C_i = rho_i/rho0 - 1 = 0 with the standard artificial-pressure
    term (prevents particle clumping), then derive velocities from the
    position change, plus XSPH viscosity smoothing.

    Host-side numpy + scipy cKDTree (eval/data-gen path, not device compute).
    Returns (positions (F, N, 3), velocities (F, N, 3)), frame 0 = input.
    """
    from scipy.spatial import cKDTree

    g = GRAVITY if gravity is None else np.asarray(gravity, np.float64)
    bmin, bmax = (BOX_MIN, BOX_MAX) if bounds is None else (
        np.asarray(bounds[0], np.float64), np.asarray(bounds[1], np.float64)
    )
    lo = bmin + PARTICLE_RADIUS
    hi = bmax - PARTICLE_RADIUS
    h = 2.0 * rest_spacing
    rho0 = _rest_density(h, rest_spacing)
    # artificial pressure: s_corr = -k (W(r)/W(dq))^n, dq = 0.3 h. k is
    # expressed in units of a typical |lambda| (the paper's k=0.1 assumes
    # unit-scale kernels; our kernels are SI-normalized, so lambda's scale is
    # set by 1 / (sum |gradW|^2 / rho0^2) and k must follow it).
    w_dq = _poly6(np.asarray((0.3 * h) ** 2), h)
    n_corr = 4
    dt_s = DT / substeps
    eps_lambda = 100.0
    max_dp = 0.25 * h  # per-iteration displacement clamp (stability guard)

    p = pos.astype(np.float64).copy()
    v = vel.astype(np.float64).copy()
    n = len(p)
    out_p, out_v = [p.astype(np.float32)], [v.astype(np.float32)]

    for _ in range(n_frames - 1):
        for _s in range(substeps):
            v = v + g * dt_s
            p_old = p
            x = np.clip(p + v * dt_s, lo, hi)

            pairs = cKDTree(x).query_pairs(h, output_type="ndarray")
            ii, jj = pairs[:, 0], pairs[:, 1]

            for _it in range(iterations):
                d = x[ii] - x[jj]
                r2 = np.sum(d * d, axis=1)
                r = np.sqrt(r2)
                w = _poly6(r2, h)
                gcoef = _spiky_grad_coeff(r, h)  # gradW = gcoef * d
                grad = gcoef[:, None] * d

                rho = np.full(n, _poly6(np.zeros(1), h)[0])
                np.add.at(rho, ii, w)
                np.add.at(rho, jj, w)
                c = rho / rho0 - 1.0

                # sum_j |gradW_ij|^2 and |sum_j gradW_ij|^2 per particle
                gsum = np.zeros((n, 3))
                np.add.at(gsum, ii, grad)
                np.add.at(gsum, jj, -grad)
                g2sum = np.zeros(n)
                gnorm2 = np.sum(grad * grad, axis=1)
                np.add.at(g2sum, ii, gnorm2)
                np.add.at(g2sum, jj, gnorm2)
                denom = (g2sum + np.sum(gsum * gsum, axis=1)) / rho0**2
                lam = -np.maximum(c, 0.0) / (denom + eps_lambda)

                lam_scale = 1.0 / (np.median(denom) + eps_lambda)
                s_corr = -0.02 * lam_scale * (w / max(w_dq, 1e-12)) ** n_corr
                coef = (lam[ii] + lam[jj] + s_corr)[:, None] * grad / rho0
                dp = np.zeros((n, 3))
                np.add.at(dp, ii, coef)
                np.add.at(dp, jj, -coef)
                dp = np.clip(dp, -max_dp, max_dp)
                x = np.clip(x + dp, lo, hi)

            v = (x - p_old) / dt_s
            # XSPH viscosity on the final neighbor set
            d = x[ii] - x[jj]
            w = _poly6(np.sum(d * d, axis=1), h)
            dv = np.zeros((n, 3))
            rel = v[jj] - v[ii]
            np.add.at(dv, ii, (w / rho0)[:, None] * rel)
            np.add.at(dv, jj, -(w / rho0)[:, None] * rel)
            v = v + xsph_c * dv
            p = x
        out_p.append(p.astype(np.float32))
        out_v.append(v.astype(np.float32))
    return np.stack(out_p), np.stack(out_v)


def look_at_c2w(cam_pos, target=(0.0, 0.0, 0.5), up=(0.0, 0.0, 1.0)):
    """Blender-convention camera-to-world (camera looks along -z)."""
    cam_pos = np.asarray(cam_pos, np.float64)
    forward = np.asarray(target, np.float64) - cam_pos
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    # columns: x=right, y=up, z=-forward (camera looks along -z)
    rot = np.stack([right, true_up, -forward], axis=1)
    c2w = np.concatenate([rot, cam_pos[:, None]], axis=1)
    return c2w.astype(np.float32)


def render_particle_image(
    pos: np.ndarray,
    c2w: np.ndarray,
    focal: float,
    wh: tuple,
    base_color=(0.35, 0.55, 0.95),
    splat_scale: float = 2.2,
):
    """Painter's-algorithm splatter -> (H, W, 4) uint8 RGBA."""
    w, h = wh
    rot = c2w[:, :3].astype(np.float64)
    t = c2w[:, 3].astype(np.float64)
    cam = (pos.astype(np.float64) - t) @ rot  # world -> camera
    z = -cam[:, 2]
    valid = z > 1e-3
    rgb = np.zeros((h, w, 3), np.float64)
    alpha = np.zeros((h, w), np.float64)

    order = np.argsort(-z)  # far to near (painter's algorithm)
    zmin, zmax = (z[valid].min(), z[valid].max()) if valid.any() else (1.0, 2.0)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in order:
        if not valid[i]:
            continue
        u = w / 2 + focal * cam[i, 0] / z[i]
        v = h / 2 - focal * cam[i, 1] / z[i]
        r_pix = max(1.0, splat_scale * focal * PARTICLE_RADIUS / z[i])
        x0, x1 = int(max(0, u - 3 * r_pix)), int(min(w, u + 3 * r_pix + 1))
        y0, y1 = int(max(0, v - 3 * r_pix)), int(min(h, v + 3 * r_pix + 1))
        if x0 >= x1 or y0 >= y1:
            continue
        d2 = (xx[y0:y1, x0:x1] - u) ** 2 + (yy[y0:y1, x0:x1] - v) ** 2
        a = 0.85 * np.exp(-0.5 * d2 / (r_pix * r_pix))
        shade = 0.55 + 0.45 * (zmax - z[i]) / max(zmax - zmin, 1e-6)
        color = np.asarray(base_color) * shade
        rgb[y0:y1, x0:x1] = a[..., None] * color + (1 - a[..., None]) * rgb[y0:y1, x0:x1]
        alpha[y0:y1, x0:x1] = a + (1 - a) * alpha[y0:y1, x0:x1]

    out = np.zeros((h, w, 4), np.uint8)
    safe = np.maximum(alpha, 1e-6)[..., None]
    out[..., :3] = np.clip(rgb / safe * 255, 0, 255).astype(np.uint8)
    out[..., 3] = np.clip(alpha * 255, 0, 255).astype(np.uint8)
    return out


def write_blender_scene(
    root: str,
    positions: np.ndarray,
    velocities: np.ndarray,
    box: np.ndarray,
    box_normals: np.ndarray,
    cameras: dict,
    images: dict,
    *,
    test_views: tuple,
    camera_angle_x: float,
) -> None:
    """Write given frames as a Blender-layout scene (reference
    datasets/dataset.py's layout, which `BlenderDataset` reads).

    positions, velocities: (F, N, 3) particle frames; box, box_normals:
    (M, 3) boundary particles and their normals; cameras: {view: c2w
    (3, 4)} in the Blender convention, one static camera a view, the views
    in order; images: {view: F RGBA or RGB uint8 images (H, W, 4|3)}. A
    view in `test_views` keeps its images under `test/`, any other under
    `train/`; each view gets both split files and both splits' particle
    files, so that train and test readers work on any view."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    np.savez(
        osp.join(root, "box.npz"),
        box=np.asarray(box, np.float32),
        box_normals=np.asarray(box_normals, np.float32),
    )
    n_frames = len(positions)
    for view, c2w in cameras.items():
        view_dir = osp.join(root, view)
        split = "test" if view in test_views else "train"
        for actual_split in ("train", "test"):
            os.makedirs(osp.join(view_dir, actual_split, "particles"), exist_ok=True)

        mat = np.concatenate(
            [np.asarray(c2w, np.float32), np.asarray([[0, 0, 0, 1]], np.float32)], 0
        ).tolist()
        frames = []
        for f in range(n_frames):
            file_path = f"{split}/r_{f}"
            Image.fromarray(np.asarray(images[view][f], np.uint8)).save(
                osp.join(view_dir, f"{file_path}.png"))
            frames.append(
                {
                    "file_path": file_path,
                    "particle_path": f"particles/{f}.npz",
                    "transform_matrix": mat,
                }
            )
        meta = {
            "camera_angle_x": camera_angle_x,
            "bounding_box": "box.npz",
            "frames": frames,
        }
        for actual_split in (split, "train" if split == "test" else "test"):
            for f in range(n_frames):
                np.savez(
                    osp.join(view_dir, actual_split, f"particles/{f}.npz"),
                    pos=positions[f],
                    vel=velocities[f],
                )
            with open(osp.join(view_dir, f"transforms_{actual_split}.json"), "w") as fp:
                json.dump(meta, fp)


def generate_blender_scene(
    root: str,
    n_frames: int = 12,
    n_side: int = 6,
    img_wh: tuple = (100, 100),
    train_views: tuple = ("view_1", "view_2", "view_3", "view_4"),
    test_views: tuple = ("view_5",),
    camera_distance: float = 11.0,
    camera_angle_x: float = 0.32,
    seed: int = 10,
    method: str = "ballistic",
) -> dict:
    """Simulate a fluid blob, render it from cameras on a circle and write
    the full Blender-layout scene (`write_blender_scene`); returns scene
    metadata.

    method: 'ballistic' (fast, for tests) or 'pbf' (fluid-realistic
    position-based fluids; use for protocol/quality runs)."""
    pos0, vel0 = make_fluid_blob(n_side=n_side, seed=seed)
    sim = simulate_pbf if method == "pbf" else simulate
    positions, velocities = sim(pos0, vel0, n_frames, seed=seed)
    box, box_normals = make_box()

    focal = 0.5 * img_wh[0] / np.tan(0.5 * camera_angle_x)
    all_views = list(train_views) + list(test_views)
    cameras, images = {}, {}
    for vi, view in enumerate(all_views):
        angle = 2 * np.pi * vi / max(len(all_views), 1)
        cam_pos = np.asarray(
            [
                camera_distance * np.cos(angle),
                camera_distance * np.sin(angle),
                0.5 + 0.25 * camera_distance,
            ]
        )
        cam_pos *= camera_distance / np.linalg.norm(cam_pos - np.asarray([0, 0, 0.5]))
        cameras[view] = look_at_c2w(cam_pos)
        images[view] = [render_particle_image(positions[f], cameras[view], focal, img_wh)
                        for f in range(n_frames)]
    write_blender_scene(root, positions, velocities, box, box_normals, cameras,
                        images, test_views=tuple(test_views),
                        camera_angle_x=camera_angle_x)

    return {
        "positions": positions,
        "velocities": velocities,
        "box": box,
        "box_normals": box_normals,
        "focal": focal,
        "train_views": list(train_views),
        "test_views": list(test_views),
    }


def generate_raw_dataset(root: str, n_sims: int = 2, n_frames: int = 8, n_side: int = 5,
                         seed: int = 10) -> None:
    """Write the raw SplishSplash-style layout for ParticleDataset
    (reference datasets/dataset_splishsplash_rawdata.py:103-122)."""
    box, box_normals = make_box()
    for s in range(n_sims):
        sim_dir = osp.join(root, f"sim_{s:04d}")
        os.makedirs(osp.join(sim_dir, "output"), exist_ok=True)
        pos0, vel0 = make_fluid_blob(n_side=n_side, seed=seed + s)
        positions, velocities = simulate(pos0, vel0, n_frames, seed=seed + s)
        for f in range(n_frames):
            np.savez(
                osp.join(sim_dir, "output", f"fluid_{f:04d}.npz"),
                pos=positions[f],
                vel=velocities[f],
            )
        with open(osp.join(sim_dir, "box.pt"), "wb") as fp:
            pickle.dump({"box": box, "box_normals": box_normals}, fp)


def generate_pbf_raw_dataset(
    root: str,
    n_sims: int = 12,
    n_frames: int = 50,
    n_side: int = 24,
    seed: int = 10,
    log=None,
) -> None:
    """Randomized multi-scene PBF pretraining set in the raw layout.

    The reference pretrains its transition model over 270 randomized DFSPH
    simulations (reference README.md:88-90, run.sh,
    data_generation/create_physics_scenes.py); this writes the budget-scaled
    counterpart: `n_sims` position-based-fluids sims (data/synthetic.py::
    simulate_pbf) with randomized initial blob placement and velocity, all at
    the SAME particle count (n_side^3), so that one train step of static
    shapes (the JAX package compiles one) serves every scene; placement,
    velocity and impact diversity is what decorrelates the dynamics, not
    count.

    Layout: sim_XXXX/output/fluid_FFFF.npz + box.pt per sim (reference
    datasets/dataset_splishsplash_rawdata.py:103-122), consumed by
    ParticleDataset(data_type='raw').
    """
    box, box_normals = make_box()
    rng = np.random.default_rng(seed)
    half = 0.5 * (n_side - 1) * 0.05
    for s in range(n_sims):
        sim_dir = osp.join(root, f"sim_{s:04d}")
        os.makedirs(osp.join(sim_dir, "output"), exist_ok=True)
        # random placement inside the container (blob must fit with margin)
        cx, cy = rng.uniform(-0.9 + half, 0.9 - half, size=2)
        # center height: blob rests just above the floor up to a ~1.2 m drop,
        # never clipped against the container ceiling (z <= 2.43)
        cz = rng.uniform(-0.9 + half, 1.8 - half)
        pos0, vel0 = make_fluid_blob(
            n_side=n_side, center=(cx, cy, cz), seed=seed + s
        )
        # random initial push (the reference samples initial velocities for
        # its fluid blocks, create_physics_scenes.py)
        vel0 = vel0 + rng.uniform([-1.5, -1.5, -0.5], [1.5, 1.5, 0.0])
        vel0 = vel0.astype(np.float32)
        # skip-complete: all rng draws above already happened, so growing
        # n_sims later reuses existing sims bit-identically and only
        # simulates the new ones
        last = osp.join(sim_dir, "output", f"fluid_{n_frames - 1:04d}.npz")
        if osp.exists(last) and osp.exists(osp.join(sim_dir, "box.pt")):
            if log is not None:
                log(f"pbf sim {s + 1}/{n_sims} already complete, skipped")
            continue
        positions, velocities = simulate_pbf(
            pos0, vel0, n_frames, seed=seed + s
        )
        for f in range(n_frames):
            np.savez(
                osp.join(sim_dir, "output", f"fluid_{f:04d}.npz"),
                pos=positions[f],
                vel=velocities[f],
            )
        with open(osp.join(sim_dir, "box.pt"), "wb") as fp:
            pickle.dump({"box": box, "box_normals": box_normals}, fp)
        if log is not None:
            log(f"pbf sim {s + 1}/{n_sims} done ({len(pos0)} particles, "
                f"{n_frames} frames)")
