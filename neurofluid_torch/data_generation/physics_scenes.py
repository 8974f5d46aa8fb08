"""Ground-truth physics scene generation (runs SPlisHSPlasH).

Host-side offline tooling (a copy of
neurofluid_tpu/data_generation/physics_scenes.py) mirroring the reference's
scene generator (reference data_generation/create_physics_scenes.py): build
randomized DFSPH scene descriptions, run the external
`DynamicBoundarySimulator` C++ binary, and convert its .bgeo outputs into
the per-frame fluid_XXXX.npz + box.npz layout the datasets consume.

The simulator binaries are external C++ tools (as in the reference,
data_generation/splishsplash_config.py); when they are absent this module
still provides scene-description building, box sampling, and bgeo->npz
conversion (via the pure-python bgeo reader), and
`neurofluid_torch.data.synthetic` provides a dependency-free fallback
generator.
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
import subprocess

import numpy as np

from neurofluid_torch.data_generation import bgeo

# physical parameters mirrored from the reference scene description
# (reference create_physics_scenes.py:35-59)
PARTICLE_RADIUS = 0.025
DEFAULT_SCENE = {
    "Configuration": {
        "pause": False,
        "stopAt": 1.2,
        "particleRadius": PARTICLE_RADIUS,
        "numberOfStepsPerRenderUpdate": 1,
        "density0": 1000,
        "simulationMethod": 4,  # DFSPH
        "gravitation": [0, -9.81, 0],
        "cflMethod": 0,
        "cflFactor": 1,
        "cflMaxTimeStepSize": 0.005,
        "maxIterations": 100,
        "maxError": 0.01,
        "maxIterationsV": 100,
        "maxErrorV": 0.1,
        "stiffness": 50000,
        "exponent": 7,
        "velocityUpdateMethod": 0,
        "enableDivergenceSolver": True,
        "enablePartioExport": True,
        "enableRigidBodyExport": True,
        "particleFPS": 50.0,
        "partioAttributes": "density;velocity",
    },
    "Simulation": {
        "timeStepSize": 0.001,
        "viscosity": 0.08,
        "viscosityMethod": 3,
        "boundaryHandlingMethod": 2,
    },
}


def simulator_binaries():
    """Locate the external SPlisHSPlasH binaries via env vars or PATH
    (role of reference data_generation/splishsplash_config.py)."""
    import shutil

    sim = os.environ.get("SPLISHSPLASH_SIMULATOR") or shutil.which(
        "DynamicBoundarySimulator"
    )
    vol = os.environ.get("SPLISHSPLASH_VOLUME_SAMPLING") or shutil.which(
        "VolumeSampling"
    )
    return sim, vol


def sample_box_surface(lower, upper, spacing: float):
    """Boundary particles covering all 6 faces of an axis-aligned box with
    inward normals (role of the Poisson-disk surface sampling in reference
    create_physics_scenes.py:170-180)."""
    lower = np.asarray(lower, np.float32)
    upper = np.asarray(upper, np.float32)
    pts, nrm = [], []
    for axis in range(3):
        u_ax, v_ax = [a for a in range(3) if a != axis]
        us = np.arange(lower[u_ax], upper[u_ax] + 1e-6, spacing, dtype=np.float32)
        vs = np.arange(lower[v_ax], upper[v_ax] + 1e-6, spacing, dtype=np.float32)
        uu, vv = np.meshgrid(us, vs, indexing="ij")
        for side, coord, sign in ((0, lower[axis], 1.0), (1, upper[axis], -1.0)):
            face = np.zeros((uu.size, 3), np.float32)
            face[:, axis] = coord
            face[:, u_ax] = uu.reshape(-1)
            face[:, v_ax] = vv.reshape(-1)
            normal = np.zeros(3, np.float32)
            normal[axis] = sign
            pts.append(face)
            nrm.append(np.tile(normal, (uu.size, 1)))
    pts = np.concatenate(pts)
    nrm = np.concatenate(nrm).astype(np.float32)
    # deduplicate edge/corner points
    _, idx = np.unique(np.round(pts / (spacing * 0.5)).astype(np.int64), axis=0,
                       return_index=True)
    return pts[np.sort(idx)], nrm[np.sort(idx)]


def sample_fluid_block(lower, upper, spacing: float, jitter: float = 0.0,
                       seed: int = 10):
    """Fill a box volume with fluid particles on a regular lattice (simple
    stand-in for the VolumeSampling binary for box-shaped fluids)."""
    rng = np.random.default_rng(seed)
    axes = [np.arange(l + spacing / 2, u, spacing, dtype=np.float32)
            for l, u in zip(lower, upper)]
    g = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([a.reshape(-1) for a in g], -1)
    if jitter:
        pts = pts + rng.normal(scale=jitter, size=pts.shape).astype(np.float32)
    return pts


def random_rotation_matrix(rng, strength: float = 1.0) -> np.ndarray:
    """Random 3D rotation with a strength dial (Arvo's method: a random
    z-rotation composed with a Householder reflection from a random unit
    vector). strength=1 is uniform over SO(3); strength=0 degenerates to a
    fixed 180-degree z-rotation (a property of the construction the reference
    inherits too — create_physics_scenes.py:127-154, used at strength 0 for
    fluid-shape orientation)."""
    x = rng.random(3)
    theta = x[0] * 2 * np.pi * strength
    phi = x[1] * 2 * np.pi
    z = x[2] * strength
    r = np.sqrt(z)
    v = np.array([np.sin(phi) * r, np.cos(phi) * r, np.sqrt(2.0 - z)])
    st, ct = np.sin(theta), np.cos(theta)
    rz = np.array([[ct, st, 0], [-st, ct, 0], [0, 0, 1]])
    return ((np.outer(v, v) - np.eye(3)) @ rz).astype(np.float32)


def rasterize_points(points, voxel_size: float, particle_radius: float):
    """Occupancy voxelization of a particle set, dilated by +-particle_radius
    at the 8 cube corners (role of reference create_physics_scenes.py:183-215).

    Returns (grid_min_index, voxel_size, occupancy bool array)."""
    if not voxel_size > 2 * particle_radius:
        raise ValueError("voxel_size must exceed 2 * particle_radius")
    points = np.asarray(points, np.float64)
    pmin = (points - particle_radius).min(axis=0)
    pmax = (points + particle_radius).max(axis=0)
    arr_min = np.floor_divide(pmin, voxel_size).astype(np.int32)
    arr_max = np.floor_divide(pmax, voxel_size).astype(np.int32) + 1
    occ = np.zeros(tuple(arr_max - arr_min), bool)
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], np.float64)
    for s in signs:
        idx = np.floor_divide(points + s * particle_radius, voxel_size)
        idx = idx.astype(np.int32) - arr_min
        occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return arr_min, voxel_size, occ


def find_valid_fluid_start_position(rng, box_rasterized, fluid_rasterized):
    """Random valid placement of a rasterized fluid shape inside rasterized
    free space (reference create_physics_scenes.py:218-254): the fluid's
    occupied voxels must all fall on free voxels, and — so fluids rest on
    the floor or on previously placed fluids — only the LOWEST valid y per
    (x, z) column is eligible. Mutates the free-space grid by subtracting
    the placed fluid. Returns the world-space offset, or None when the shape
    fits nowhere."""
    from scipy.ndimage import correlate

    box_min, voxel, free = box_rasterized
    fl_min, _, fl = fluid_rasterized
    fits_shape = np.array(free.shape) - np.array(fl.shape) + 1
    if np.any(fits_shape <= 0):
        return None
    # fluid fits at p  <=>  no fluid voxel overlaps a non-free voxel:
    # cross-correlate the blocked mask with the fluid stencil and keep zeros
    blocked = (~free).astype(np.float32)
    overlap = correlate(blocked, fl.astype(np.float32), mode="constant", cval=1.0)
    c = np.asarray(fl.shape) // 2  # scipy places the kernel origin at shape//2
    fits = overlap[
        c[0]:c[0] + fits_shape[0],
        c[1]:c[1] + fits_shape[1],
        c[2]:c[2] + fits_shape[2],
    ] < 0.5
    # keep only the lowest valid y in each (x, z) column (support rule)
    lowest = np.zeros_like(fits)
    any_below = np.zeros(fits_shape[[0, 2]].astype(int).tolist(), bool)
    for y in range(fits.shape[1]):
        sel = fits[:, y, :] & ~any_below
        lowest[:, y, :] = sel
        any_below |= fits[:, y, :]
    valid = np.stack(np.nonzero(lowest), axis=-1)
    if len(valid) == 0:
        return None
    pos = valid[rng.integers(0, len(valid))]
    # subtract the fluid from the free space
    sl = tuple(slice(p, p + s) for p, s in zip(pos, fl.shape))
    free[sl] &= ~fl
    return (pos + box_min).astype(np.float64) * voxel


def sample_fluid_shape(rng, shape: str, spacing: float, size_range=(0.2, 0.5)):
    """Lattice-sample a parametric fluid volume (stand-in for the reference's
    Fluid_*.obj meshes + VolumeSampling binary, reference :156-167; the obj
    path is used instead when the binary is installed)."""
    ext = rng.uniform(*size_range, size=3).astype(np.float64)
    axes = [np.arange(-e / 2 + spacing / 2, e / 2, spacing) for e in ext]
    g = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([a.reshape(-1) for a in g], -1)
    if shape == "box":
        keep = np.ones(len(pts), bool)
    elif shape == "ellipsoid":
        keep = np.sum((pts / (ext / 2)) ** 2, axis=-1) <= 1.0
    elif shape == "cylinder":
        keep = (pts[:, 0] / (ext[0] / 2)) ** 2 + (pts[:, 2] / (ext[2] / 2)) ** 2 <= 1.0
    elif shape == "wedge":
        keep = pts[:, 1] / (ext[1] + 1e-9) <= pts[:, 0] / (ext[0] + 1e-9) + 0.25
    else:
        raise ValueError(f"unknown fluid shape {shape}")
    return pts[keep].astype(np.float32)


FLUID_SHAPES = ("box", "ellipsoid", "cylinder", "wedge")
MAX_FLUID_START_VELOCITY_XZ = 2.0  # reference create_physics_scenes.py:28
MAX_FLUID_START_VELOCITY_Y = 0.5   # reference create_physics_scenes.py:29


def _msgpack_numpy_encode(obj):
    """msgpack_numpy wire format (so reference tooling can read our files)."""
    if isinstance(obj, np.ndarray):
        return {
            b"nd": True,
            b"type": obj.dtype.str,
            b"kind": b"",
            b"shape": list(obj.shape),
            b"data": obj.tobytes(),
        }
    if isinstance(obj, np.generic):
        return {b"nd": False, b"type": obj.dtype.str, b"data": obj.tobytes()}
    return obj


def write_compressed_msgpack(data, path: str, level: int = 22) -> bool:
    """Frame list -> .msgpack.zst (reference create_physics_scenes.py:115-124);
    returns False when zstandard/msgpack are unavailable."""
    try:
        import msgpack
        import zstandard as zstd
    except ImportError:
        return False
    packed = msgpack.packb(data, use_bin_type=True, default=_msgpack_numpy_encode)
    with open(path, "wb") as f:
        f.write(zstd.ZstdCompressor(level=level).compress(packed))
    return True


def read_compressed_msgpack(path: str):
    import msgpack
    import zstandard as zstd

    def hook(obj):
        if obj.get(b"nd"):
            arr = np.frombuffer(obj[b"data"], np.dtype(obj[b"type"]))
            return arr.reshape(obj[b"shape"])
        return obj

    with open(path, "rb") as f:
        raw = zstd.ZstdDecompressor().decompress(f.read())
    return msgpack.unpackb(raw, raw=True, object_hook=hook)


def create_random_scene(
    out_dir: str,
    seed: int,
    num_objects: int | None = None,
    box_lower=(-1.0, 0.0, -1.0),
    box_upper=(1.0, 2.0, 1.0),
    n_frames: int = 60,
    rotation_strength: float = 0.0,
    export_zst: bool = True,
) -> dict:
    """Randomized scene generation with the reference's diversity
    (reference create_physics_scenes.py:270-400): 1-3 random fluid shapes,
    random orientation (strength dial), rasterized free-space placement with
    the rest-on-support rule, random start velocities (xz up to 2.0 m/s,
    y up to 0.5 m/s), scene.json with one FluidModel per object, simulator
    run (or ballistic fallback), npz frames + optional .msgpack.zst export.

    Note the sim-space convention is y-up (gravity (0,-9.81,0)) exactly as in
    the reference; datasets rotate to z-up downstream.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    spacing = 2 * PARTICLE_RADIUS
    if num_objects is None:
        num_objects = int(rng.integers(1, 4))

    box, box_normals = sample_box_surface(box_lower, box_upper, spacing=0.05)
    np.savez(osp.join(out_dir, "box.npz"), box=box, box_normals=box_normals)

    # rasterized free interior (eroded so fluids keep a margin off the walls,
    # reference :345-347)
    from scipy.ndimage import binary_erosion

    interior = sample_fluid_block(
        np.asarray(box_lower) + spacing, np.asarray(box_upper) - spacing, spacing
    )
    bmin, voxel, occ = rasterize_points(
        np.concatenate([interior, box]), 2.01 * PARTICLE_RADIUS, PARTICLE_RADIUS
    )
    free = binary_erosion(occ, structure=np.ones((3, 3, 3)), iterations=3)
    box_rast = (bmin, voxel, free)

    objects = []
    for _ in range(num_objects):
        for _attempt in range(10):
            shape = FLUID_SHAPES[rng.integers(0, len(FLUID_SHAPES))]
            fluid = sample_fluid_shape(rng, shape, spacing)
            if len(fluid) == 0:
                continue
            fluid = fluid @ random_rotation_matrix(rng, rotation_strength)
            fl_rast = rasterize_points(fluid, 2.01 * PARTICLE_RADIUS, PARTICLE_RADIUS)
            offset = find_valid_fluid_start_position(rng, box_rast, fl_rast)
            if offset is None:
                continue
            fluid = fluid + (offset - fl_rast[0] * fl_rast[1]).astype(np.float32)
            vel = np.zeros_like(fluid)
            vel[:, 0] = rng.uniform(-MAX_FLUID_START_VELOCITY_XZ,
                                    MAX_FLUID_START_VELOCITY_XZ)
            vel[:, 2] = rng.uniform(-MAX_FLUID_START_VELOCITY_XZ,
                                    MAX_FLUID_START_VELOCITY_XZ)
            vel[:, 1] = rng.uniform(-MAX_FLUID_START_VELOCITY_Y,
                                    MAX_FLUID_START_VELOCITY_Y)
            objects.append({"shape": shape, "positions": fluid, "velocities": vel})
            break

    if not objects:
        raise RuntimeError(f"no fluid object could be placed (seed {seed})")

    scene = build_scene_description(
        [o["positions"] for o in objects], box_lower, box_upper
    )
    with open(osp.join(out_dir, "scene.json"), "w") as f:
        json.dump(scene, f, indent=2)
    for i, o in enumerate(objects):
        bgeo.write_bgeo(
            osp.join(out_dir, f"fluid_{i}.bgeo"), o["positions"],
            {"velocity": o["velocities"],
             "id": np.arange(len(o["positions"]), dtype=np.int32)},
        )

    pos0 = np.concatenate([o["positions"] for o in objects])
    vel0 = np.concatenate([o["velocities"] for o in objects])
    outdir = osp.join(out_dir, "output")
    if run_simulator(out_dir):
        convert_bgeo_sequence(osp.join(out_dir, "sim_output", "partio"), outdir)
        frames = sorted(glob.glob(osp.join(outdir, "fluid_*.npz")))
        seq = [dict(np.load(p)) for p in frames]
        positions = np.stack([f["pos"] for f in seq])
        velocities = np.stack([f["vel"] for f in seq])
    else:
        from neurofluid_torch.data import synthetic

        # PBF fallback: fluid-realistic sloshing (incompressibility solve),
        # not ballistic fall — the closest offline stand-in for DFSPH
        positions, velocities = synthetic.simulate_pbf(
            pos0, vel0, n_frames, seed=seed,
            gravity=(0.0, -9.81, 0.0), bounds=(box_lower, box_upper),
        )
        os.makedirs(outdir, exist_ok=True)
        for i in range(n_frames):
            np.savez(osp.join(outdir, f"fluid_{i:04d}.npz"),
                     pos=positions[i], vel=velocities[i])

    if export_zst:
        frames_data = []
        for i in range(len(positions)):
            fd = {
                "frame_id": np.int64(i),
                "scene_id": f"sim_{seed:04d}",
                "pos": positions[i].astype(np.float32),
                "vel": velocities[i].astype(np.float32),
                "m": np.full(len(positions[i]),
                             1000.0 * (2 * PARTICLE_RADIUS) ** 3, np.float32),
                "viscosity": np.full(len(positions[i]), 0.08, np.float32),
            }
            if i == 0:
                fd["box"] = box.astype(np.float32)
                fd["box_normals"] = box_normals.astype(np.float32)
            frames_data.append(fd)
        write_compressed_msgpack(
            frames_data, osp.join(out_dir, f"sim_{seed:04d}_00.msgpack.zst")
        )

    return {"objects": objects, "n_particles": len(pos0), "out_dir": out_dir}


def build_scene_description(fluid_blocks, box_lower, box_upper, stop_at=1.2,
                            seed: int = 10) -> dict:
    """Assemble a SPlisHSPlasH scene.json dict (reference :35-59 semantics)."""
    scene = json.loads(json.dumps(DEFAULT_SCENE))
    scene["Configuration"]["stopAt"] = stop_at
    scene["RigidBodies"] = [
        {
            "geometryFile": "box.obj",
            "translation": [0, 0, 0],
            "rotationAxis": [0, 1, 0],
            "rotationAngle": 0,
            "scale": list(np.asarray(box_upper) - np.asarray(box_lower)),
            "color": [0.1, 0.4, 0.6, 1.0],
            "isDynamic": False,
            "isWall": True,
            "mapInvert": True,
            "mapThickness": 0.0,
            "mapResolution": [30, 30, 30],
        }
    ]
    scene["FluidModels"] = [
        {
            "particleFile": f"fluid_{i}.bgeo",
            "translation": [0, 0, 0],
            "rotationAxis": [0, 1, 0],
            "rotationAngle": 0,
            "scale": [1, 1, 1],
        }
        for i in range(len(fluid_blocks))
    ]
    return scene


def run_simulator(scene_dir: str, timeout: int = 3600) -> bool:
    """Run DynamicBoundarySimulator on scene_dir/scene.json if available."""
    sim, _ = simulator_binaries()
    if sim is None:
        return False
    subprocess.run(
        [sim, osp.join(scene_dir, "scene.json"), "--no-gui",
         "--output-dir", osp.join(scene_dir, "sim_output")],
        check=True, timeout=timeout,
    )
    return True


def convert_bgeo_sequence(bgeo_dir: str, out_dir: str) -> int:
    """partio .bgeo frames -> fluid_XXXX.npz {pos, vel}, sorted by particle id
    for temporal correspondence (reference physics_data_helper.py:28-59)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = sorted(glob.glob(osp.join(bgeo_dir, "*.bgeo")))
    for i, path in enumerate(paths):
        pos, attrs = bgeo.read_bgeo(path)
        vel = np.asarray(attrs.get("velocity", np.zeros_like(pos)), np.float32)
        if "id" in attrs:
            order = np.argsort(np.asarray(attrs["id"]).reshape(-1))
            pos, vel = pos[order], vel[order]
        np.savez(osp.join(out_dir, f"fluid_{i:04d}.npz"), pos=pos, vel=vel)
    return len(paths)


def generate_scene(out_dir: str, box_lower=(-1, -1, -1), box_upper=(1, 1, 2.4552),
                   fluid_lower=(-0.25, -0.25, 0.4), fluid_upper=(0.25, 0.25, 0.9),
                   seed: int = 10, n_frames: int = 60) -> str:
    """Create scene description + box particles; run the real simulator when
    installed, else fall back to the synthetic ballistic simulator."""
    os.makedirs(out_dir, exist_ok=True)
    box, box_normals = sample_box_surface(box_lower, box_upper, spacing=0.05)
    np.savez(osp.join(out_dir, "box.npz"), box=box, box_normals=box_normals)

    fluid = sample_fluid_block(fluid_lower, fluid_upper, spacing=2 * PARTICLE_RADIUS,
                               seed=seed)
    scene = build_scene_description([fluid], box_lower, box_upper)
    with open(osp.join(out_dir, "scene.json"), "w") as f:
        json.dump(scene, f, indent=2)
    bgeo.write_bgeo(osp.join(out_dir, "fluid_0.bgeo"), fluid,
                    {"velocity": np.zeros_like(fluid),
                     "id": np.arange(len(fluid), dtype=np.int32)})

    if run_simulator(out_dir):
        convert_bgeo_sequence(osp.join(out_dir, "sim_output", "partio"),
                              osp.join(out_dir, "output"))
    else:
        from neurofluid_torch.data import synthetic

        positions, velocities = synthetic.simulate_pbf(
            fluid, np.zeros_like(fluid), n_frames, seed=seed
        )
        os.makedirs(osp.join(out_dir, "output"), exist_ok=True)
        for i in range(n_frames):
            np.savez(osp.join(out_dir, "output", f"fluid_{i:04d}.npz"),
                     pos=positions[i], vel=velocities[i])
    return out_dir
