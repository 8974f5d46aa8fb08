"""Particle and point-cloud I/O (a copy of neurofluid_tpu/data/io.py,
which the port cannot import: importing that package imports JAX).

Host-side replacements for the reference's particle file handling:
- obj/ply point-cloud dumps (reference utils/particles_utils.py:18-43),
- per-frame particle .npz {pos, vel} and blender .pkl {location, velocity}
  (reference datasets/dataset.py:128-149),
- bounding-box files: the reference stores joblib dicts {box, box_normals}
  (reference datasets/dataset.py:121-125); we read joblib when available and
  also accept .npz with the same keys.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


def write_obj_pointcloud(points: np.ndarray, fp, color=(255, 0, 0)) -> None:
    """Colored vertex dump, one `v x y z r g b` line per particle
    (reference utils/particles_utils.py:39-43 format)."""
    r, g, b = color
    for p in np.asarray(points):
        fp.write(f"v {p[0]:.2f} {p[1]:.2f} {p[2]:.2f} {r} {g} {b}\n")


def read_obj_pointcloud(path: str) -> np.ndarray:
    """Read `v x y z [...]` vertex lines (reference utils/particles_utils.py:18-30)."""
    pos = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "v":
                pos.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(pos, np.float32)


def write_ply_pointcloud(points: np.ndarray, path: str) -> None:
    points = np.asarray(points)
    with open(path, "w") as fp:
        fp.write("ply\nformat ascii 1.0\n")
        fp.write(f"element vertex {points.shape[0]}\n")
        fp.write("property float32 x\nproperty float32 y\nproperty float32 z\n")
        fp.write("end_header\n")
        for p in points:
            fp.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def read_particles(path: str, data_type: str = "splishsplash"):
    """Per-frame particle state -> (pos (N,3), vel (N,3)) float32.

    data_type 'splishsplash': .npz with keys pos/vel
    data_type 'blender': pickle with keys location/velocity
    (reference datasets/dataset.py:128-149).
    """
    if data_type == "blender":
        with open(path, "rb") as fp:
            info = pickle.load(fp)
        pos = np.asarray(info["location"], np.float32).reshape(-1, 3)
        vel = np.asarray(info["velocity"], np.float32).reshape(-1, 3)
    elif data_type == "splishsplash":
        info = np.load(path)
        pos = np.asarray(info["pos"], np.float32)
        vel = np.asarray(info["vel"], np.float32)
    else:
        raise ValueError(f"unknown data_type: {data_type}")
    return pos, vel


def write_particles_npz(path: str, pos: np.ndarray, vel: np.ndarray) -> None:
    np.savez(path, pos=np.asarray(pos, np.float32), vel=np.asarray(vel, np.float32))


def read_box(path: str):
    """Boundary particles + normals -> (box (M,3), box_normals (M,3)).

    Accepts .npz {box, box_normals} or joblib/pickle dicts (the reference's
    box.pt files are joblib archives, reference datasets/dataset.py:121-125).
    """
    if path.endswith(".npz"):
        info = np.load(path)
        return (
            np.asarray(info["box"], np.float32),
            np.asarray(info["box_normals"], np.float32),
        )
    try:
        import joblib

        info = joblib.load(path)
    except Exception:
        with open(path, "rb") as fp:
            info = pickle.load(fp)
    return (
        np.asarray(info["box"], np.float32),
        np.asarray(info["box_normals"], np.float32),
    )


def write_box_npz(path: str, box: np.ndarray, box_normals: np.ndarray) -> None:
    np.savez(
        path,
        box=np.asarray(box, np.float32),
        box_normals=np.asarray(box_normals, np.float32),
    )


def load_transforms(root_dir: str, split: str) -> dict:
    with open(os.path.join(root_dir, f"transforms_{split}.json")) as f:
        return json.load(f)
