"""Multi-view Blender-convention dataset for renderer and end-to-end
training (port of neurofluid_tpu/data/blender.py `BlenderDataset`, the
numpy re-implementation of the reference's, datasets/dataset.py:21-174).

Per view, a `transforms_{split}.json` with `camera_angle_x` (focal = 0.5 W
/ tan(0.5 angle)) and per-frame camera matrices and particle files; RGBA
images alpha-blended onto white; precomputed world-space rays for every
pixel; a shared bounding-box particle file named by the meta's
`bounding_box` key. `__getitem__(i)` returns frame i and frame i + 1 (the
`*_1` keys) across all views; len = frames - 1.

As in the JAX package, rays are computed once per distinct camera pose (the
fluid scenes use static cameras), and every array is numpy on the host:
the rays come from the port's `ray_ops` on the CPU, and the trainers move
whole batches to the card.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from neurofluid_torch.data import io as data_io
from neurofluid_torch.ops import ray_ops


def _pose_rays(height: int, width: int, focal: float,
               c2w: np.ndarray) -> np.ndarray:
    """(H, W, 6) float32 rays of one camera pose, computed on the CPU."""
    dirs = ray_ops.get_ray_directions(height, width, focal, device="cpu")
    bundle = ray_ops.make_ray_bundle(
        dirs, torch.as_tensor(np.asarray(c2w, np.float32)))
    return bundle.numpy().astype(np.float32)


def load_image_rgb(path: str, wh: tuple) -> np.ndarray:
    """RGBA png -> (H*W, 3) float32 blended onto white
    (reference datasets/dataset.py:104-109)."""
    from PIL import Image

    image = Image.open(path)
    if image.size != wh:
        image = image.resize(wh, Image.LANCZOS)
    arr = np.asarray(image, np.float32) / 255.0
    arr = arr.reshape(-1, arr.shape[-1])
    if arr.shape[-1] == 4:
        arr = arr[:, :3] * arr[:, -1:] + (1.0 - arr[:, -1:])
    return arr.astype(np.float32)


class BlenderDataset:
    def __init__(
        self,
        root_dir: str,
        data_type: str = "splishsplash",
        img_wh: tuple = (400, 400),
        img_scale: float = 1.0,
        start_index: int = 0,
        end_index: int = 50,
        view_names: tuple = ("view_1",),
        split: str = "train",
    ):
        self.root_dir = root_dir
        self.data_type = data_type
        self.split = split
        self.view_names = list(view_names)
        w = int(img_wh[0] // img_scale)
        h = int(img_wh[1] // img_scale)
        if w != h:
            raise ValueError(f"image width {w} must equal its height {h}")
        self.img_wh = (w, h)
        self.start_index = start_index
        self.end_index = end_index

        self._read_views()
        self._read_box()

    def _read_views(self):
        rays_mv, rgbs_mv, cw_mv, focals = [], [], [], []
        particles_pos, particles_vel = None, None
        for vi, view in enumerate(self.view_names):
            view_dir = osp.join(self.root_dir, view)
            meta = data_io.load_transforms(view_dir, self.split)
            self._meta = meta
            w, h = self.img_wh
            focal = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
            focals.append(focal)

            frames = meta["frames"][self.start_index:self.end_index]
            pose_cache: dict = {}
            view_rays, view_rgbs, view_cw = [], [], []
            pos_list, vel_list = [], []
            for frame in frames:
                pose = np.asarray(frame["transform_matrix"],
                                  np.float32)[:3, :4]
                view_cw.append(pose)
                key = pose.tobytes()
                if key not in pose_cache:
                    pose_cache[key] = _pose_rays(h, w, focal, pose)
                view_rays.append(pose_cache[key])
                img_path = osp.join(view_dir, f"{frame['file_path']}.png")
                view_rgbs.append(load_image_rgb(img_path, self.img_wh))
                if vi == 0:
                    ppath = osp.join(view_dir, self.split,
                                     frame["particle_path"])
                    pos, vel = data_io.read_particles(ppath, self.data_type)
                    pos_list.append(pos)
                    vel_list.append(vel)
            rays_mv.append(np.stack(view_rays))
            rgbs_mv.append(np.stack(view_rgbs))
            cw_mv.append(np.stack(view_cw))
            if vi == 0:
                particles_pos = np.stack(pos_list)
                particles_vel = np.stack(vel_list)

        self.rays = np.stack(rays_mv)  # (V, F, H, W, 6)
        self.rgbs = np.stack(rgbs_mv)  # (V, F, H*W, 3)
        self.cw = np.stack(cw_mv)  # (V, F, 3, 4)
        self.focal = np.asarray(focals, np.float32)
        self.particles_pos = particles_pos  # (F, N, 3)
        self.particles_vel = particles_vel

    def _read_box(self):
        box_path = osp.join(self.root_dir, self._meta["bounding_box"])
        self.box, self.box_normals = data_io.read_box(box_path)

    @property
    def num_frames(self) -> int:
        return self.rgbs.shape[1]

    def __len__(self) -> int:
        return self.num_frames - 1

    def __getitem__(self, index: int) -> dict:
        if not 0 <= index < len(self):
            raise IndexError(index)
        h, w = self.img_wh[1], self.img_wh[0]
        v = len(self.view_names)
        return {
            "cw": self.cw[:, index],
            "rgb": self.rgbs[:, index],
            "rays": self.rays[:, index].reshape(v, h * w, 6),
            "box": self.box,
            "box_normals": self.box_normals,
            "particles_pos": self.particles_pos[index],
            "particles_vel": self.particles_vel[index],
            "focal": self.focal,
            "cw_1": self.cw[:, index + 1],
            "rgb_1": self.rgbs[:, index + 1],
            "rays_1": self.rays[:, index + 1].reshape(v, h * w, 6),
            "particles_pos_1": self.particles_pos[index + 1],
            "particles_vel_1": self.particles_vel[index + 1],
        }
