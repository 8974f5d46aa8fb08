"""Windowed particle-sequence dataset for transition-model training (a
copy of neurofluid_tpu/data/particles.py, which the port cannot import:
importing that package imports JAX).

Numpy re-implementation of the reference `ParticleDataset`
(reference datasets/dataset_splishsplash_rawdata.py:19-143): samples are
window-length runs of consecutive frames {particles_pos_i, particles_vel_i}
plus the scene's boundary particles, collected from one of three layouts:

- 'raw':         <root>/sim*/output/fluid_*.npz + per-sim box.pt
- 'blender':     <root>/view_0/train/particles/*.npz + <root>/box.pt
- 'blender_all': <root>/*/train/particles/*.npz + <root>/box.pt

Optional data augmentation applies one random rotation about the z axis to
every tensor in a sample (positions, velocities, box, normals), matching the
reference's `random_rot` (reference :125-139, note v @ R convention).
"""

from __future__ import annotations

import glob
import os.path as osp

import numpy as np

from neurofluid_torch.data import io as data_io


def _sorted_by_int(paths, key_fn):
    return sorted(paths, key=key_fn)


class ParticleDataset:
    def __init__(
        self,
        data_path: str,
        data_type: str = "raw",
        start: int = 0,
        end: int = 50,
        random_rot: bool = True,
        window: int = 3,
        seed: int = 10,
    ):
        self.random_rot = random_rot
        self.window = window
        self.root_dir = data_path
        self.start = start
        self.end = end
        self._rng = np.random.default_rng(seed)
        # windows contributed by each source sequence (sim dir / view dir),
        # in collection order. `items` concatenates the sequences, so an
        # autoregressive consumer that wants ONE physical sequence (the
        # reference eval rolls out a single sim, reference
        # eval_transmodel.py:101-154) must stop at sequence_lengths[0] —
        # 'blender_all' repeats the same frames once per view dir.
        self.sequence_lengths: list[int] = []
        if data_type == "raw":
            self.items = self._collect_raw()
        elif data_type == "blender":
            self.items = self._collect_blender(
                [osp.join(self.root_dir, "view_0")], self._box_path(self.root_dir),
                keep_last=True,
            )
        elif data_type == "blender_all":
            self.items = self._collect_blender(
                sorted(glob.glob(osp.join(self.root_dir, "*"))),
                self._box_path(self.root_dir),
                keep_last=True,
            )
        else:
            raise ValueError(f"unknown data_type: {data_type}")

    @staticmethod
    def _box_path(root: str) -> str:
        """Reference layouts use box.pt (joblib); synthetic scenes box.npz."""
        pt = osp.join(root, "box.pt")
        return pt if osp.exists(pt) else osp.join(root, "box.npz")

    def _frame_samples(self, paths, box_path, keep_last: bool):
        box, box_normals = data_io.read_box(box_path)
        samples = []
        # 'raw' stops one early, blender layouts keep the final full window
        # (reference :70 vs :112)
        last = len(paths) - self.window + (1 if keep_last else 0)
        for idx in range(max(0, last)):
            sample = {"box": box, "box_normals": box_normals}
            for w in range(self.window):
                pos, vel = data_io.read_particles(paths[idx + w], "splishsplash")
                sample[f"particles_pos_{w}"] = pos
                sample[f"particles_vel_{w}"] = vel
            samples.append(sample)
        return samples

    def _collect_raw(self):
        samples = []
        for sim_dir in sorted(glob.glob(osp.join(self.root_dir, "sim*"))):
            paths = glob.glob(osp.join(sim_dir, "output", "fluid_*.npz"))
            paths = _sorted_by_int(paths, lambda x: int(x.split("_")[-1][:-4]))
            paths = paths[self.start : self.end]
            seq = self._frame_samples(paths, self._box_path(sim_dir), keep_last=False)
            if seq:
                self.sequence_lengths.append(len(seq))
            samples += seq
        return samples

    def _collect_blender(self, view_dirs, box_path, keep_last):
        samples = []
        for vdir in view_dirs:
            paths = glob.glob(osp.join(vdir, "train", "particles", "*.npz"))
            if not paths:
                continue
            paths = _sorted_by_int(paths, lambda x: int(osp.basename(x)[:-4]))
            paths = paths[self.start : self.end]
            seq = self._frame_samples(paths, box_path, keep_last=keep_last)
            if seq:
                self.sequence_lengths.append(len(seq))
            samples += seq
        return samples

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> dict:
        data = self.items[index]
        if not self.random_rot:
            return {k: np.asarray(v, np.float32) for k, v in data.items()}
        angle = self._rng.uniform(0, 2 * np.pi)
        c, s = np.cos(angle), np.sin(angle)
        rot = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        return {k: (np.asarray(v, np.float32) @ rot) for k, v in data.items()}
