"""Evaluation metrics: particle fidelity and image quality (a copy of
neurofluid_tpu/utils/metrics.py; `lpips` runs the port's evaluator).

- `FluidErrors`: per-timestep particle error accumulator with the exact stats
  of the reference (reference utils/point_eval.py:17-58): element-wise
  pred<->gt distances and GT->pred nearest-neighbor distances (cKDTree),
  x1000 (mm), JSON save/load.
- PSNR (reference utils/evaluate_images.ipynb / trainer_e2e.py:25).
- SSIM with 11x11 gaussian window, sigma 1.5 (the reference uses
  skimage-style SSIM in its notebook).
"""

from __future__ import annotations

import json

import numpy as np


def _distance(x, y):
    return np.linalg.norm(x - y, axis=-1)


def _gt_to_pred_distance(pred, gt):
    from scipy.spatial import cKDTree

    tree = cKDTree(pred)
    dist, _ = tree.query(gt)
    return dist


def _compute_stats(x: np.ndarray) -> dict:
    stats = {
        "mean": np.mean(x),
        "mse": np.mean(x**2),
        "var": np.var(x),
        "min": np.min(x),
        "max": np.max(x),
        "median": np.median(x),
    }
    stats = {k: float(v) * 1000 for k, v in stats.items()}
    stats["num_particles"] = int(x.shape[0])
    return stats


class FluidErrors:
    """Accumulates per-timestep particle errors (reference utils/point_eval.py:31-81)."""

    def __init__(self):
        self.errors: dict = {}

    def cal_errors(self, pred_pos, gt_pos, time_idx):
        pred_pos = np.asarray(pred_pos)
        gt_pos = np.asarray(gt_pos)
        if np.count_nonzero(~np.isfinite(pred_pos)):
            print("predicted_pos contains nonfinite values")
            return None
        if np.count_nonzero(~np.isfinite(gt_pos)):
            print("gt_pos contains nonfinite values")
            return None

        errs = _compute_stats(_distance(pred_pos, gt_pos))
        for k, v in _compute_stats(_gt_to_pred_distance(pred_pos, gt_pos)).items():
            errs[f"gt2pred_{k}"] = v

        if time_idx not in self.errors:
            self.errors[time_idx] = errs
        else:
            self.errors[time_idx].update(errs)
        return errs["gt2pred_mean"]

    def save(self, path):
        with open(path, "w") as f:
            json.dump(list(self.errors.items()), f, indent=4)

    def load(self, path):
        with open(path) as f:
            self.errors = {k if np.isscalar(k) else tuple(k): v for k, v in json.load(f)}


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM over channels, 11x11 gaussian window, sigma 1.5."""
    from scipy.signal import convolve2d

    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred = pred[..., None]
        gt = gt[..., None]
    win = _gaussian_window()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        mu_x = convolve2d(x, win, mode="valid")
        mu_y = convolve2d(y, win, mode="valid")
        mu_xx = convolve2d(x * x, win, mode="valid")
        mu_yy = convolve2d(y * y, win, mode="valid")
        mu_xy = convolve2d(x * y, win, mode="valid")
        var_x = mu_xx - mu_x**2
        var_y = mu_yy - mu_y**2
        cov = mu_xy - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


def lpips(pred: np.ndarray, gt: np.ndarray, weights_path: str | None = None,
          device="cuda") -> float:
    """LPIPS(VGG) perceptual metric (reference utils/evaluate_images.ipynb
    cell 5) from a user-supplied weights file (see utils/lpips.py for the
    format), on the card unless `device` says otherwise. Raises
    FileNotFoundError with instructions when no weights are configured."""
    from neurofluid_torch.utils import lpips as lpips_mod

    return lpips_mod.get_evaluator(weights_path, device)(pred, gt)


def chamfer_distance_np(x: np.ndarray, y: np.ndarray) -> float:
    """Host-side symmetric chamfer (squared), matching ops.chamfer."""
    from scipy.spatial import cKDTree

    d_xy, _ = cKDTree(y).query(x)
    d_yx, _ = cKDTree(x).query(y)
    return float(np.mean(d_xy**2) + np.mean(d_yx**2))
