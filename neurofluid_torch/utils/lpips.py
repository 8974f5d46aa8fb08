"""LPIPS perceptual metric: a VGG16 feature extractor and linear heads
(port of neurofluid_tpu/utils/lpips.py).

The reference computes LPIPS(VGG) in its image-metrics notebook
(reference utils/evaluate_images.ipynb cell 5) through the `lpips` pip
package (torchvision's pretrained VGG16 and the learned linear
calibration). The weights are a USER-SUPPLIED file in the JAX package's
format; given one, the metric runs with `F.conv2d` and `F.max_pool2d`.

Weights file format (.npz):

- vgg_conv{i}_weight: (out, in, 3, 3) float32, i = 0..12: the 13 conv
  layers of torchvision VGG16 `features`, in order.
- vgg_conv{i}_bias:   (out,) float32
- lin{k}_weight:      (C_k,) or (1, C_k, 1, 1) float32, k = 0..4: the
  LPIPS linear head weights over the 5 tapped activations (relu1_2,
  relu2_2, relu3_3, relu4_3, relu5_3).

The JAX package's `export_weights` writes such a file from torchvision's
download on a connected machine; it is not ported (this package needs no
network and no torchvision).

Distance (Zhang et al., 2018, CVPR): images scaled to [-1, 1], normalized by
the fixed shift and scale, passed through VGG16; each tapped activation is
normalized to unit length over its channels; the squared difference is
weighted by the linear head and averaged over the image; the five layer
scores are summed.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from neurofluid_torch.cuda import resolve_device

# VGG16 feature-layer plan: conv channel widths and pool positions
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512)
# tap after the relu of these conv indices (0-based over the 13 convs):
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_TAPS = (1, 3, 6, 9, 12)
_TAP_CHANNELS = (64, 128, 256, 512, 512)

# fixed normalization from the LPIPS reference implementation
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSEvaluator:
    """Loads a weights file once and evaluates distances on `device`."""

    def __init__(self, weights_path: str, device="cuda"):
        if not os.path.isfile(weights_path):
            raise FileNotFoundError(
                f"LPIPS weights file not found: {weights_path}. Produce one "
                "with the JAX package's neurofluid_tpu.utils.lpips."
                "export_weights() on a machine with torchvision, or set "
                "NF_LPIPS_WEIGHTS.")
        self.device = resolve_device(device)
        data = np.load(weights_path)

        def tensor(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

        self.conv_w = [tensor(data[f"vgg_conv{i}_weight"]) for i in range(13)]
        self.conv_b = [tensor(data[f"vgg_conv{i}_bias"]) for i in range(13)]
        self.lin_w = []
        for k, c in enumerate(_TAP_CHANNELS):
            w = tensor(data[f"lin{k}_weight"]).reshape(-1)
            if w.shape[0] != c:
                raise ValueError(
                    f"lin{k}_weight has {w.shape[0]} channels, expected {c}")
            self.lin_w.append(w)
        self.shift = torch.tensor(_SHIFT, device=self.device)[None, :, None,
                                                              None]
        self.scale = torch.tensor(_SCALE, device=self.device)[None, :, None,
                                                              None]

    def features(self, x: torch.Tensor) -> list:
        """x (1, 3, H, W) in [-1, 1] -> the five tapped activations."""
        x = (x - self.shift) / self.scale
        taps, ci = [], 0
        for item in _VGG16_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = torch.relu(F.conv2d(x, self.conv_w[ci], self.conv_b[ci],
                                    padding=1))
            if ci in _TAPS:
                taps.append(x)
            ci += 1
        return taps

    @torch.no_grad()
    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b (1, 3, H, W) in [-1, 1] -> () LPIPS distance."""
        total = a.new_zeros(())
        for ta, tb, w in zip(self.features(a), self.features(b), self.lin_w):
            na = ta / torch.sqrt(torch.sum(ta ** 2, 1, keepdim=True) + 1e-10)
            nb = tb / torch.sqrt(torch.sum(tb ** 2, 1, keepdim=True) + 1e-10)
            d2 = (na - nb) ** 2
            total = total + torch.mean(
                torch.sum(d2 * w[None, :, None, None], dim=1))
        return total

    def __call__(self, pred: np.ndarray, gt: np.ndarray) -> float:
        """pred, gt: (H, W, 3) in [0, 1]. Returns the LPIPS distance."""

        def image(x):
            t = torch.from_numpy(np.asarray(x, np.float32) * 2.0 - 1.0)
            return t.permute(2, 0, 1)[None].to(self.device)

        return float(self.distance(image(pred), image(gt)))


_CACHED: dict = {}


def get_evaluator(weights_path: str | None = None,
                  device="cuda") -> LPIPSEvaluator:
    """The evaluator of `weights_path`, else of the NF_LPIPS_WEIGHTS
    environment variable, loaded once per file and device."""
    path = weights_path or os.environ.get("NF_LPIPS_WEIGHTS", "")
    if not path:
        raise FileNotFoundError(
            "No LPIPS weights configured. Pass weights_path or set the "
            "NF_LPIPS_WEIGHTS env var to a file produced by the JAX "
            "package's neurofluid_tpu.utils.lpips.export_weights().")
    key = (path, str(resolve_device(device)))
    if key not in _CACHED:
        _CACHED[key] = LPIPSEvaluator(path, device)
    return _CACHED[key]
