"""NeRF MLP (port of neurofluid_tpu/models/nerf.py).

D hidden layers of width W with the xyz embedding concatenated back in
before layer index 4, a sigma head off the trunk, and an rgb head
conditioned on the direction embedding through a W/2-wide layer. Module
names follow the upstream state_dict: `xyz_encoding_{i}.0` (Linear inside
Sequential(Linear, ReLU)), `xyz_encoding_final`, `sigma`,
`dir_encoding.0` and `rgb.0`. The dense layers are plain matrix products
(the JAX package leaves them to XLA), so they stay nn.Linear.

`compute_dtype=torch.bfloat16` runs every product in bf16 as flax's
`Dense(dtype=bf16, param_dtype=f32)` does: the input and the f32 weight are
cast to bf16, the product is rounded to bf16 and the bf16 bias is added
after it; the skip concat and the direction input are cast to bf16; the
sigma and rgb heads are cast back to f32, and the sigmoid runs in f32. The
parameters stay f32 and the state_dict names do not change.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neurofluid_torch.cuda import resolve_device
from neurofluid_torch.models.init import generator_or_default, init_linear
from neurofluid_torch.utils.profiling import span


class NeRF(nn.Module):
    def __init__(self, depth: int = 8, width: int = 256,
                 in_channels_xyz: int = 63, in_channels_dir: int = 27,
                 skips: tuple = (4,),
                 compute_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.depth = depth
        self.compute_dtype = compute_dtype
        self.in_channels_xyz = in_channels_xyz
        self.skips = tuple(skips)
        meta = dict(device="meta")
        for i in range(depth):
            if i == 0:
                n_in = in_channels_xyz
            elif i in self.skips:
                n_in = width + in_channels_xyz
            else:
                n_in = width
            setattr(self, f"xyz_encoding_{i + 1}", nn.Sequential(
                nn.Linear(n_in, width, **meta), nn.ReLU(True)))
        self.xyz_encoding_final = nn.Linear(width, width, **meta)
        self.sigma = nn.Linear(width, 1, **meta)
        self.dir_encoding = nn.Sequential(
            nn.Linear(width + in_channels_dir, width // 2, **meta),
            nn.ReLU(True))
        self.rgb = nn.Sequential(nn.Linear(width // 2, 3, **meta), nn.Sigmoid())
        self.to_empty(device=resolve_device(device))
        gen = generator_or_default(generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear(m, gen)

    def _dense(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return layer(h)
        dt = self.compute_dtype
        return F.linear(h, layer.weight.to(dt)) + layer.bias.to(dt)

    def forward(self, x: torch.Tensor, sigma_only: bool = False) -> torch.Tensor:
        """x: (B, in_xyz) if sigma_only else (B, in_xyz + in_dir).

        Returns (B, 1) sigma or (B, 4) [rgb, sigma], f32 whatever the
        compute dtype."""
        with span("render.nerf"):
            input_xyz = x[..., : self.in_channels_xyz].to(self.compute_dtype)
            h = input_xyz
            for i in range(self.depth):
                if i in self.skips:
                    h = torch.cat([input_xyz, h], dim=-1)
                h = torch.relu(self._dense(
                    getattr(self, f"xyz_encoding_{i + 1}")[0], h))
            sigma = self._dense(self.sigma, h).float()
            if sigma_only:
                return sigma
            feat = self._dense(self.xyz_encoding_final, h)
            d = torch.relu(self._dense(self.dir_encoding[0], torch.cat(
                [feat, x[..., self.in_channels_xyz:].to(self.compute_dtype)],
                dim=-1)))
            rgb = torch.sigmoid(self._dense(self.rgb[0], d).float())
            return torch.cat([rgb, sigma], dim=-1)
