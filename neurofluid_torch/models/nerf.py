"""NeRF MLP (port of neurofluid_tpu/models/nerf.py).

D hidden layers of width W with the xyz embedding concatenated back in
before layer index 4, a sigma head off the trunk, and an rgb head
conditioned on the direction embedding through a W/2-wide layer. Module
names follow the upstream state_dict: `xyz_encoding_{i}.0` (Linear inside
Sequential(Linear, ReLU)), `xyz_encoding_final`, `sigma`,
`dir_encoding.0` and `rgb.0`. The JAX package leaves the dense layers to
XLA; the port keeps them nn.Linear, and at f32 on the card runs its 10
wide layers (`xyz_encoding_1..D`, `xyz_encoding_final`, `dir_encoding`)
on K9 (`ops/dense_layer.py`): bias and ReLU inside the kernel, the skip
and direction inputs read where they lie, the weights split for all the
layers in one launch a forward. The sigma and rgb heads (N = 1 and 3)
stay on `F.linear`, as does every layer on the CPU, bitwise as before.

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
from neurofluid_torch.ops import dense_layer as dl
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
            if x.is_cuda and self.compute_dtype == torch.float32:
                return self._forward_k9(x, sigma_only)
            return self._forward_plain(x, sigma_only)

    def _forward_plain(self, x: torch.Tensor, sigma_only: bool) -> torch.Tensor:
        """`forward` on `nn.Linear` and `F.linear` (the CPU, bf16)."""
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

    def _forward_k9(self, x: torch.Tensor, sigma_only: bool) -> torch.Tensor:
        """`forward` at f32 on the card: the wide layers on K9
        (`dense_layer.nerf_layers`), the heads on `F.linear`."""
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        if x.stride(-1) != 1:
            x = x.contiguous()
        layers = [getattr(self, f"xyz_encoding_{i + 1}")[0]
                  for i in range(self.depth)]
        if not sigma_only:
            layers += [self.xyz_encoding_final, self.dir_encoding[0]]
        cx = self.in_channels_xyz
        h, *d = dl.nerf_layers(x[:, :cx], x[:, cx:],
                               [t for lay in layers
                                for t in (lay.weight, lay.bias)],
                               self.depth, self.skips)
        sigma = self.sigma(h)
        if sigma_only:
            return sigma.reshape(*lead, 1)
        rgb = torch.sigmoid(self.rgb[0](d[0]))
        return torch.cat([rgb, sigma], dim=-1).reshape(*lead, 4)
