"""RenderNet: the particle-driven NeRF renderer (port of
neurofluid_tpu/models/render_net.py).

Per sample point, the particles within the search radius give the local
geometry: density, smoothed position and neighbour-offset variance. They are
positionally encoded with the sample position, the ray direction and the
smoothed direction (each `encode_*` flag drops one; `ops/encode.py`, K10 on
the card), and a NeRF MLP maps them to (rgb, sigma). With `use_mask`,
samples with fewer than K in-radius particles get zero rgb and sigma. The
coarse pass renders `n_samples` samples; the fine pass adds `n_importance`
samples from the coarse weights, reuses the coarse geometry, searches only
the new samples, encodes the coarse and new samples' rows ray by ray in one
call, and sorts (z, rgbsigma) per ray before compositing (K5 on the card).

Two search modes compute the local geometry:
- 'dense' (default): the 13 ball-query sums (K3 on the card, K4 its
  backward), no neighbour lists; the first K in cell-candidate order.
- 'list': neighbour lists with pytorch3d's semantics (the first K by
  index, strict radius) from `ops/neighbor_search.py` on the
  `search_backend` ('grid', 'brute', or 'auto': the grid from 4,096
  particles), the coarse pass behind the AABB cull; the neighbours'
  coordinates are gathered by `segment_ops.take_rows_planned`, whose
  backward into the particles is the segment sum (K8 on the card).
  `search_selection` 'sort' and 'approx' are both exact here.
The two modes pick different neighbours once a neighbourhood holds more
than K particles; their counts and masks agree.

The random forms (`perturb`: stratified jitter and random CDF levels;
`noise_std`: sigma noise) draw from a `torch.Generator` in the order of the
JAX package's key split: coarse jitter, coarse noise, fine CDF levels, fine
noise.
"""

from __future__ import annotations

import torch
from torch import nn

from neurofluid_torch.cuda import resolve_device
from neurofluid_torch.models.init import generator_or_default
from neurofluid_torch.models.nerf import NeRF
from neurofluid_torch.ops import ball_features as bf
from neurofluid_torch.ops import encode as enc
from neurofluid_torch.ops import neighbor_search as ns
from neurofluid_torch.ops import ray_ops, segment_ops
from neurofluid_torch.utils.profiling import span

AUTO_GRID_POINTS = 4096  # search_backend='auto' takes the grid from here


class RenderNet(nn.Module):
    def __init__(self, near: float = 9.0, far: float = 13.0,
                 n_samples: int = 64, n_importance: int = 128,
                 particle_radius: float = 0.025,
                 search_radius_scale: float = 9.0, num_neighbors: int = 20,
                 use_mask: bool = True, encode_density: bool = True,
                 encode_var: bool = True, encode_smoothed_pos: bool = True,
                 encode_smoothed_dir: bool = True, exclude_ray: bool = True,
                 same_smooth_factor: bool = False, larger_alpha: float = 0.9,
                 smaller_alpha: float = 0.1, xyz_freqs: int = 10,
                 dir_freqs: int = 4, density_freqs: int = 4,
                 nerf_depth: int = 8, nerf_width: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 search_mode: str = "dense", search_backend: str = "auto",
                 search_selection: str = "approx",
                 grid_lower: tuple = (-1.05, -1.05, -1.05),
                 grid_upper: tuple = (1.05, 1.05, 2.55),
                 grid_max_per_cell: int = 128, query_chunk: int = 16384,
                 cull_capacity: float = 0.625,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if search_mode not in ("dense", "list"):
            raise ValueError(f"unknown search_mode: {search_mode}")
        if search_backend not in ("auto", "grid", "brute"):
            raise ValueError(f"unknown search_backend: {search_backend}")
        self.near, self.far = near, far
        self.n_samples, self.n_importance = n_samples, n_importance
        self.search_radius = search_radius_scale * particle_radius
        self.num_neighbors = num_neighbors
        self.use_mask = use_mask
        self.encode_density, self.encode_var = encode_density, encode_var
        self.encode_smoothed_pos = encode_smoothed_pos
        self.encode_smoothed_dir = encode_smoothed_dir
        self.exclude_ray = exclude_ray
        self.same_smooth_factor = same_smooth_factor
        self.larger_alpha, self.smaller_alpha = larger_alpha, smaller_alpha
        self.xyz_freqs, self.dir_freqs = xyz_freqs, dir_freqs
        self.density_freqs = density_freqs
        self.compute_dtype = compute_dtype
        self.search_mode, self.search_backend = search_mode, search_backend
        self.search_selection = search_selection
        self.grid_lower, self.grid_upper = tuple(grid_lower), tuple(grid_upper)
        self.grid_max_per_cell = grid_max_per_cell
        self.query_chunk = query_chunk
        self.cull_capacity = cull_capacity
        gen = generator_or_default(generator)
        kwargs = dict(depth=nerf_depth, width=nerf_width,
                      in_channels_xyz=self.in_channels_xyz,
                      in_channels_dir=self.in_channels_dir,
                      compute_dtype=compute_dtype,
                      device=resolve_device(device), generator=gen)
        self.nerf_coarse = NeRF(**kwargs)
        self.nerf_fine = NeRF(**kwargs)

    @property
    def encoding(self) -> enc.Encoding:
        return enc.Encoding(self.xyz_freqs, self.density_freqs,
                            self.dir_freqs, self.encode_density,
                            self.encode_smoothed_pos, self.encode_var,
                            self.encode_smoothed_dir)

    @property
    def in_channels_xyz(self) -> int:
        return self.encoding.width(sigma_only=True)

    @property
    def in_channels_dir(self) -> int:
        return self.encoding.width(sigma_only=False) - self.in_channels_xyz

    # ------------------------------------------------------------------
    # search + local geometry features
    # ------------------------------------------------------------------

    def _backend(self, n_points: int) -> str:
        if self.search_backend == "auto":
            return "grid" if n_points >= AUTO_GRID_POINTS else "brute"
        return self.search_backend

    def build_grid(self, particles: torch.Tensor) -> ns.CellGrid:
        """Cell grid over the particles (cell = search radius), shared by
        the coarse and fine passes of one render."""
        return ns.build_cell_grid(particles, self.grid_lower, self.grid_upper,
                                  self.search_radius, self.grid_max_per_cell)

    def _shared_grid(self, particles: torch.Tensor):
        """The grid both passes search, or None where none is searched
        (the brute backend, and the dense path, which ignores it)."""
        if (self.search_mode == "list"
                and self._backend(particles.shape[0]) == "grid"):
            return self.build_grid(particles)
        return None

    def search(self, sample_xyz: torch.Tensor, particles: torch.Tensor,
               grid: ns.CellGrid | None = None, cull: bool = True):
        """pytorch3d ball query around the flattened samples: (NeighborList
        over R*S queries, grid overflow flag). `grid`: a prebuilt grid of
        `particles` (else built here on the grid backend). `cull` puts the
        AABB capacity cull in front of the grid search; it is off for the
        fine pass, whose importance samples crowd inside the fluid."""
        radius, k = self.search_radius, self.num_neighbors
        flat = sample_xyz.reshape(-1, 3)
        kw = dict(order="index", inclusive=False,
                  query_chunk=self.query_chunk,
                  selection=self.search_selection)
        if self._backend(particles.shape[0]) == "grid":
            if grid is None:
                grid = self.build_grid(particles)
            if cull and self.cull_capacity > 0:
                # the JAX package's expression, float floor division included
                capacity = int(-(-flat.shape[0] * self.cull_capacity // 256)
                               * 256)
                return ns.radius_search_grid_culled(
                    flat, grid, radius, k, capacity=capacity, **kw)
            return ns.radius_search_grid(flat, grid, radius, k, **kw)
        return (ns.radius_search_brute(flat, particles, radius, k, **kw),
                torch.zeros((), dtype=torch.bool, device=flat.device))

    def _local_geometry(self, particles, sample_xyz, nbrs):
        """The list path's local geometry (reference
        models/renderer.py:96-179) from the neighbour lists: (Geometry of
        the R*S samples, num_nn (R*S, 1), in-radius count (R*S,))."""
        flat = sample_xyz.reshape(-1, 3)
        radius = self.search_radius
        # num_nn and the full-K mask come from the exact in-radius count
        count = nbrs.count.reshape(-1)
        num_nn = torch.clamp(count, max=self.num_neighbors).to(
            flat.dtype)[:, None]
        # one (Q, K) row gather of the particles; its backward is the
        # segment sum over the list's plan (K8 on the card). Padding slots
        # gather zero rows.
        plan = segment_ops.AdjointPlan(nbrs.idx, particles.shape[0])
        nb_raw = segment_ops.take_rows_planned(particles, nbrs.idx,
                                               plan).unbind(-1)
        # padded slots read as the origin (pytorch3d's masked_gather),
        # which the smoothing weights below inherit
        nb = [torch.where(nbrs.mask, c, 0.0) for c in nb_raw]
        # the reference's nn_mask: ball-query distances != 0
        sq = torch.where(nbrs.mask, sum((nb_raw[ax] - flat[:, ax, None]) ** 2
                                        for ax in range(3)), 0.0)
        nn_mask = sq != 0.0
        d2_eu = sum((nb[ax] - flat[:, ax, None]) ** 2 for ax in range(3))
        u = torch.sqrt(torch.clamp(d2_eu, min=1e-24)) / radius
        w = torch.clamp(1.0 - u * u * u, min=0.0)
        w_sum = w.sum(dim=-1, keepdim=True)
        smoothed_pos = torch.stack([(w * nb[ax]).sum(-1) for ax in range(3)],
                                   dim=-1) / (w_sum + 1e-12)
        var = None
        if self.encode_var:
            num_nn_k = num_nn + 1e-12
            axes = []
            for ax in range(3):
                vec = torch.where(nn_mask, nb[ax] - flat[:, ax, None], 0.0)
                vec_mean = vec.sum(-1, keepdim=True) / num_nn_k
                v = torch.where(nn_mask, (vec - vec_mean) ** 2, 0.0)
                axes.append(v.sum(-1) / num_nn_k[:, 0])
            var = torch.stack(axes, dim=-1)
        return enc.Geometry(flat, w_sum, smoothed_pos, var), num_nn, count

    def _blend(self, geom: enc.Geometry, num_nn) -> enc.Geometry:
        """The geometry as it is encoded (both search modes): with
        `exclude_ray` off, the smoothed position blended with the
        sample's."""
        if self.exclude_ray:
            return geom
        flat, smoothed_pos = geom.xyz, geom.smoothed_pos
        # blend of the sample and the smoothed position (reference
        # models/renderer.py:98-109): larger_alpha, or smaller_alpha
        # where num_nn <= 20 unless same_smooth_factor. The 20 is the
        # reference's literal, not num_neighbors: with K = 20 slots
        # num_nn never exceeds it, so the blend is smaller_alpha
        # everywhere; copied as it is.
        if self.same_smooth_factor:
            alpha = torch.full_like(num_nn, self.larger_alpha)
        else:
            alpha = torch.where(num_nn <= 20.0, self.smaller_alpha,
                                self.larger_alpha)
        smoothed_pos = flat * (1.0 - alpha) + smoothed_pos * alpha
        return geom._replace(smoothed_pos=smoothed_pos)

    def _geometry_dense(self, particles, sample_xyz, cull=True):
        """The dense path's local geometry: the ball-feature sums (K3 on
        the card, K4 its backward), no neighbour lists."""
        flat = sample_xyz.reshape(-1, 3)
        sums, overflow = bf.ball_feature_sums(
            flat, particles, self.search_radius, self.num_neighbors,
            self.grid_lower, self.grid_upper,
            max_per_cell=self.grid_max_per_cell,
            capacity_frac=(self.cull_capacity
                           if cull and self.cull_capacity > 0 else 1.0))
        density, smoothed_pos, var, num_nn, count = bf.assemble_features(
            sums, flat, self.search_radius, self.num_neighbors)
        return (enc.Geometry(flat, density, smoothed_pos, var), num_nn, count,
                overflow)

    def _features(self, particles, sample_xyz, rays, ro, sigma_only=False,
                  grid=None, cull=True, before=None):
        """For samples (R, S, 3): the NeRF's input rows (R*S, C), the
        samples' geometry as encoded, num_nn (R*S, 1), the full-K mask
        (R, S, 1) and the overflow flag. `before`: the geometry of samples
        encoded ahead of these on each ray (the fine pass's coarse ones),
        whose rows then come first on each ray: (R*(S0+S), C). The dense
        path ignores `grid`, as the JAX package's does."""
        with span("render.features"):
            if self.search_mode == "dense":
                geom, num_nn, count, overflow = self._geometry_dense(
                    particles, sample_xyz, cull=cull)
            else:
                nbrs, overflow = self.search(sample_xyz, particles, grid=grid,
                                             cull=cull)
                geom, num_nn, count = self._local_geometry(
                    particles, sample_xyz, nbrs)
            geom = self._blend(geom, num_nn)
            full_mask = (count >= self.num_neighbors).reshape(
                -1, sample_xyz.shape[1], 1)
            feats = enc.encode_features(
                [geom] if before is None else [before, geom], rays, ro,
                self.encoding, sigma_only)
            return feats, geom, num_nn, full_mask, overflow

    def _run_nerf(self, mlp, particles, sample_xyz, rays, ro,
                  sigma_only=False, grid=None, cull=True):
        feats, _, num_nn, full_mask, overflow = self._features(
            particles, sample_xyz, rays, ro, sigma_only=sigma_only, grid=grid,
            cull=cull)
        out = mlp(feats, sigma_only=sigma_only)
        out = out.reshape(*sample_xyz.shape[:2], out.shape[-1])
        if self.use_mask:
            out = out * full_mask.to(out.dtype)
        return out, num_nn, full_mask, overflow

    # ------------------------------------------------------------------
    # render passes
    # ------------------------------------------------------------------

    def forward(self, particles: torch.Tensor, ro: torch.Tensor,
                rays: torch.Tensor, generator: torch.Generator | None = None,
                perturb: float = 0.0, noise_std: float = 0.0,
                white_background: bool = True,
                grid: ns.CellGrid | None = None) -> dict:
        """Coarse + fine render of a ray batch (reference
        renderer.py:211-270).

        particles (N, 3); ro (3,) camera origin; rays (R, 6). `perturb`
        and `noise_std` draw from `generator`. `grid`: a prebuilt
        `build_grid(particles)` (a chunked full-image render builds it
        once). Returns rgb0/depth0/opacity0/num_nn_0/mask_0,
        rgb1/depth1/opacity1/num_nn_1/mask_1 (when n_importance > 0) and
        `overflow`."""
        with span("render"):
            n_rays, s0 = rays.shape[0], self.n_samples
            if grid is None:
                grid = self._shared_grid(particles)
            z0, xyz0 = ray_ops.coarse_sample_rays(
                self.near, self.far, rays, s0, perturb=perturb,
                generator=generator)
            feats0, geom0, num_nn0, mask0, overflow0 = self._features(
                particles, xyz0, rays, ro, grid=grid)
            rgbsigma0 = self.nerf_coarse(feats0).reshape(n_rays, s0, 4)
            if self.use_mask:
                rgbsigma0 = rgbsigma0 * mask0.to(rgbsigma0.dtype)
            rgb0, depth0, weights0 = ray_ops.composite(
                rgbsigma0, z0, rays, white_background, noise_std, generator)
            results = dict(rgb0=rgb0, depth0=depth0, opacity0=weights0.sum(1),
                           num_nn_0=num_nn0, mask_0=mask0.sum(dim=(1, 2)),
                           overflow=overflow0)
            if self.n_importance == 0:
                return results

            # the fine pass: the coarse geometry is reused, only the new
            # samples are searched, and (z, rgbsigma) is sorted per ray
            s1 = self.n_importance
            z_mid = 0.5 * (z0[..., 1:] + z0[..., :-1])
            z_new = ray_ops.sample_pdf(z_mid, weights0[:, 1:-1], s1,
                                       det=(perturb == 0),
                                       generator=generator).detach()
            xyz_new = rays[:, None, :3] + rays[:, None, 3:] * z_new[..., None]
            feats_all, _, num_nn_new, mask_new, overflow_new = self._features(
                particles, xyz_new, rays, ro, grid=grid, cull=False,
                before=geom0)
            rgbsigma1 = self.nerf_fine(feats_all).reshape(n_rays, s0 + s1, 4)
            mask1 = torch.cat([mask0, mask_new], dim=1)
            if self.use_mask:
                rgbsigma1 = rgbsigma1 * mask1.to(rgbsigma1.dtype)
            z1, order = torch.sort(torch.cat([z0, z_new], dim=-1), dim=-1,
                                   stable=True)
            rgbsigma1 = torch.gather(rgbsigma1, 1,
                                     order[..., None].expand(-1, -1, 4))
            rgb1, depth1, weights1 = ray_ops.composite(
                rgbsigma1, z1, rays, white_background, noise_std, generator)
            num_nn1 = torch.cat([num_nn0.reshape(n_rays, s0),
                                 num_nn_new.reshape(n_rays, s1)], dim=1)
            results.update(rgb1=rgb1, depth1=depth1, opacity1=weights1.sum(1),
                           num_nn_1=num_nn1.reshape(-1, 1),
                           mask_1=mask1.sum(dim=(1, 2)),
                           overflow=overflow0 | overflow_new)
            return results

    def coarse_rendering(self, particles, ro, rays,
                         generator: torch.Generator | None = None,
                         perturb: float = 0.0, noise_std: float = 0.0,
                         white_background: bool = True) -> dict:
        """The coarse pass alone (reference renderer.py:273-307): rgb0,
        depth0, opacity0, num_nn_0, mask_0, overflow."""
        with span("render"):
            grid = self._shared_grid(particles)
            z0, xyz0 = ray_ops.coarse_sample_rays(
                self.near, self.far, rays, self.n_samples, perturb=perturb,
                generator=generator)
            rgbsigma0, num_nn0, mask0, overflow0 = self._run_nerf(
                self.nerf_coarse, particles, xyz0, rays, ro, grid=grid)
            rgb0, depth0, weights0 = ray_ops.composite(
                rgbsigma0, z0, rays, white_background, noise_std, generator)
            return dict(rgb0=rgb0, depth0=depth0, opacity0=weights0.sum(1),
                        num_nn_0=num_nn0, mask_0=mask0.sum(dim=(1, 2)),
                        overflow=overflow0)

    def fine_rendering(self, particles, ro, rays,
                       generator: torch.Generator | None = None,
                       perturb: float = 0.0, noise_std: float = 0.0,
                       white_background: bool = True) -> dict:
        """A sigma-only coarse pass for the weights, then the full fine
        pass over the coarse and importance samples, all searched
        (reference renderer.py:310-369): rgb1, depth1, opacity1, num_nn_1,
        mask_1, overflow. As in the JAX package, the fine compositing gets
        no random stream, so `noise_std > 0` raises there."""
        with span("render"):
            grid = self._shared_grid(particles)
            z0, xyz0 = ray_ops.coarse_sample_rays(
                self.near, self.far, rays, self.n_samples, perturb=perturb,
                generator=generator)
            sigmas0, _, mask0, overflow0 = self._run_nerf(
                self.nerf_coarse, particles, xyz0, rays, ro, sigma_only=True,
                grid=grid)
            # weights from sigma-only compositing (the rgb channels unused)
            dummy = torch.cat([torch.zeros_like(sigmas0).repeat(1, 1, 3),
                               sigmas0], dim=-1)
            _, _, weights0 = ray_ops.composite(dummy, z0, rays, False,
                                               noise_std, generator)
            xyz1, z1 = ray_ops.importance_sampling(
                z0, weights0, self.n_importance, rays[:, :3], rays[:, 3:],
                det=(perturb == 0), generator=generator)
            rgbsigma1, num_nn1, mask1, overflow1 = self._run_nerf(
                self.nerf_fine, particles, xyz1, rays, ro, grid=grid,
                cull=False)
            rgb1, depth1, weights1 = ray_ops.composite(
                rgbsigma1, z1, rays, white_background, noise_std)
            return dict(rgb1=rgb1, depth1=depth1, opacity1=weights1.sum(1),
                        num_nn_1=num_nn1, mask_1=mask1.sum(dim=(1, 2)),
                        overflow=overflow0 | overflow1)


def camera_origin(c2w: torch.Tensor) -> torch.Tensor:
    """Camera position in world coordinates (reference renderer.py:47-53)."""
    return c2w[:, 3]
