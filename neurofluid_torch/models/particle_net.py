"""ParticleNet: the learned Lagrangian fluid transition model (port of
neurofluid_tpu/models/particle_net.py, every search backend, and its
sharded forward).

One step (reference models/transmodel.py:100-148):
1. semi-implicit Euler with gravity: v' = v + g dt; x' = x + (v + v')/2 dt;
2. position correction from 4 rounds of continuous convolutions, radius
   3 * radius_scale * particle_radius:
   - layer 0: fluid -> fluid conv on [1, v'] (4 ch), box -> fluid conv on
     the box normals (3 ch) and a dense layer, concatenated as
     [obstacle, fluid, dense];
   - layers 1-3: ReLU -> conv + dense, plus a residual where widths match;
   - the result scaled by 1/128;
3. x'' = x' + dx; v'' = (x'' - x) / dt.

`search_backend='fused_cconv'`: no neighbour lists and no caps; the whole
layer stack runs in cell-sorted order through the fused conv (K1 and K2 on
the card) and is unsorted once at the end. `search_backend='fused'`: one
compact fixed-K neighbour list of the fluid and one of the box per step
(`ops.fused_query`, K7 on the card), shared by all layers; the conv
geometry and the fluid tap matrix are computed once per list and each layer
is a gather and two matrix products (`ops.cconv`), the gathers' adjoint
being the segment sum (K8 on the card). `search_backend='grid'`,
`'brute'` and `'auto'` build the same lists by the plain searches of
`ops.neighbor_search` (the k nearest by the 27-cell grid, or by brute
force; `'auto'` takes the grid from AUTO_GRID_POINTS searched points on)
and run the same list conv. All backends compute the same sums wherever no
neighbourhood exceeds its cap; `cap_exceeded` says when one does.

Sharded (`shard_group`, a process group; JAX's `shard_axis` inside
`shard_map`): pos and vel are this rank's rows of the particle set, and the
outputs are too. Each layer's inputs are extended by the other ranks'
rows: all of them (`all_gather_rows`, whose backward is the reduce-scatter
of the gathered rows' cotangent), or with `halo_size` > 0 only the H rows
at each face of this rank's slab, from the ranks on either side
(`_halo_plan`). Sharded, every backend runs the list conv: 'fused_cconv'
searches by brute force (the box by its grid when one is passed) and
'fused' by the grid with the halo slots' valid mask, as the JAX package
routes them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from neurofluid_torch.cuda import device_constant, resolve_device
from neurofluid_torch.models.init import (
    generator_or_default, init_linear, uniform_,
)
from neurofluid_torch.ops import cconv
from neurofluid_torch.ops import fused_cconv as fc
from neurofluid_torch.ops import fused_query, segment_ops
from neurofluid_torch.ops import neighbor_search as ns
from neurofluid_torch.ops.neighbor_search import CellGrid, build_cell_grid
from neurofluid_torch.parallel.collectives import (
    all_gather_rows, any_over, shift,
)
from neurofluid_torch.utils.profiling import span

SEARCH_BACKENDS = ("fused_cconv", "fused", "grid", "brute", "auto")
# 'auto' searches by grid from this many searched points on, else by brute
# force (the JAX package's threshold)
AUTO_GRID_POINTS = 4096


class ContinuousConvLayer(nn.Module):
    """Open3D ContinuousConv parameters: `kernel` (kz, ky, kx, Cin, Cout)
    and `bias` (Cout,); the conv itself is `ops.fused_cconv` (`forward`) or
    `ops.cconv` over a neighbour list (`forward_list`), its contractions at
    `precision` (a `conv_precision` name; JAX's `precision` field)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: tuple,
                 precision: str = "highest"):
        super().__init__()
        cconv.conv_bf16(precision)  # an unknown name raises
        self.precision = str(precision).lower()
        self.kernel = nn.Parameter(torch.empty(
            (*kernel_size, in_channels, filters), device="meta"))
        self.bias = nn.Parameter(torch.empty(filters, device="meta"))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform over (taps * Cin, taps * Cout), zero bias (the
        JAX package's init)."""
        *ks, cin, cout = self.kernel.shape
        taps = math.prod(ks)
        uniform_(self.kernel, math.sqrt(6.0 / (taps * (cin + cout))), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, feats_s, qplan, qpos_s, cplan, cpos_s, radius,
                exclude_self):
        out, counts = fc.fused_cconv(self.kernel, qplan, qpos_s, cplan,
                                     cpos_s, feats_s, radius, exclude_self,
                                     self.precision)
        return out + self.bias, counts

    def forward_list(self, feats, neighbors, corner, tapw, plan,
                     tap_matrix=None):
        return cconv.continuous_conv_apply(
            self.kernel, corner, tapw, feats, neighbors, plan=plan,
            tap_matrix=tap_matrix, precision=self.precision) + self.bias


class ParticleNet(nn.Module):
    def __init__(self, layer_channels: tuple = (32, 64, 64, 3),
                 kernel_size: tuple = (4, 4, 4), radius_scale: float = 1.5,
                 particle_radius: float = 0.025, timestep: float = 1.0 / 50.0,
                 gravity: tuple = (0.0, -9.81, 0.0),
                 other_feats_channels: int = 0,
                 correction_scale: float = 1.0 / 128.0,
                 fluid_neighbor_k: int = 64, obstacle_neighbor_k: int = 48,
                 search_backend: str = "fused_cconv",
                 fused_group_size: int = 16, fused_slab_cap: int = 128,
                 fused_cell_scale: float = 1.0,
                 grid_lower: tuple = (-1.05, -1.05, -1.05),
                 grid_upper: tuple = (1.05, 1.05, 2.55),
                 grid_max_per_cell: int = 32, query_chunk: int = 4096,
                 conv_precision: str = "highest", shard_group=None,
                 halo_size: int = 0, halo_axis: int = 0,
                 device="cuda", generator: torch.Generator | None = None):
        """`fluid_neighbor_k`, `obstacle_neighbor_k` and `grid_max_per_cell`
        are the static caps of the list backends' lists and cell tables
        (about 47 fluid neighbours and 11 particles per cell at rest
        density); `query_chunk` is how many queries the plain grid and
        brute-force searches take at a time (their memory, not their
        result); `fused_*` size the `fused_cconv` backend's plan.
        `conv_precision` takes the JAX package's values (its MXU precision
        of the conv contractions), any case, and reaches every conv layer
        on every backend, sharded included: 'default' rounds both operands
        of every conv contraction, forward and backward, to bf16 and sums
        in f32, as JAX's one `DEFAULT` MXU pass does on the TPU (K1 and K2
        run their bf16 instantiations, the list conv `cconv.bf16_product`);
        'highest' and 'high' compute in f32 class (f32 SIMT, 3xTF32
        tensor-core products in K1 and K2, f32 torch products), 'high'
        bitwise as 'highest' (JAX runs it as bf16_3x in the list conv). The
        dense layers are f32 whatever the value, as in JAX.
        `other_feats_channels`: width of the optional per-particle `feats`
        of `forward`.
        `shard_group`: the process group over which the particles are
        sharded (see the module docstring); `halo_size` > 0 switches its
        all-gather to the slab halo exchange, with the caller's contract
        that the particles were sorted by coordinate `halo_axis` before
        they were split into equal contiguous blocks. A halo too small for
        the band within the radius of a slab face, or a slab narrower than
        the radius, sets `grid_overflow` on every rank.

        The default backend is `'fused_cconv'`, where the JAX package's is
        `'auto'`: `'fused_cconv'` sums every in-radius neighbour, exact and
        uncapped as the reference's Open3D search, while `'auto'`/`'grid'`
        keep the `fluid_neighbor_k` nearest and flag `cap_exceeded` past
        them (the two agree while no neighbourhood passes its cap). The
        rollout, the e2e step and `scene.particle_net_kwargs()` rely on
        this default. Trainers that mirror the JAX package's must pass
        `search_backend=cfg.TRAIN.get("search_backend", "auto")`, the JAX
        trainers' own default."""
        super().__init__()
        # what `clone` builds a copy from (flax's `Module.clone`)
        self.init_kwargs = dict(
            layer_channels=layer_channels, kernel_size=kernel_size,
            radius_scale=radius_scale, particle_radius=particle_radius,
            timestep=timestep, gravity=gravity,
            other_feats_channels=other_feats_channels,
            correction_scale=correction_scale,
            fluid_neighbor_k=fluid_neighbor_k,
            obstacle_neighbor_k=obstacle_neighbor_k,
            search_backend=search_backend, fused_group_size=fused_group_size,
            fused_slab_cap=fused_slab_cap, fused_cell_scale=fused_cell_scale,
            grid_lower=grid_lower, grid_upper=grid_upper,
            grid_max_per_cell=grid_max_per_cell, query_chunk=query_chunk,
            conv_precision=conv_precision, shard_group=shard_group,
            halo_size=halo_size, halo_axis=halo_axis)
        if search_backend not in SEARCH_BACKENDS:
            raise ValueError(
                f"unknown search_backend {search_backend!r}: expected one "
                f"of {SEARCH_BACKENDS}")
        if halo_size and shard_group is None:
            raise ValueError("halo_size > 0 needs a shard_group")
        prec = str(conv_precision).lower()
        if prec not in cconv.PRECISIONS:
            raise ValueError(f"unknown conv_precision {conv_precision!r}: "
                             f"expected one of {cconv.PRECISIONS}")
        self.search_backend = search_backend
        self.shard_group = shard_group
        self.halo_size = int(halo_size)
        self.halo_axis = int(halo_axis)
        self.query_chunk = query_chunk
        self.fluid_neighbor_k = fluid_neighbor_k
        self.obstacle_neighbor_k = obstacle_neighbor_k
        self.grid_max_per_cell = grid_max_per_cell
        self.kernel_size = tuple(kernel_size)
        self.layer_channels = tuple(layer_channels)
        self.timestep = timestep
        self.gravity = tuple(gravity)
        self.correction_scale = correction_scale
        self.fused_group_size = fused_group_size
        self.fused_slab_cap = fused_slab_cap
        self.grid_lower = tuple(grid_lower)
        self.grid_upper = tuple(grid_upper)
        self.radius = 3.0 * radius_scale * particle_radius  # filter extent / 2
        self.cell_size = max(self.radius * fused_cell_scale, 1e-6)

        c0 = self.layer_channels[0]
        ks = tuple(kernel_size)
        fluid_ch = 4 + other_feats_channels
        self.conv0_fluid = ContinuousConvLayer(fluid_ch, c0, ks, prec)
        self.conv0_obstacle = ContinuousConvLayer(3, c0, ks, prec)
        self.dense0_fluid = nn.Linear(fluid_ch, c0, device="meta")
        width = 3 * c0
        for i, ch in enumerate(self.layer_channels[1:], start=1):
            setattr(self, f"conv{i}",
                    ContinuousConvLayer(width, ch, ks, prec))
            setattr(self, f"dense{i}", nn.Linear(width, ch, device="meta"))
            width = ch
        self.to_empty(device=resolve_device(device))
        gen = generator_or_default(generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear(m, gen)
            elif isinstance(m, ContinuousConvLayer):
                m.reset_parameters(gen)

    def clone(self, **changes) -> "ParticleNet":
        """A new ParticleNet of this one's constructor arguments with
        `changes` applied, on this one's device, holding this one's weights
        (flax's `Module.clone` with the same params)."""
        net = ParticleNet(**{**self.init_kwargs, **changes},
                          device=self.conv0_fluid.kernel.device,
                          generator=torch.Generator().manual_seed(0))
        net.load_state_dict(self.state_dict())
        return net

    def integrate_pos_vel(self, pos, vel):
        dt = self.timestep
        g = device_constant(self.gravity, pos.dtype, pos.device)
        vel_new = vel + g * dt
        return pos + (vel + vel_new) / 2.0 * dt, vel_new

    def make_grid(self, points: torch.Tensor) -> CellGrid:
        """The `CellGrid` of `points` at this model's geometry (cell =
        radius)."""
        return build_cell_grid(points, self.grid_lower, self.grid_upper,
                               max(self.radius, 1e-6), self.grid_max_per_cell)

    def make_box_plan(self, box: torch.Tensor):
        """Search structure of the static boundary particles: build it once
        per scene and pass it to every step. A candidate-only `CConvPlan`
        on the unsharded `fused_cconv` backend; None on `brute`, which
        searches the box by brute force; else a `CellGrid` (cell = radius),
        which sends the box search through the grid on `grid` and `auto`
        whatever the box's size (`search_route`), as the JAX trainers'
        `make_grid` does."""
        if self.search_backend == "brute":
            return None
        if self.search_backend != "fused_cconv" or self.shard_group is not None:
            return self.make_grid(box)
        return fc.build_plan(box, self.grid_lower, self.grid_upper,
                             self.cell_size, with_groups=False,
                             slab_cap=self.fused_slab_cap)

    def forward(self, pos, vel, box, box_feats, feats=None, box_plan=None):
        """One transition step. pos, vel (N, 3); box, box_feats (M, 3);
        feats: optional (N, other_feats_channels) extra fluid features;
        box_plan: `make_box_plan(box)`; when absent, the step builds what
        its search needs.

        Returns (pos, vel, num_fluid_neighbors (N,), diag) where diag holds
        the search-health flags {"grid_overflow", "cap_exceeded"}: a cell
        table or grouping bound was hit, or (the list backends only; the
        `fused_cconv` backend has no cap) a neighbourhood held more than
        `fluid_neighbor_k` / `obstacle_neighbor_k` particles and the conv
        saw only k of them (the first k on `fused`, the k nearest on the
        others)."""
        with span("particle_net"):
            box, box_feats = box.detach(), box_feats.detach()
            pos_new, vel_new = self.integrate_pos_vel(pos, vel)
            fluid = [torch.ones_like(pos_new[:, :1]), vel_new]
            if feats is not None:
                fluid.append(feats)
            fluid = torch.cat(fluid, dim=-1)
            layers = (self._fused_cconv_layers
                      if self.search_backend == "fused_cconv"
                      and self.shard_group is None
                      else self._list_layers)
            correction, counts, diag = layers(pos_new, fluid, box, box_feats,
                                              box_plan)
            pos_corrected = pos_new + correction
            vel_corrected = (pos_corrected - pos) / self.timestep
            return pos_corrected, vel_corrected, counts, diag

    def _fused_cconv_layers(self, pos_new, fluid, box, box_feats, box_plan):
        radius = self.radius
        with span("particle_net.plan"):
            qplan = fc.build_plan(pos_new, self.grid_lower, self.grid_upper,
                                  self.cell_size,
                                  group_size=self.fused_group_size,
                                  slab_cap=self.fused_slab_cap)
            if not isinstance(box_plan, fc.CConvPlan):
                box_plan = self.make_box_plan(box)
            pad = qplan.slab_cap
            qpos_s = fc.sort_values(pos_new, qplan, pad,
                                    fc.SENTINEL).contiguous()
            ff = fc.sort_values(fluid, qplan)
            bfeats_s = fc.sort_values(box_feats, box_plan,
                                      box_plan.slab_cap).contiguous()

        def pad0(x):
            return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]).contiguous()

        ans_fluid, counts = self.conv0_fluid(pad0(ff), qplan, qpos_s, qplan,
                                             qpos_s, radius, True)
        ans_obstacle, _ = self.conv0_obstacle(bfeats_s, qplan, qpos_s,
                                              box_plan, box_plan.pos_s,
                                              radius, False)
        h = torch.cat([ans_obstacle, ans_fluid, self.dense0_fluid(ff)], dim=-1)
        for i in range(1, len(self.layer_channels)):
            inp = torch.relu(h)
            ans_conv, _ = getattr(self, f"conv{i}")(pad0(inp), qplan, qpos_s,
                                                    qplan, qpos_s, radius,
                                                    True)
            out = ans_conv + getattr(self, f"dense{i}")(inp)
            h = out + h if out.shape[-1] == h.shape[-1] else out

        diag = {"grid_overflow": qplan.overflow,
                "cap_exceeded": torch.zeros_like(qplan.overflow)}
        return (fc.unsort_values(self.correction_scale * h, qplan),
                fc.unsort_values(counts, qplan), diag)

    def search_route(self, n_points: int, grid: CellGrid | None = None):
        """The search a list backend runs over `n_points` points, as the
        JAX package's `_search` routes it: 'fused' (K7's compact lists),
        'grid' or 'brute'. 'auto' means 'grid' from AUTO_GRID_POINTS
        points on, else 'brute'; a passed grid sends 'brute' (and so
        'auto' below the threshold) to the grid all the same. Sharded,
        'fused' takes the grid (its halo slots need the valid mask) and
        'fused_cconv' falls through to brute force, or to a passed grid."""
        backend = self.search_backend
        if backend == "auto":
            backend = "grid" if n_points >= AUTO_GRID_POINTS else "brute"
        if backend == "fused":
            return "fused" if self.shard_group is None else "grid"
        return "grid" if backend == "grid" or grid is not None else "brute"

    def _search(self, queries, points, k: int, exclude_self: bool,
                grid: CellGrid | None = None,
                points_valid: torch.Tensor | None = None):
        """(NeighborList, grid_overflow) of `points` around `queries` by
        `search_route`; the grid is built here when none is passed, from
        the points that `points_valid` marks (all when None; brute force
        excludes the others by their sentinel coordinates)."""
        route = self.search_route(points.shape[0], grid)
        if route != "brute" and grid is None:
            grid = build_cell_grid(points, self.grid_lower, self.grid_upper,
                                   max(self.radius, 1e-6),
                                   self.grid_max_per_cell, valid=points_valid)
        if route == "fused":
            return fused_query.ball_query_compact(
                queries, grid, self.radius, k, exclude_self=exclude_self)
        if route == "grid":
            return ns.radius_search_grid(
                queries, grid, self.radius, k, order="nearest",
                inclusive=True, exclude_self=exclude_self,
                query_chunk=self.query_chunk)
        return (ns.radius_search_brute(
            queries, points, self.radius, k, order="nearest", inclusive=True,
            exclude_self=exclude_self, query_chunk=self.query_chunk),
            torch.zeros((), dtype=torch.bool, device=queries.device))

    def _halo_plan(self, pos_new):
        """The slab halo exchange (JAX `_halo_plan`): (extend_pos,
        extend_feats, valid, halo_overflow). extend_* map this rank's
        (Nl, C) rows to (Nl + 2H, C): its own, then the last H rows of
        the rank before it, then the first H of the rank after it, where
        they lie within the radius of the shared face; the other slots
        read 1e9 (positions: outside every radius) or 0 (features), and
        `valid` marks them False. halo_overflow, the same on every rank:
        more than H particles in a face's band, a band member outside the
        H-slot window (slots follow the pre-step order, the band the
        integrated positions), or a slab narrower than the radius, so
        that a rank two away could hold a neighbour."""
        group, h = self.shard_group, self.halo_size
        n_local = pos_new.shape[0]
        if h > n_local:
            raise ValueError(f"halo_size {h} > local particles {n_local}")
        radius = self.radius
        c = pos_new[:, self.halo_axis].detach()
        hi, lo = c.max(), c.min()
        suf_mask = c[-h:] > hi - radius  # candidates for the next rank
        pre_mask = c[:h] < lo + radius  # ... and for the one before
        over = (((c > hi - radius).sum() > h) | ((c < lo + radius).sum() > h)
                | (c[:-h] > hi - radius).any() | (c[h:] < lo + radius).any())
        lo_p2 = shift(lo.reshape(1), 2, group)
        exists_p2 = shift(torch.ones_like(lo_p2), 2, group) > 0.5
        over = over | (exists_p2 & (lo_p2 - hi < radius)).any()
        halo_over = any_over(over, group)
        r_msk = shift(suf_mask.float(), -1, group) > 0.5  # from rank - 1
        l_msk = shift(pre_mask.float(), 1, group) > 0.5  # from rank + 1
        valid = torch.cat([r_msk.new_ones(n_local), r_msk, l_msk])

        def extend(x, fill):
            r = torch.where(r_msk[:, None], shift(x[-h:], -1, group), fill)
            left = torch.where(l_msk[:, None], shift(x[:h], 1, group), fill)
            return torch.cat([x, r, left])

        return (lambda p: extend(p, 1e9), lambda f: extend(f, 0.0), valid,
                halo_over)

    def _extension(self, pos_new):
        """(extend_pos, extend_feats, points_valid, halo_overflow) of the
        sharded forward: the identity unsharded, the all-gather over
        `shard_group`, or the halo exchange."""
        if self.shard_group is None:
            return (lambda x: x), (lambda x: x), None, None
        if self.halo_size > 0:
            return self._halo_plan(pos_new)

        def gather(x):
            return all_gather_rows(x, self.shard_group)

        return gather, gather, None, None

    def _list_layers(self, pos_new, fluid, box, box_feats, box_grid):
        extent = 2.0 * self.radius
        with span("particle_net.plan"):
            extend_pos, extend_feats, valid, halo_over = self._extension(
                pos_new)
            all_pos = extend_pos(pos_new)
            with span("particle_net.search"):
                fluid_nbrs, ov_fluid = self._search(
                    pos_new, all_pos, self.fluid_neighbor_k, True,
                    points_valid=valid)
                box_nbrs, ov_box = self._search(
                    pos_new, box, self.obstacle_neighbor_k, False,
                    grid=box_grid if isinstance(box_grid, CellGrid)
                    else None)
            if halo_over is not None:
                ov_fluid = ov_fluid | halo_over

            # the geometry and the backward plans, once per list for all
            # layers
            with span("particle_net.geometry"):
                fluid_plan = segment_ops.AdjointPlan(fluid_nbrs.idx,
                                                     all_pos.shape[0])
                box_plan = segment_ops.AdjointPlan(box_nbrs.idx,
                                                   box.shape[0])
                fl_corner, fl_tapw = cconv.cconv_geometry(
                    all_pos, pos_new, fluid_nbrs, extent, self.kernel_size,
                    fluid_plan)
                bx_corner, bx_tapw = cconv.cconv_geometry(
                    box, pos_new, box_nbrs, extent, self.kernel_size,
                    box_plan)
                # the fluid list feeds every fluid layer; the box list
                # only one
                fl_tw = cconv.cconv_tap_matrix(fl_corner, fl_tapw,
                                               math.prod(self.kernel_size))

        ans_fluid = self.conv0_fluid.forward_list(
            extend_feats(fluid), fluid_nbrs, None, None, fluid_plan,
            tap_matrix=fl_tw)
        ans_obstacle = self.conv0_obstacle.forward_list(
            box_feats, box_nbrs, bx_corner, bx_tapw, box_plan)
        h = torch.cat([ans_obstacle, ans_fluid, self.dense0_fluid(fluid)],
                      dim=-1)
        for i in range(1, len(self.layer_channels)):
            inp = torch.relu(h)
            ans_conv = getattr(self, f"conv{i}").forward_list(
                extend_feats(inp), fluid_nbrs, None, None, fluid_plan,
                tap_matrix=fl_tw)
            out = ans_conv + getattr(self, f"dense{i}")(inp)
            h = out + h if out.shape[-1] == h.shape[-1] else out

        diag = {"grid_overflow": ov_fluid | ov_box,
                "cap_exceeded": (
                    (fluid_nbrs.count > self.fluid_neighbor_k).any()
                    | (box_nbrs.count > self.obstacle_neighbor_k).any())}
        return self.correction_scale * h, fluid_nbrs.count.float(), diag
