#!/usr/bin/env python3
"""The PyTorch port's correctness check on one NVIDIA GPU: build its CUDA
kernels, hold each against its plain version at the bench working point,
and drive its paths there: the serving path (rollout + render), the
end-to-end train step, the transition-only train step on three search
backends, a scene written, loaded and rendered, the stage trainers and
evaluators at full width, the renderer's options and list path, the
sharded paths in a world of one over NCCL, the reference-protocol run at
a cut scene, and the trainers' draw of JAX's seeded initial weights. It
times nothing: `python3 -m nfbench.run --trace 1` measures the port.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):
1. device: name and power limit (nvidia-smi), torch and CUDA versions;
   TF32 off for every matmul and convolution;
2. build: nvcc of csrc/*.cu for sm_90a, one process per source;
   `cuobjdump -sass` of the built K1/K2 library: each of the 12
   instantiations of the tensor-core product holds HGMMA (`wgmma`) and no
   HMMA (`mma.sync`), TF32 HGMMA in the 6 3xTF32 ones and bf16 HGMMA
   alone in the 6 bf16 ones; each of the BF16_WALKS walk kernels of K1d
   and K2d holds bf16 HMMA; the 20 f32 walks of K1 and K2 and the 6
   3xTF32 products hold the parent's instructions (PARENT_F32_CODE, the
   count to the byte beside it); then that product (csrc/split_gemm.cuh,
   3xTF32 `wgmma` fed by TMA, the contractions of K1 and K2) on its own
   at the shapes of its three uses at the bench point, in the splits of k
   K1 and K2 give it, against a float64 product of the same seeded inputs
   (error relative to sum |a||b|, held to GEMM_TOL; `torch.matmul`'s f32
   error beside it); then its bf16 mode (conv_precision 'default') at the
   same shapes, A in bf16 as the walks write it, against a float64
   product of the bf16 inputs (GEMM_TOL, and at least 100 GEMM_TOL from
   the product with B unrounded, as tests/test_torch_split_gemm.py holds
   its emulation);
   then K9 (`dense_phase`, csrc/dense_layer.cu: the NeRF's wide layers,
   3xTF32 `wgmma` with bias and ReLU in the epilogue) at the NeRF's shapes,
   DENSE_SHAPES: its forward against float64 (error relative to sum
   |x||W|, GEMM_TOL; the plain version's error beside it), and the
   backward (G and its planes, dX, dW's splits and their sum, db) against
   float64 (dX relative to sum |g||W|, dW to sum |x||g|, db to sum |g|;
   GEMM_TOL);
3. forward kernels: K1 (fused conv), K3 (ball sums), K5 (compositing
   weights), each called at the shapes the serving path gives it (recorded
   from one warm-up pass) and held against its plain PyTorch version on the
   card (K5 also once at K5_LONG_SAMPLES samples a ray, its tile path);
   K1d (K1 at conv_precision 'default', its bf16 instantiations) at the
   same calls against the plain 'default' version (TOL, and BF16_MARGIN
   times nearer it than the plain 'highest' result); K10 (the feature
   encoding) at the render's two calls against the plain composition, and
   its backward from a seeded cotangent against the plain VJP in float64
   (ENCODE_BWD_TOL);
4. serving path: a 10-step ParticleNet rollout of the 14,336-particle
   scene, then the coarse (64) + fine (128) render of 1,024 rays, with
   seeded random weights; launch counts from that run (K9's as the
   difference of its library's count around it); the same path on the
   plain versions on the card (the NeRF's on its plain layers for K9, the
   encoding on its plain composition for K10), within tolerance;
5. backward kernels: K2 (fused conv), K4 (ball sums), K6 (compositing
   weights) at the shapes of one recorded warm-up train step, against their
   plain backward versions; K2 also once per layer with every gradient
   asked for (its dq/dc path); K2d (K2 at 'default') at the same calls in
   both forms, held as K1d in 3;
6. train path: TRAIN_STEPS e2e train steps (Adam 3e-4 / 1e-5, one view of
   1,024 rays, state carried from step to step), launch counts per step,
   finite loss and gradient norms, no overflow, an image gradient that
   reaches the transition model; then the warm-up step again from its
   weights and state: with the kernels, with the backward kernels on their
   plain versions (each leaf's gradient within 1e-4 of its largest entry),
   with the forward kernels on theirs, and with all of them (K9 too: the
   NeRFs on their plain layers), within tolerance;
7. list kernels: K7 (compact ball query) and K8 (segment sum) at the
   shapes of one recorded warm-up transition train step on the `fused`
   backend, against their plain versions (K7: ids and counts equal; K8:
   1e-5 of the largest entry);
8. transition train path: TRANSITION_STEPS 2-step train steps (clip by
   global norm 1.0, Adam 1e-4, targets pos + 0.001 / pos + 0.002) on
   `fused_cconv` and on `fused`, launch counts per step, a finite loss that
   falls, a gradient, no overflow and no neighbour cap exceeded; the two
   backends' first prediction and first loss within tolerance of each
   other; the warm-up step again with the path's kernels on their plain
   versions, and on `fused` with K8 alone on its plain version (loss
   bitwise equal, each leaf's gradient within 1e-4 of its largest entry);
   then TRANSITION_STEPS steps on `fused_cconv` at conv_precision
   'default' (K1d 10, K2d 10 per step and the bf16 product: their main
   path) beside as many at 'highest' from the same weights, the first
   steps' loss and grad_norm within BF16_STEP_TOL (and not equal);
9. transition train path on `auto`, the JAX trainers' own backend: the
   search it resolves to for the fluid and the box (both the plain grid
   search at the bench point), its first step against `fused`'s from the
   same weights (equal neighbour counts; loss, grad_norm and each
   gradient leaf within AUTO_STEP_TOL), TRANSITION_STEPS counted steps
   as in 8 (K8 8 per step, K7 none), and the warm-up step again with
   K8 on its plain version;
10. search check: the fluid's lists at the bench point by
   `radius_search_grid`, `radius_search_brute` and K7 (equal counts and
   neighbour sets, grid and brute force in nearest order, no grid
   overflow);
11. scene-to-render: a Blender-layout scene written by the port's
   `data.synthetic` into a temporary directory under build/, loaded by its
   `BlenderDataset`, RENDER_RAYS of frame 0's rays of one view (seeded
   choice) rendered by a seeded `RenderNet()` at its full defaults over
   that frame's particles (K3 and K5 twice each); the RGB MSE against the
   image's pixels;
12. trainers (`trainers_phase`): the warm-up, transition and e2e trainers
   and the three evaluators of `neurofluid_torch.train`, as the `cli`
   entry points build them from the shipped configs/*.yaml (counts and
   intervals set, widths as shipped), on a TRAINER_SCENE synthetic scene
   (13,824 particles, 400 x 400 views) written under build/; per stage
   losses, peak memory, launches (K3-K6 and K8 on `'auto'`), PSNR and
   Pred2GT (finite), checkpoints written and read back; the first e2e
   trainer step against the same step with every kernel on its plain
   version (STEP_TOL);
13. renderer options and list path (`options_phase`), at the bench point:
   the list render on 'auto' (grid) with 'approx' (K5 2, no K3; its
   counts and masks equal to 4's dense render, its fine counts equal to
   K3's on the same samples; against itself with K5 plain), its particle
   gradient (K8 2) and an e2e train step with it (K1 5, K2 5, K5 2, K6 2,
   K8 2; the first again with K8 plain, each gradient leaf within 1e-4),
   the warm-up step of `build_renderer` with RENDERER.bf16 true and false
   (peak memory, renders within BF16_TOL), `coarse_rendering`,
   `fine_rendering`, a seeded perturb=1 noise_std=1 render twice (bitwise
   equal), exclude_ray=False, the chamfer distance of 4's end state
   against its start beside scipy's cKDTree, and LPIPS of two 400 x 400
   images on random weights written under build/; then K8 at the list
   render gradient's calls against its plain version;
14. sharded paths (`parallel_phase`) in a world of one over NCCL (a
   FileStore under build/): SHARDED_STEPS steps of `make_sharded_e2e_step`
   (K1 5, K2 5, K3-K6 2 per step) against phase 6's step, the all-gather
   particle step on 'auto' and the halo step on 'grid' at the
   13,824-particle lattice (halo 1,024) against the unsharded step, and
   SHARDED_STEPS steps of `make_spmd_e2e_step` on a 1 x 1 mesh on 'auto'
   (K3-K6 2, K8 at least 1 per step) against the replicated step, within
   the JAX dry run's tolerances, with peak memory; then the native
   library's chamfer distance against ops/chamfer.py's on the card, and a
   scene from `cli.generate_data` loaded by `BlenderDataset`;
15. the reference-protocol run (`protocol_phase`): the port's
   `cli.full_protocol_run.main` at a cut scene (PROTOCOL_SCENE: 1,728
   fluid particles, 100 x 100 images, 61 frames, one pretraining sim of
   50 frames; PROTOCOL_KNOBS: 20 warm-up iterations, one transition and
   one e2e epoch, every 25th frame rendered) at full model width and the
   runner's conv_precision 'default' (K1d, K2d), under
   build/: every key of PROTOCOL_R5.json and `device` in its record,
   every metric finite, per stage its peak memory and launches (K7 and
   K8 none); `cli.reval_e2e_rollout.main` on the saved e2e checkpoint and
   a second, resumed run, each against the first;
16. JAX's initial weights (`seed_phase`): the protocol's warm-up RenderNet
   and its ParticleNet as the seeded trainers draw them (JAX's key stream
   of TRAIN.seed 10 and flax's per-parameter keys, on the host), built on
   the card and on the host, every tensor bitwise equal, SEED_PINS (pinned
   from JAX) met, no kernel launched;
17. the kernels line (K1-K8, then K1d, K2d, the bf16 product, K9 and K10:
   launches and the largest error against the plain version), the card
   line, and the result line last.

Without a CUDA device, or without the package beside it, the script exits
non-zero before printing any result.
"""


import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

ROLLOUT_STEPS = 10
# K9: 10 per NeRF forward, a coarse and a fine pass a render; in a train
# step's backward dX and dW of each of both NeRFs' 10 layers (the image
# gradient reaches the features, so layer 0 takes dX too). K10: the
# encoding, once a pass (the fine pass's rows from both sources in one
# call), and in a train step's backward once a pass (its forward's and
# its backward's launches counted together)
EXPECTED_LAUNCHES = {"K1": 5 * ROLLOUT_STEPS, "K3": 2, "K5": 2, "K9": 20,
                     "K10": 2}
TRAIN_STEPS = 5
STEP_LAUNCHES = {"K1": 5, "K2": 5, "K3": 2, "K4": 2, "K5": 2, "K6": 2,
                 "K7": 0, "K8": 0, "K9": 20 + 2 * 20, "K10": 2 + 2}
LR_RENDERER, LR_TRANSITION, BD_WEIGHT = 3e-4, 1e-5, 1.0
# the transition-only train step (two chained ParticleNet steps): launches
# per step on each search backend. `fused`: a fluid and a box query per
# ParticleNet step; K8 is the adjoint of each gather from the fluid list
# whose table carries a gradient: the three hidden layers' inputs in the
# first rollout step, and also the positions and the input features in the
# second, whose state depends on the weights.
TRANSITION_STEPS = 10
TRANSITION_LAUNCHES = {"fused_cconv": {"K1": 10, "K2": 10},
                       "fused": {"K7": 4, "K8": 8},
                       "auto": {"K8": 8}}
# the JAX trainers' default backend: at the bench point 'auto' searches the
# fluid (14,336 points, at least AUTO_GRID_POINTS) by the plain grid search,
# and the box (2,520 points, fewer) by the grid too because its grid is
# passed; K7 never launches; K8 is the adjoint of the same gathers as on
# `fused`
AUTO_ROUTES = {"fluid": "grid", "box": "grid"}
LR_TRANSITION_ONLY, TRANSITION_CLIP = 1e-4, 1.0
# the tensor-core product against float64, relative to sum |a||b|: 8 units
# of f32's rounding (2^-24), the limit tests/test_torch_split_gemm.py holds
# the split scheme's emulation to (one TF32 pass alone is ~1e-4)
GEMM_TOL = 2.0 ** -21
# kernel vs plain on the card, same inputs: K1 sums ~50 pairs x 8 taps and
# then 64 * Cin terms per output in another order (relative to the largest
# output, at least 1); K3 sums <= 20 selected terms (the same); K5 weights
# are <= 1 products of <= 192 factors (absolute). The backward kernels,
# relative to the largest entry of each output: K2 sums the same pairs in
# another order and dc, dfeats with atomics; K4 sums <= 20 terms per query
# per group in shared memory, then the groups' sums into each particle,
# both with atomics; K6 is runs per lane and warp scans against cumulative
# products and sums.
# K7 emits integers and copies of table entries: equal, no tolerance. K8
# sums <= 64 rows per segment in another order than the plain version.
# K10's rows are the plain composition's bits but for the smoothed
# direction's block, whose norm may sum in another order: 2^-20 absolute
# (its values are sines and cosines of at most 8 times a unit vector's
# entries); its backward is held against float64 (`ENCODE_BWD_TOL`)
TOL = {"K1": 1e-4, "K3": 1e-5, "K5": 1e-5, "K2": 1e-4, "K4": 1e-5,
       "K6": 1e-5, "K7": 0.0, "K8": 1e-5, "K10": 2.0 ** -20}
RELATIVE = {"K1": "max1", "K3": "max1", "K5": "abs", "K2": "max", "K4": "max",
            "K6": "max", "K7": "abs", "K8": "max", "K10": "abs"}
# K10's backward against the plain VJP in float64: f32 sums of up to 21
# terms of up to 2^9 |g|, relative to the sum of the terms' magnitudes
ENCODE_BWD_TOL = 1e-6
# K1d and K2d (K1 and K2 at precision 'default') against their plain
# 'default' versions: the same bf16-rounded operands summed in another f32
# order, so a sum on the edge of a bf16 rounding step (bf(acc), bf(d_acc))
# rounds one way in the kernel and the other in the plain version: one bf16
# unit (2^-8) of the largest entry; and the kernel's mean deviation from the
# plain 'default' result at least BF16_MARGIN times below its deviation
# from the plain 'highest' one (neither the f32 kernel nor an f32 fallback
# passes)
KERNEL_TOL = dict(TOL, K1d=2.0 ** -8, K2d=2.0 ** -8)
KERNEL_RELATIVE = dict(RELATIVE, K1d="max", K2d="max")
BF16_MARGIN = 10.0
# K1d's and K2d's walk kernels: walk_fwd_bf16_kernel<QB, NT, FOLD> at its
# six channel widths, walk_bwd_bf16_kernel<QB, LOCAL> at 2, 4 and 8 queries
BF16_WALKS = 18
# the f32 walks of K1 and K2 and the 3xTF32 product as the parent tree
# built them (`f32_sass_digests` of its library on an H100 machine, nvcc
# PARENT_F32_SASS_NVCC): phase 2 holds this tree's instructions to them
# with branch and call targets masked (PARENT_F32_CODE), and counts those
# that are the same to the byte (PARENT_F32_SASS)
PARENT_F32_SASS_NVCC = "12.9.86"
PARENT_F32_CODE = {
    "split_gemm_kernel<128,0,0>": "bed30e959a5fbee5",
    "split_gemm_kernel<128,1,0>": "24305c4ed3084144",
    "split_gemm_kernel<64,0,0>": "a3f4ed4fee73461c",
    "split_gemm_kernel<64,1,0>": "c4767c6c1fcb395f",
    "split_gemm_kernel<8,0,0>": "4659dd8d9ac88366",
    "split_gemm_kernel<8,1,0>": "25132f0d48f18cfe",
    "walk_bwd_kernel<1,0>": "12b6bdb63d881517",
    "walk_bwd_kernel<1,1>": "7c7cd17897627224",
    "walk_bwd_kernel<16,0>": "4d0f378b8f0eb028",
    "walk_bwd_kernel<16,1>": "9f2858da63909e10",
    "walk_bwd_kernel<2,0>": "b80dae3273f61c42",
    "walk_bwd_kernel<2,1>": "eed74fa373708a38",
    "walk_bwd_kernel<4,0>": "852bba9d02611b6b",
    "walk_bwd_kernel<4,1>": "04313aaa94d1566c",
    "walk_bwd_kernel<8,0>": "445c3df04753cd66",
    "walk_bwd_kernel<8,1>": "2f4beb1e216bb4f5",
    "walk_fwd_kernel<1,0>": "41a138c1db04b033",
    "walk_fwd_kernel<1,1>": "16bcea6fea2bd8ed",
    "walk_fwd_kernel<16,0>": "a16b2a3bc9054cdf",
    "walk_fwd_kernel<16,1>": "ed77e18ac6e3ce09",
    "walk_fwd_kernel<2,0>": "4211dbca6fea3e60",
    "walk_fwd_kernel<2,1>": "f068b531dd34159d",
    "walk_fwd_kernel<4,0>": "5bcb599eb77a84ba",
    "walk_fwd_kernel<4,1>": "cbc5dc226864ea78",
    "walk_fwd_kernel<8,0>": "29878005d23ecbf4",
    "walk_fwd_kernel<8,1>": "f15a44af9cd7a006",
}
PARENT_F32_SASS = {
    "split_gemm_kernel<128,0,0>": "011191e9c98ef539",
    "split_gemm_kernel<128,1,0>": "12e586b016e7c996",
    "split_gemm_kernel<64,0,0>": "2fb3d6e544652290",
    "split_gemm_kernel<64,1,0>": "c14cb5db5a374ea2",
    "split_gemm_kernel<8,0,0>": "b83f9b9154b7eb3f",
    "split_gemm_kernel<8,1,0>": "f4be9536f28a2830",
    "walk_bwd_kernel<1,0>": "4a11eed11282f7d1",
    "walk_bwd_kernel<1,1>": "ec569820bfb747be",
    "walk_bwd_kernel<16,0>": "819d886e29961b26",
    "walk_bwd_kernel<16,1>": "0358b6e5274d4096",
    "walk_bwd_kernel<2,0>": "a5dbf576c36986a4",
    "walk_bwd_kernel<2,1>": "f31207f854be4c07",
    "walk_bwd_kernel<4,0>": "52d8443fee536fae",
    "walk_bwd_kernel<4,1>": "670f3ab04e7c60b9",
    "walk_bwd_kernel<8,0>": "02ff813f11f07d24",
    "walk_bwd_kernel<8,1>": "2d1080c9a42ec3f6",
    "walk_fwd_kernel<1,0>": "3314d551085c7c9f",
    "walk_fwd_kernel<1,1>": "71360c2a02026322",
    "walk_fwd_kernel<16,0>": "58534b5557f9c203",
    "walk_fwd_kernel<16,1>": "3762b5d91932ff7d",
    "walk_fwd_kernel<2,0>": "6acb3128a23b8099",
    "walk_fwd_kernel<2,1>": "824f73220b300352",
    "walk_fwd_kernel<4,0>": "75fc6991fd5af3ce",
    "walk_fwd_kernel<4,1>": "48b9c2e674623c28",
    "walk_fwd_kernel<8,0>": "e56c4ee17697501f",
    "walk_fwd_kernel<8,1>": "486632377fb25828",
}
# phase 8, the `fused_cconv` transition step at 'default' against the same
# step at 'highest' from the same weights (the first step), relative: the
# bf16 operands move the conv outputs by about 2^-9 of a value
BF16_STEP_TOL = {"loss": 1e-2, "grad_norm": 5e-2}
# the train step against the kernels', from the same weights and state.
# With only K2, K4 and K6 on their plain versions the forward is bitwise
# the kernels', and every leaf's gradient differs only by the backward
# versions' summation order: held per leaf, relative to its largest entry.
BWD_STEP_TOL = {"loss": 0.0, "next_pos": 0.0, "grad_norm_renderer": 1e-4,
                "grad_norm_transition": 1e-4, "leaf_renderer": 1e-4,
                "leaf_transition": 1e-4}
# With K1, K3 and K5 (or all six) on their plain versions the forward agrees
# to f32 rounding, but a particle moved by a rounding step can cross a
# sample's radius shell: a count, a full-K mask or a first-K set changes,
# and so, discretely, do that sample's features and every gradient through
# it. The transition's gradient also passes the renderer's encoded variance
# feature (a difference of near-equal sums under sin/cos at 2^9). So each
# model's gradients are held relative to its largest entry.
STEP_TOL = {"loss": 1e-4, "grad_norm_renderer": 1e-3,
            "grad_norm_transition": 1e-2, "grads_renderer": 1e-3,
            "grads_transition": 1e-2, "next_pos": 1e-5}
# the transition train step against the kernels' own, from the same weights.
# With K8 (and K7, which is exact) on the plain version the forward is
# bitwise the kernels'; only the segment sums' order differs. With K1 and K2
# on theirs the forward agrees to f32 rounding and so do the gradients (no
# renderer amplifies them here).
LIST_STEP_TOL = {"loss": 0.0, "grad_norm": 1e-4, "leaf": 1e-4}
CCONV_STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-3, "grads": 1e-3}
# the first transition step on 'auto' against `fused` from the same weights:
# no count exceeds its cap, so both sum the same pairs, the lists in another
# order (nearest first against cell order): f32 summation order. Loss and
# grad_norm relative; each gradient leaf relative to its own largest entry.
AUTO_STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 1e-4}
# phase 14, the sharded paths in a world of one over NCCL: steps per path,
# launches per step (the spmd step also K8, at least once: the adjoint of
# the list conv's gathers of the hidden layers' features), the lattice's
# halo, and the JAX dry run's tolerances (neurofluid_tpu/parallel/dryrun.py
# `dryrun_multichip`: positions 1e-5, 1e-4 on the lattice, loss rtol 1e-5,
# gradient norms rtol 2e-3)
SHARDED_STEPS = 3
PARALLEL_LAUNCHES = {"ray-sharded": {"K1": 5, "K2": 5, "K3": 2, "K4": 2,
                                     "K5": 2, "K6": 2},
                     "spmd": {"K3": 2, "K4": 2, "K5": 2, "K6": 2}}
LATTICE_HALO = 1024
DRYRUN_TOL = {"pos": 1e-5, "lattice_pos": 1e-4, "loss": 1e-5,
              "grad_norm": 2e-3}
# K5 once more on rays longer than a warp's 256 samples (its tile path,
# not on the main path)
K5_LONG_SAMPLES = 300
# the scene-to-render pass: a synthetic Blender-layout scene written by the
# port's generator, loaded by its BlenderDataset, and RENDER_RAYS of frame
# 0's rays of one view rendered at RenderNet()'s full defaults
SCENE_KW = dict(n_frames=4, img_wh=(64, 64), train_views=("view_1", "view_2"),
                test_views=(), seed=10)
RENDER_RAYS = 1024
# the two backends sum the same pairs wherever no count exceeds its cap
BACKEND_TOL = {"loss": 1e-5, "pred_pos": 1e-5}
# sigma-head bias of the seeded renderer, so that samples with K neighbours
# are opaque (sigma ~ 10 per unit length: alpha ~ 0.5 per coarse step)
SIGMA_BIAS = 10.0

# the trainers phase: a synthetic Blender-layout scene at the shipped
# configs' widths (13,824 fluid particles, 400 x 400 views: four training
# views and the test view view_5, six frames), and the counts and intervals
# the phase sets in configs/*.yaml; every width stays as shipped (ray_chunk
# 1,024, 64 + 128 samples, NeRF 8 x 256, ParticleNet (32, 64, 64, 3) on
# 'auto', eval chunks of 2,048 rays)
TRAINER_SCENE = dict(n_frames=6, n_side=24, img_wh=(400, 400))
TRAINER_TEST_END = 3  # test frames 0-2: two test samples
WARMUP_STEPS, RENDERER_EVAL_FRAMES = 5, 2
E2E_STEPS = TRAINER_SCENE["n_frames"] - 1  # one epoch
# the kernels each stage must launch (every other kernel: none); the e2e
# stage's plain comparison launches none. The warm-up renders the constant
# GT particles, so no gradient reaches them and K4 does not run
TRAINER_KERNELS = {"warm-up": ("K3", "K5", "K6"),
                   "transition": ("K8",),
                   "e2e": ("K3", "K4", "K5", "K6", "K8"),
                   "evaluators": ("K3", "K5")}


# phase 13, the renderer's options and its list path at the bench point:
# the launches of each counted run. The list render searches on 'auto'
# (the grid: 14,336 particles) and runs no K3; its row gathers' adjoint
# into the particles is K8, once per pass wherever a gradient is asked
# for. The dense runs launch K3 and K5 once per pass; a warm-up step with
# bf16 or f32 products K3 2, K5 2, K6 2 on the bench point's one view.
OPTION_LAUNCHES = {
    "list render": {"K5": 2},
    "list render, K5 plain": {},
    "list render gradient": {"K5": 2, "K6": 2, "K8": 2},
    "list e2e step": {"K1": 5, "K2": 5, "K5": 2, "K6": 2, "K8": 2},
    "list e2e step, K8 plain": {"K1": 5, "K2": 5, "K5": 2, "K6": 2},
    "dense render": {"K3": 2, "K5": 2},
    "warm-up step": {"K3": 2, "K5": 2, "K6": 2},
    "coarse_rendering": {"K3": 1, "K5": 1},
    "fine_rendering": {"K3": 2, "K5": 2},
    "random render": {"K3": 2, "K5": 2},
    "exclude_ray=False render": {"K3": 2, "K5": 2}}
OPTION_STEPS = 3  # list e2e steps and warm-up steps of each dtype
# the list render against itself with K5 on its plain version: as the
# serving path's plain comparison (phase 4)
LIST_PLAIN_LIMITS = {"rgb0": 1e-4, "opacity0": 1e-4, "depth0": 1e-3,
                     "rgb1_mean": 1e-4, "opacity1_mean": 1e-4,
                     "depth1_mean": 1e-3}
# bf16 products against f32 ones from the same weights: rgb and opacity
# within one bf16 ulp at 1 (2^-8), depth (~11) within 2^-6; this phase
# read rgb 5.2e-4, opacity 9.4e-4, depth 9.5e-3 on an H100
BF16_TOL = {"rgb": 2.0 ** -8, "opacity": 2.0 ** -8, "depth": 2.0 ** -6}
# the chamfer distance (an f32 |x|^2 + |y|^2 - 2 x.y expansion, TF32 off)
# against scipy's cKDTree in float64; this phase read 6.4e-10 on an H100
CHAMFER_TOL = 1e-6
LPIPS_WH = (400, 400)

# phase 15, the reference-protocol run of the port's runner
# (neurofluid_torch.cli.full_protocol_run) at a cut scene: 1,728 fluid
# particles, 100 x 100 images, the 61 frames and 50 pretraining frames its
# Pred2GT windows need; every model width as the runner sets it (NeRF
# 8 x 256, ParticleNet (32, 64, 64, 3) on fused_cconv, 64 + 128 samples,
# 1,024-ray chunks). Stride 25 renders frames 0, 25 and 50, one of them a
# rollout frame (30 would render none, and the rollout means would be NaN)
PROTOCOL_SCENE = dict(n_frames=61, n_side=12, img=100, pretrain_frames=50)
PROTOCOL_KNOBS = dict(PROTO_N_SIMS="1", PROTO_WARMUP_ITERS="20",
                      PROTO_TRANS_EPOCHS="1", PROTO_E2E_EPOCHS="1",
                      PROTO_RENDER_STRIDE="25")
# the kernels each stage of the run launches; every other kernel: none
PROTOCOL_KERNELS = {"data": (), "warmup": ("K3", "K5", "K6"),
                    "transition": ("K1", "K2"), "e2e_setup": (),
                    "pretrained_rollout": ("K1",),
                    "e2e": ("K1", "K2", "K3", "K4", "K5", "K6"),
                    "rollout": ("K1",), "renders": ("K3", "K5")}
# a resumed run's pretrained row and the re-evaluated row against the first
# run's: relative, per window (K1's forward sums in a fixed order, so equal
# weights are expected to give equal rows; the rows print their difference)
PROTOCOL_RESUME_TOL = 1e-6

# phase 16, JAX's initial weights drawn by the port: the protocol's warm-up
# renderer (NeRF 8 x 256) and its ParticleNet (32, 64, 64, 3), each from the
# first key of a seeded trainer's stream, against the JAX package's own
# draw at TRAIN.seed SEED: per tensor the exact (math.fsum) f64 sum of its
# entries, its first 4 and its last 4 entries (tests/test_torch_jax_random.py
# recomputes them with JAX)
SEED = 10
SEED_PINS = {
    "nerf_coarse.xyz_encoding_1.0.weight": (
        0.9116928101650501,
        (0.026124469935894012, 0.07853846251964569, -0.04901311919093132,
         0.04723445698618889),
        (0.039674628525972366, 0.06523337960243225, 0.010675880126655102,
         -0.08309857547283173)),
    "nerf_coarse.rgb.0.weight": (
        3.2168942187927314,
        (-0.1412343531847, 0.12180859595537186, 0.11436279863119125,
         0.15120720863342285),
        (0.0388544537127018, -0.04205228388309479, 0.04275912791490555,
         -0.015550659038126469)),
    "nerf_fine.xyz_encoding_5.0.weight": (
        -19.035408770959748,
        (0.029413344338536263, -0.04204307869076729, 0.000724553712643683,
         0.0075010634027421474),
        (-0.04582025855779648, 0.028460867702960968, 0.061775438487529755,
         0.05662287399172783)),
    "nerf_fine.sigma.weight": (
        0.4349590407218784,
        (0.014583040960133076, 0.020994698628783226, -0.01624017208814621,
         -0.04360579326748848),
        (-0.03603089973330498, 0.0730949118733406, -0.05392294377088547,
         -0.04744524508714676)),
    "conv0_fluid.kernel": (
        5.012676740078859,
        (-0.0303149726241827, 0.025895316153764725, 0.04176458716392517,
         0.03360588476061821),
        (0.030052972957491875, -0.03525010868906975, -0.005445252172648907,
         -0.006633615121245384)),
    "conv3.kernel": (
        -0.27147165266887896,
        (-0.03021715208888054, -0.025847595185041428, -0.003183950437232852,
         -0.0315125435590744),
        (0.03048218972980976, -0.013652277179062366, -0.004767265636473894,
         0.012645323760807514)),
    "dense0_fluid.weight": (
        -0.34527473128400743,
        (-0.08204323053359985, -0.9844965934753418, -0.3489277958869934,
         0.1615144908428192),
        (0.3784289062023163, 0.48656991124153137, -0.6664910316467285,
         0.11707697808742523)),
    "dense2.weight": (
        5.645576929222443,
        (0.03663887456059456, -0.025851795449852943, -0.1948397308588028,
         0.002729407511651516),
        (0.05365024134516716, -0.030387837439775467, 0.1490926295518875,
         -0.06657557934522629)),
}


# K9 at the NeRF's shapes: (what, rows, k1, k2, n, relu); x is the NeRF's
# (rows, 252) input: layer 5 reads [x[:, :198] | h] (k 454), dir_encoding
# [feat | x[:, 198:]] (k 310 -> 128, the slice off 16 bytes); rows 131,072
# (a coarse pass of 2,048 rays x 64 samples) and 393,216 (a fine pass of
# 2,048 x 192)
DENSE_SHAPES = (("256 x 256", 131072, 256, 0, 256, True),
                ("256 x 256", 393216, 256, 0, 256, True),
                ("skip k 454", 131072, 198, 256, 256, True),
                ("dir_encoding k 310", 131072, 256, 54, 128, True))


def dense_phase(torch, dev):
    """K9 at DENSE_SHAPES: forward, dX, dW and db against float64, the
    plain f32 version's error beside each. Returns the largest error for
    the kernels line."""
    from neurofluid_torch.ops import dense_layer as dl

    worst = 0.0
    gen = torch.Generator(device=dev).manual_seed(21)
    for what, m, k1, k2, n, relu in DENSE_SHAPES:
        x = torch.rand((m, 252), device=dev, generator=gen)
        h = torch.rand((m, 256), device=dev, generator=gen)
        a1, a2 = ((x[:, :198], h) if k2 == 256 else
                  (h, x[:, 198:]) if k2 == 54 else (h, None))
        k_in = k1 + k2
        w = torch.randn((n, k_in), device=dev, generator=gen) / k_in ** 0.5
        b = torch.randn((n,), device=dev, generator=gen) * 0.1
        planes = dl.prepare([(w, k1)], want_dx=True)[0]
        got = torch.empty((m, n), device=dev)
        dl.dense_chain_cuda([(a1, a2, w, b, planes, relu, got)])
        xc = a1 if a2 is None else torch.cat([a1, a2], 1)
        rows = slice(0, 8192)
        x64, w64 = xc[rows].double(), w.double()
        pre = x64 @ w64.t() + b.double()
        want = pre.clamp_min(0) if relu else pre
        scale = x64.abs() @ w64.abs().t() + b.double().abs()
        err = float(((got[rows].double() - want).abs() / scale).max())
        lib_err = float(((dl.dense_layer_plain(a1[rows], None if a2 is None
                                               else a2[rows], w, b, relu)
                          .double() - want).abs() / scale).max())
        # the backward of the same layer: G, dX of every input, dW, db,
        # against float64 (dX on the rows above, dW and db over all)
        dy = torch.randn((m, n), device=dev, generator=gen)
        needs = (True, a2 is not None, True, True)
        da1, da2, dw, db = dl.dense_layer_bwd_cuda(dy, a1, a2, w, got, planes,
                                                   relu, needs)
        g32 = torch.where(got > 0, dy, 0.0) if relu else dy
        g64 = g32.double()
        bwd_errs = {}
        for name, val, want_, scale_ in (
                ("dx", torch.cat([da1] + ([] if da2 is None else [da2]),
                                 1)[rows], g64[rows] @ w64,
                 g64[rows].abs() @ w64.abs()),
                ("dw", dw, g64.t() @ xc.double(),
                 g64.abs().t() @ xc.double().abs()),
                ("db", db, g64.sum(0), g64.abs().sum(0))):
            bwd_errs[name] = float(((val.double() - want_).abs()
                                    / scale_.clamp_min(1e-30)).max())
        plain_errs = {name: float(((val.double() - want_).abs()
                                   / scale_.clamp_min(1e-30)).max())
                      for name, val, want_, scale_ in (
                          ("dx", g32[rows] @ w, g64[rows] @ w64,
                           g64[rows].abs() @ w64.abs()),
                          ("dw", g32.t() @ xc, g64.t() @ xc.double(),
                           g64.abs().t() @ xc.double().abs()))}
        print(f"K9 dense layer {what}, ({m} x {k_in}) x ({k_in} x {n})"
              f"{', ReLU' if relu else ''}: max err / "
              f"sum|x||W| {err:.3e} (tol {GEMM_TOL:.3e}; plain f32 "
              f"{lib_err:.3e}); backward max err / sum of |.| "
              + ", ".join(f"{k} {v:.3e}" for k, v in bwd_errs.items())
              + " (plain f32 "
              + ", ".join(f"{k} {v:.3e}" for k, v in plain_errs.items())
              + ")", flush=True)
        for name, e in {"forward": err, **bwd_errs}.items():
            if not e <= GEMM_TOL:
                raise AssertionError(f"K9 {what} {name}: error {e:.3e} > "
                                     f"{GEMM_TOL:.3e}")
        worst = max(worst, err, *bwd_errs.values())
        del x, h, a1, a2, xc, got, dy, x64, pre, want, scale
        del da1, da2, dw, db, g32, g64
    return worst


def bench_weights(gen, *modules):
    """The bench point's seeded weights, drawn from `gen` in module order
    as the port drew them before its dense layers took flax's init:
    PyTorch's default U(+-1/sqrt(in)) for each Linear's weight and bias,
    Glorot for the conv kernels. The bench point keeps them, so that every
    phase sees the inputs it saw before: a random transition model of
    flax's dense init moves the fluid far more in the 10 rollout steps
    (one such draw took it below the grid's floor and overflowed the
    render's cell table)."""
    import torch

    from neurofluid_torch.models.init import uniform_
    from neurofluid_torch.models.particle_net import ContinuousConvLayer

    for module in modules:
        for m in module.modules():
            if isinstance(m, torch.nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                uniform_(m.weight, bound, gen)
                uniform_(m.bias, bound, gen)
            elif isinstance(m, ContinuousConvLayer):
                m.reset_parameters(gen)


def sass_sections(lib):
    """{function name: its SASS} of the built library (`cuobjdump -sass`)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {section.split(None, 1)[0]: section
            for section in sass.split("Function : ")[1:]}


def sass_tensor_ops(sections, kernel="split_gemm_kernel"):
    """{function name: (HGMMA count, HMMA count, bf16 HGMMA count, bf16
    HMMA count)} of each instantiation of `kernel` (not its `_b` preps) in
    `sass_sections`: `wgmma` shows as HGMMA, `mma.sync` as HMMA, each with
    `.BF16` on bf16 operands (the product's bf16 mode ends its template
    arguments in `ELb1EE`)."""
    found = {}
    for name, section in sections.items():
        if kernel in name and kernel + "_b" not in name:
            lines = section.splitlines()
            found[name] = (section.count("HGMMA"), section.count("HMMA"),
                           sum("BF16" in ln for ln in lines if "HGMMA" in ln),
                           sum("BF16" in ln for ln in lines
                               if "HMMA" in ln and "HGMMA" not in ln))
    return found


# the f32 code of K1 and K2: the walks' instantiations and the 3xTF32
# product's, keyed by their template arguments (a walk of the parent tree
# may carry a trailing BF16 = false); and the anonymous namespace's
# per-file token, which any edit of the source moves
F32_SASS = re.compile(r"(walk_fwd_kernel|walk_bwd_kernel)ILi(\d+)ELb([01])E"
                      r"(?:Lb0E)?E|split_gemm_kernelILi(\d+)ELb([01])ELb0EE")
ANON_NS = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_fused_cconv_cu_[0-9a-f]+")
# the target address of a branch or call, which moves with the order of
# the slow-path subroutines (sqrt, division) that the compiler appends to
# each function
JUMP_TARGET = re.compile(r"^((?:@!?U?P\w+\s+)?(?:BRA|BSSY|CALL|JMP|BRX|JMX)"
                         r"[\w.]*\s+(?:[!\w.]+,\s*)*)0x[0-9a-f]+")


def f32_sass_digests(sections, targets=True):
    """{'walk_fwd_kernel<8,0>' ...: sha256 of its SASS} of the f32 walks
    and the 3xTF32 product: instructions only (comments, addresses and
    encodings dropped, the namespace token fixed), so a function whose
    code is unchanged hashes the same in another build of the file; with
    targets False, branch and call targets masked as well."""
    import hashlib

    out = {}
    for name, section in sections.items():
        m = F32_SASS.search(name)
        if m is None:
            continue
        key = (f"{m.group(1)}<{m.group(2)},{m.group(3)}>" if m.group(1)
               else f"split_gemm_kernel<{m.group(4)},{m.group(5)},0>")
        body = []
        for ln in section.splitlines()[1:]:
            ln = re.sub(r"/\*.*?\*/", "", ANON_NS.sub("NS", ln)).strip()
            if not targets:
                ln = JUMP_TARGET.sub(r"\1T", ln)
            if ln and not ln.startswith("."):
                body.append(ln)
        out[key] = hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]
    return out


class Recorder:
    """Swap a module's CUDA wrapper for one that records its arguments,
    or for the plain version, and put the original back."""

    def __init__(self, swaps):
        self.swaps = swaps  # (module, attribute, replacement)
        self.saved = []

    def __enter__(self):
        for mod, attr, repl in self.swaps:
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, repl)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)


class Counted:
    """Wraps a trainer's callable (its train step, full-image render or
    rollout): its calls counted, and the kernel launches of its first call.
    `first(args, out)`, when given, sees the first call."""

    def __init__(self, fn, counts, first=None):
        self.fn, self.counts, self.first = fn, counts, first
        self.calls, self.launches, self.losses = 0, None, []

    def __call__(self, *args):
        before = self.counts()
        out = self.fn(*args)
        self.calls += 1
        if self.launches is None:
            self.launches = {k: v - before[k] for k, v in self.counts().items()
                             if v - before[k]}
            if self.first is not None:
                self.first(args, out)
        return out


def write_trainer_scene(tmp, scene_kw=TRAINER_SCENE):
    """A synthetic Blender-layout scene under <tmp>/scene (the training
    views view_1-4, the test view view_5) and <tmp>/dataset.yaml, a dataset
    block `smoke` over it for --dataset_config. Returns (scene, yaml)."""
    import yaml

    from neurofluid_torch.data import synthetic

    root = os.path.join(tmp, "scene")
    synthetic.generate_blender_scene(root, **scene_kw)
    views = [f"view_{i}" for i in range(1, 5)]
    block = dict(data_type="splishsplash", near=9.0, far=13.0,
                 gravity=[0.0, 0.0, -9.81],
                 train=dict(start_index=0, end_index=scene_kw["n_frames"],
                            path=root, views=dict(warmup=views,
                                                  dynamic=views[:1])),
                 test=dict(start_index=0, end_index=TRAINER_TEST_END,
                           path=root, views=["view_5"]))
    ds_yaml = os.path.join(tmp, "dataset.yaml")
    with open(ds_yaml, "w") as f:
        yaml.safe_dump({"smoke": block}, f)
    return root, ds_yaml


def trainer_config(tmp, ds_yaml, stage, name, over, resume=""):
    """The config the port's `cli` entry points build for `stage` over the
    `smoke` dataset block (experiments under <tmp>/exps), with `over`
    merged in and every key validated again."""
    from neurofluid_torch.utils.config import (
        ConfigNode, stage_config, validate_keys,
    )

    argv = ["--expdir", os.path.join(tmp, "exps"), "--expname", name,
            "--dataset", "smoke", "--dataset_config", ds_yaml]
    if resume:
        argv += ["--resume_from", resume]
    cfg = ConfigNode(stage_config(stage, argv).to_dict()).merge(over)
    validate_keys(cfg, stage)
    return cfg


def trainers_phase(torch, build_dir, counts, on_plain,
                   scene_kw=TRAINER_SCENE):
    """The port's stage trainers and evaluators through the classes the
    `neurofluid_torch.cli` entry points build, on the card, with configs
    from the shipped configs/*.yaml (counts and intervals set, widths as
    shipped) over a synthetic scene written into a temporary directory:
    the warm-up (WARMUP_STEPS steps over the four views, a full-image eval,
    a checkpoint), the transition trainer (one epoch, its eval rollout, a
    checkpoint), the e2e trainer warm-started from both (one epoch, an eval,
    a checkpoint; its first step held against the same step with every
    kernel on its plain version, to STEP_TOL), a second e2e trainer resumed
    from that checkpoint taking one step, then E2EEvaluator,
    TransitionEvaluator and RendererEvaluator. Prints per stage the steps
    taken, the first and last loss, the peak memory, the launches per step
    and per stage, PSNR and Pred2GT, and the checkpoints written and read
    back. Returns the phase's launches."""
    from neurofluid_torch.train import checkpoint as ckpt
    from neurofluid_torch.train.e2e import E2ETrainer
    from neurofluid_torch.train.evaluation import (
        E2EEvaluator, RendererEvaluator, TransitionEvaluator,
    )
    from neurofluid_torch.train.transition import TransitionTrainer
    from neurofluid_torch.train.warmup import WarmupTrainer

    phase_before = counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainers_", dir=build_dir)
    try:
        root, ds_yaml = write_trainer_scene(tmp, scene_kw)
        print(f"trainers phase: scene of {scene_kw['n_side'] ** 3} fluid "
              f"particles, {scene_kw['n_frames']} frames, 5 views at "
              f"{scene_kw['img_wh']} written", flush=True)

        def config(stage, name, over, resume=""):
            return trainer_config(tmp, ds_yaml, stage, name, over, resume)

        def check_launches(stage, launched):
            want = TRAINER_KERNELS[stage]
            bad = {k: v for k, v in launched.items()
                   if (v > 0) != (k in want)}
            if bad:
                raise AssertionError(f"trainers phase, {stage}: launches "
                                     f"{launched}; expected only {want}")

        def finite(what, *values):
            for v in values:
                if v is None or not math.isfinite(float(v)):
                    raise AssertionError(f"trainers phase: {what} is {v}")

        def read_back(tr, module_keys):
            """The trainer's checkpoints on disk; the latest read back, its
            state_dicts holding the models' keys."""
            files = sorted(os.listdir(tr.modelpath))
            if not files:
                raise AssertionError(f"no checkpoint in {tr.modelpath}")
            state, step = ckpt.restore_checkpoint(tr.modelpath)
            for key, module in module_keys.items():
                if set(state[key]) != set(module.state_dict()):
                    raise AssertionError(f"checkpoint {step}: {key} keys "
                                         f"differ from the model's")
            return f"{files} (read back step {step}: {sorted(state)})"

        def run_stage(stage, fn):
            torch.cuda.reset_peak_memory_stats()
            before = counts()
            out = fn()
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in counts().items()}
            check_launches(stage, launched)
            return out, (f"launches {({k: v for k, v in launched.items() if v})}"
                         f", peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
                         f" GB")

        def step_line(what, counted):
            return (f"{what}: {counted.calls} steps; launches per step "
                    f"{counted.launches}; loss first {counted.losses[0]:.6f} "
                    f"last {counted.losses[-1]:.6f}")

        def instrument(tr, step_first=None):
            """Counted train step (its loss kept), render and rollout."""
            step = Counted(tr.train_step, counts, step_first)

            def step_with_loss(*args):
                out = step(*args)
                step.losses.append(float(out[0]))
                return out

            tr.train_step = step_with_loss
            counted = {"step": step}
            for name in ("render_full", "rollout"):
                if hasattr(tr, name):
                    counted[name] = Counted(getattr(tr, name), counts)
                    setattr(tr, name, counted[name])
            return counted

        # -- warm-up
        w_cfg = config("warmup", "warmup", {"TRAIN": dict(
            N_iters=WARMUP_STEPS, save_interval=WARMUP_STEPS, log_interval=1)})
        evals = []

        def warmup():
            tr = WarmupTrainer(w_cfg)
            counted = instrument(tr)
            eval_ = tr.eval
            tr.eval = lambda step: evals.append(eval_(step))
            tr.train()
            return tr, counted

        (w_tr, w_t), line = run_stage("warm-up", warmup)
        psnr = evals[0]["view_5"]
        finite("warm-up loss", *w_t["step"].losses)
        finite("warm-up PSNR", psnr["psnr_0"], psnr["psnr_1"])
        print("trainers phase, warm-up: " + step_line(
            f"{len(w_tr.train_views)} views x {w_cfg.RENDERER.ray.ray_chunk} "
            "rays", w_t["step"]) + f"; full-frame eval of "
            f"{w_t['render_full'].calls} {w_cfg.TEST.imgW} x "
            f"{w_cfg.TEST.imgH} frame(s) "
            f"(chunks of {w_tr.eval_chunk_size()}), PSNR coarse "
            f"{psnr['psnr_0']:.3f} fine {psnr['psnr_1']:.3f}; {line}; "
            f"checkpoints {read_back(w_tr, {'renderer': w_tr.model})}",
            flush=True)

        # -- transition
        t_cfg = config("transmodel", "trans", {
            "TRAIN": dict(N_iters=1, save_interval=1, log_interval=1,
                          datapath=dict(train=root, eval=root)),
            "TEST": dict(datapath=root, end_index=TRAINER_TEST_END)})
        t_evals = []

        def transition():
            tr = TransitionTrainer(t_cfg)
            counted = instrument(tr)
            eval_ = tr.eval
            tr.eval = lambda step: t_evals.append(eval_(step))
            tr.train()
            return tr, counted

        (t_tr, t_t), line = run_stage("transition", transition)
        finite("transition loss", *t_t["step"].losses)
        finite("transition Pred2GT", *t_evals)
        print("trainers phase, transition (search "
              f"{t_tr.net.search_backend}): " + step_line(
                  "one epoch", t_t["step"])
              + f"; eval rollout {t_t['rollout'].calls} x "
              f"{t_tr.test_dataset.sequence_lengths[0]} steps, avg Pred2GT "
              f"{t_evals[0]:.4f} mm; {line}; checkpoints "
              f"{read_back(t_tr, {'transition': t_tr.net})}", flush=True)

        # -- e2e, warm-started from both; its first step again with every
        # kernel on its plain version, from the same weights and inputs
        e_over = {"TRAIN": dict(
            epochs=1, save_interval=E2E_STEPS, log_interval=1,
            pretrained_renderer=w_tr.modelpath,
            pretrained_transition_model=t_tr.modelpath)}
        e_cfg = config("end2end", "e2e", e_over)
        first = {}

        def keep_first(args, out):
            first.update(args=args, loss=float(out[0]), next_pos=out[1],
                         aux=out[3], grads={
                             name: {n: p.grad.detach().clone()
                                    for n, p in model.named_parameters()}
                             for name, model in (("renderer", e_tr.renderer),
                                                 ("transition",
                                                  e_tr.transition))})

        e_evals = []
        e_tr = E2ETrainer(e_cfg)
        e_t = instrument(e_tr, keep_first)
        eval_ = e_tr.eval
        e_tr.eval = lambda step: e_evals.append(eval_(step))
        plain_tr = E2ETrainer(config("end2end", "e2e_plain", e_over))
        _, line = run_stage("e2e", e_tr.train)
        avg, psnrs = e_evals[0]
        finite("e2e loss", *e_t["step"].losses)
        finite("e2e Pred2GT, PSNR", avg, *[p for pair in psnrs.values()
                                           for p in pair])
        print("trainers phase, e2e (search "
              f"{e_tr.transition.search_backend}, warm-started): "
              + step_line(f"one epoch, {len(e_tr.train_views)} view x "
                          f"{e_cfg.RENDERER.ray.ray_chunk} rays", e_t["step"])
              + f"; eval avg Pred2GT {avg:.4f} mm, full frames "
              f"{e_t['render_full'].calls}, PSNR "
              + ", ".join(f"{k} {p0:.3f} / {p1:.3f}"
                          for k, (p0, p1) in psnrs.items())
              + f"; {line}; checkpoints "
              + read_back(e_tr, {"renderer": e_tr.renderer,
                                 "transition": e_tr.transition}), flush=True)

        before = counts()
        with on_plain(tuple(TOL)):
            loss_p, pos_p, _, aux_p = plain_tr.train_step(*first["args"])
            torch.cuda.synchronize()
        if counts() != before:
            raise AssertionError("the plain e2e trainer step launched a "
                                 "kernel")
        def rel(a, ref):
            return abs(float(a) - float(ref)) / max(abs(float(ref)), 1e-30)

        d = {"loss": rel(loss_p, first["loss"]),
             "next_pos": float((pos_p - first["next_pos"]).abs().max())}
        for key in ("grad_norm_renderer", "grad_norm_transition"):
            d[key] = rel(aux_p[key], first["aux"][key])
        worst = {}
        for name, model in (("renderer", plain_tr.renderer),
                            ("transition", plain_tr.transition)):
            ref = first["grads"][name]
            top = max(max(float(g.abs().max()) for g in ref.values()), 1e-30)
            errs = {n: float((p.grad - ref[n]).abs().max())
                    for n, p in model.named_parameters()}
            d["grads_" + name] = max(errs.values()) / top
            rel = {n: e / max(float(ref[n].abs().max()), 1e-30)
                   for n, e in errs.items()}
            worst[name] = max(rel, key=rel.get)
            d["leaf_" + name] = rel[worst[name]]
        print("trainers phase, e2e first step with every kernel on its plain "
              "version, from the same weights and inputs: diffs "
              + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
              + f" (loss, grad norms relative; grads_* relative to the "
              f"model's largest entry, leaf_* to the leaf's own; next_pos "
              f"absolute); worst leaves {worst}; STEP_TOL {STEP_TOL}",
              flush=True)
        bad = {k: v for k, v in d.items() if k in STEP_TOL
               and not v <= STEP_TOL[k]}
        if bad:
            raise AssertionError(f"e2e trainer step with plain kernels "
                                 f"disagrees beyond STEP_TOL: {bad}")
        del plain_tr, first

        # a second e2e trainer resumed from that checkpoint: one step (a
        # one-frame epoch), weights restored, optimizers fresh
        r_cfg = config("end2end", "e2e_resumed", {
            "TRAIN": dict(epochs=1, save_interval=1000, log_interval=1),
            "train": dict(end_index=2)}, resume=e_tr.modelpath)

        def resumed():
            tr = E2ETrainer(r_cfg)
            counted = instrument(tr)
            tr.train()
            return tr, counted

        (r_tr, r_t), line = run_stage("e2e", resumed)
        saved = ckpt.latest_step(e_tr.modelpath)
        if r_tr.start_step != saved + 1 or r_t["step"].calls != 1:
            raise AssertionError(f"resumed e2e trainer: start step "
                                 f"{r_tr.start_step} from checkpoint {saved}, "
                                 f"{r_t['step'].calls} steps")
        finite("resumed e2e loss", *r_t["step"].losses)
        print(f"trainers phase, e2e resumed from checkpoint {saved}: start "
              f"step {r_tr.start_step}, one step, loss "
              f"{r_t['step'].losses[0]:.6f}; {line}", flush=True)
        e_models = e_tr.modelpath
        del e_tr, r_tr

        # -- the evaluators on those checkpoints
        def evaluators():
            out = {}
            ev = E2EEvaluator(config("end2end", "eval_e2e", {},
                                     resume=e_models))
            ev.render_full = Counted(ev.render_full, counts)
            out["e2e"] = ev.eval(), ev.render_full
            tev = TransitionEvaluator(config(
                "transmodel", "eval_transmodel",
                {"TEST": dict(datapath=root, end_index=TRAINER_TEST_END)},
                resume=e_models))
            out["transition"] = tev.eval(), len(tev.dataset)
            rev = RendererEvaluator(config("warmup", "eval_renderer", {},
                                           resume=w_tr.modelpath))
            rev.render_full = Counted(rev.render_full, counts)
            outdir = rev.eval(max_frames=RENDERER_EVAL_FRAMES)
            out["renderer"] = sorted(os.listdir(outdir)), rev.render_full
            return out

        out, line = run_stage("evaluators", evaluators)
        (dists, psnrs), render = out["e2e"]
        finite("E2EEvaluator Pred2GT, PSNR", *dists, *psnrs)
        (t_dists, t_clipped), n_windows = out["transition"]
        finite("TransitionEvaluator Pred2GT", *t_dists, *t_clipped)
        files, r_render = out["renderer"]
        if len(files) != 2 * RENDERER_EVAL_FRAMES:
            raise AssertionError(f"RendererEvaluator wrote {files}")
        print(f"trainers phase, evaluators: E2EEvaluator rollout "
              f"{len(dists)} steps, {render.calls} frames, "
              f"Pred2GT " + ", ".join(f"{x:.4f}" for x in dists)
              + " mm, fine PSNR " + ", ".join(f"{x:.3f}" for x in psnrs)
              + f"; TransitionEvaluator rollout {n_windows} steps, Pred2GT "
              f"mean {statistics.mean(t_dists):.4f} mm (clipped "
              f"{statistics.mean(t_clipped):.4f}); RendererEvaluator "
              f"{r_render.calls} frames, {files}; {line}", flush=True)
    finally:
        shutil.rmtree(tmp)
    launched = {k: v - phase_before[k] for k, v in counts().items()}
    print(f"trainers phase: launches {launched}", flush=True)
    return launched


def write_lpips_weights(path, seed=0):
    """Random VGG16 and LPIPS head weights in the documented `.npz` format
    (He-scaled convs, so activations keep their scale through 13 layers;
    non-negative heads, as trained ones are)."""
    import numpy as np

    from neurofluid_torch.utils import lpips

    rng = np.random.default_rng(seed)
    arrays, cin, i = {}, 3, 0
    for item in lpips._VGG16_CFG:
        if item == "M":
            continue
        arrays[f"vgg_conv{i}_weight"] = (rng.normal(size=(item, cin, 3, 3))
                                         * math.sqrt(2.0 / (9 * cin))
                                         ).astype(np.float32)
        arrays[f"vgg_conv{i}_bias"] = (rng.normal(size=(item,)) * 0.01
                                       ).astype(np.float32)
        cin, i = item, i + 1
    for k, c in enumerate(lpips._TAP_CHANNELS):
        arrays[f"lin{k}_weight"] = rng.uniform(0, 0.1, c).astype(np.float32)
    np.savez(path, **arrays)
    return path


def options_phase(torch, dev, problem, init_state, reset_counts, counts,
                  on_plain, build_dir, dense_ref):
    """Phase 13: the renderer's options and its list path at the bench
    point (14,336 particles, 1,024 rays, 64 + 128 samples, NeRF 8 x 256),
    each counted run's launches held to OPTION_LAUNCHES.

    problem: the bench point's (pos, vel, box, nrm, ro_v, rays_v, rgbs_v)
    and `end`, the kernel rollout's last frame; init_state: the seeded
    (ParticleNet, RenderNet) weights; dense_ref: phase 4's dense render of
    `end` (its num_nn_0, mask_0, num_nn_1, mask_1, rgb0, rgb1).
    (a) the list render on 'auto' (the grid) with 'approx': finite, no
        overflow, num_nn_* and mask_* equal to the dense render's, the
        exact counts of its fine searches equal to K3's on the same
        samples, against itself with K5 plain;
    (b) the particle gradient of that render (finite, non-zero) and an e2e
        train step with it: launches, losses, grad norms, and the first
        step again with K8 plain (loss bitwise, each gradient leaf within
        1e-4 of its largest entry);
    (c) the warm-up step of `build_renderer` with RENDERER.bf16 true and
        false, from the same weights: the renders within BF16_TOL, the
        steps' peak memory;
    (d) coarse_rendering, fine_rendering, a seeded perturb=1, noise_std=1
        render twice from one seed (bitwise equal), exclude_ray=False;
    (e) the chamfer distance of `end` against the start within CHAMFER_TOL
        of scipy's cKDTree, and LPIPS of two 400 x 400 images on random
        weights written under build/ (finite, repeatable).
    Returns the phase's launches and the arguments of the K8 calls of the
    list render's gradient pass."""
    import numpy as np
    from scipy.spatial import cKDTree

    from neurofluid_torch import scene
    from neurofluid_torch.models import ParticleNet, RenderNet
    from neurofluid_torch.ops import ball_features as bf
    from neurofluid_torch.ops import chamfer
    from neurofluid_torch.ops import neighbor_search as ns
    from neurofluid_torch.ops import segment_ops as so
    from neurofluid_torch.train import losses
    from neurofluid_torch.train.e2e import make_e2e_train_step
    from neurofluid_torch.train.warmup import (
        build_renderer, make_warmup_train_step,
    )
    from neurofluid_torch.utils import lpips
    from neurofluid_torch.utils.config import ConfigNode, load_config

    pos, vel, box, nrm, ro_v, rays_v, rgbs_v, end = problem
    ro, rays = ro_v[0], rays_v[0]
    phase = {k: 0 for k in counts()}

    def run(what, fn):
        """fn()'s result, every count set to 0 just before and read just
        after."""
        reset_counts()
        out = fn()
        launched = counts()
        want = {k: OPTION_LAUNCHES[what].get(k, 0) for k in launched}
        if launched != want:
            raise AssertionError(f"options phase, {what}: launches "
                                 f"{launched} != {want}")
        for k, v in launched.items():
            phase[k] += v
        return out

    def finite(what, out):
        for key, v in out.items():
            if not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"options phase, {what}: non-finite "
                                     f"{key}")

    def renderer(**kw):
        r = RenderNet(device=dev, generator=torch.Generator().manual_seed(0),
                      **kw)
        r.load_state_dict(init_state[1])
        return r

    # ---- (a) the list render
    lst = renderer(search_mode="list")
    fine = []
    grid_search = ns.radius_search_grid

    def spy(q, *a, **kw):  # the fine pass's searches (no cull)
        res = grid_search(q, *a, **kw)
        fine.append((q.detach(), res[0].count))
        return res

    with torch.no_grad():
        with Recorder([(ns, "radius_search_grid", spy)]):
            out_l = run("list render", lambda: lst(end, ro, rays))
        finite("list render", out_l)
        if bool(out_l["overflow"]):
            raise AssertionError("options phase: the list render's search "
                                 "overflows")
        # the exact counts; the fine samples follow each render's coarse
        # weights, which differ by design, but not here enough to move a
        # count (and the fine counts are held to K3's at the same samples)
        for key in ("num_nn_0", "mask_0", "num_nn_1", "mask_1"):
            if not torch.equal(out_l[key], dense_ref[key]):
                raise AssertionError(f"options phase: list {key} != the "
                                     f"dense render's")
        if len(fine) != 1:
            raise AssertionError(f"{len(fine)} fine searches recorded")
        q_f, count_f = fine[0]
        sums, _ = bf.ball_feature_sums(q_f, end, lst.search_radius,
                                       lst.num_neighbors, lst.grid_lower,
                                       lst.grid_upper, lst.grid_max_per_cell,
                                       capacity_frac=1.0)
        count_mism = int((sums[:, 0].to(torch.int32) != count_f).sum())
        if count_mism:
            raise AssertionError(f"options phase: {count_mism} fine "
                                 f"samples' counts differ from K3's")
        d_ren = renderer()
        run("dense render", lambda: d_ren(end, ro, rays))
        with on_plain(("K5",)):
            out_p = run("list render, K5 plain", lambda: lst(end, ro, rays))
    diffs = {}
    for key in ("rgb0", "depth0", "opacity0", "rgb1", "depth1", "opacity1"):
        d = (out_p[key] - out_l[key]).abs()
        diffs[key], diffs[key + "_mean"] = float(d.max()), float(d.mean())
    bad = {k: diffs[k] for k, lim in LIST_PLAIN_LIMITS.items()
           if not diffs[k] <= lim}
    print(f"options phase (a), list render on 'auto' (grid) with 'approx', "
          f"{rays.shape[0]} rays, 64 + 128 samples: num_nn_0, mask_0, "
          f"num_nn_1 and mask_1 equal to phase 4's dense render; the fine "
          f"pass's "
          f"{q_f.shape[0]} exact counts equal to K3's; samples with K "
          f"neighbours coarse {int(out_l['mask_0'].sum())} fine "
          f"{int(out_l['mask_1'].sum())}; rgb1 against the "
          f"dense render max {float((out_l['rgb1'] - dense_ref['rgb1']).abs().max()):.3e} "
          f"(other neighbours by design); K5 plain: max abs diffs "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()), flush=True)
    if bad:
        raise AssertionError(f"list render with K5 plain disagrees: {bad}")

    # ---- (b) its particle gradient, and an e2e train step with it
    p_g = end.detach().clone().requires_grad_(True)

    def grad_pass():
        out = lst(p_g, ro, rays)
        (out["rgb0"].sum() + out["rgb1"].sum()).backward()

    k8_calls = []
    k8_cuda = so.segment_sum_cuda

    def k8_record(vals, plan):
        k8_calls.append((vals, plan))
        return k8_cuda(vals, plan)

    with Recorder([(so, "segment_sum_cuda", k8_record)]):
        run("list render gradient", grad_pass)
    g = p_g.grad
    if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0):
        raise AssertionError("options phase: the list render's particle "
                             "gradient is not finite and non-zero")
    bounds = losses.default_box_bounds(device=dev)

    def list_trainer():
        t_net = ParticleNet(**scene.particle_net_kwargs(), device=dev,
                            generator=torch.Generator().manual_seed(1))
        t_ren = renderer(search_mode="list")
        t_net.load_state_dict(init_state[0])
        opt_r = torch.optim.Adam(t_ren.parameters(), lr=LR_RENDERER)
        opt_t = torch.optim.Adam(t_net.parameters(), lr=LR_TRANSITION)
        return t_net, t_ren, make_e2e_train_step(t_net, t_ren, opt_r, opt_t,
                                                 bounds, BD_WEIGHT)

    def grads_of(*models):
        return {f"{i}.{n}": prm.grad.detach().clone()
                for i, m in enumerate(models)
                for n, prm in m.named_parameters()}

    l_net, l_ren, l_step = list_trainer()
    box_plan = l_net.make_box_plan(box)

    def step_from(step, p, v):
        return step(p, v, box, nrm, ro_v, rays_v, rgbs_v, box_plan=box_plan)

    loss, p, v, aux = run("list e2e step",
                          lambda: step_from(l_step, pos, vel))
    ref = dict(loss=float(loss), grads=grads_of(l_net, l_ren))
    step_losses = [float(loss)]
    for _ in range(OPTION_STEPS):
        loss, p, v, aux = run("list e2e step",
                              lambda: step_from(l_step, p, v))
        step_losses.append(float(loss))
        gn_r = float(aux["grad_norm_renderer"])
        gn_t = float(aux["grad_norm_transition"])
        if not (all(map(math.isfinite, (float(loss), gn_r, gn_t)))
                and gn_t > 0.0):
            raise AssertionError(f"options phase, list e2e step: loss "
                                 f"{float(loss)}, grad norms {gn_r}, {gn_t}")
        if bool(aux["search_overflow"]) or bool(aux["search_cap_exceeded"]):
            raise AssertionError("options phase, list e2e step: a search "
                                 "overflow flag is set")
    c_net, c_ren, c_step = list_trainer()
    with on_plain(("K8",)):
        loss_c, _, _, _ = run("list e2e step, K8 plain",
                              lambda: step_from(c_step, pos, vel))
    got = grads_of(c_net, c_ren)
    rel = {n: float((got[n] - w).abs().max())
           / max(float(w.abs().max()), 1e-30) for n, w in ref["grads"].items()}
    worst = max(rel, key=rel.get)
    print(f"options phase (b), list render particle gradient: max |g| "
          f"{float(g.abs().max()):.4e} (K5 K6 K8 2 each); list e2e train "
          f"step: {1 + OPTION_STEPS} steps, losses "
          + ", ".join(f"{x:.6f}" for x in step_losses)
          + f", grad norms renderer {gn_r:.4e} transition {gn_t:.4e}; with "
          f"K8 plain: loss diff "
          f"{abs(float(loss_c) - ref['loss']):.3e}, worst leaf {worst} "
          f"{rel[worst]:.3e} of its largest entry", flush=True)
    if float(loss_c) != ref["loss"] or not rel[worst] <= 1e-4:
        raise AssertionError(f"list e2e step with K8 plain disagrees: loss "
                             f"{float(loss_c)} vs {ref['loss']}, {worst} "
                             f"{rel[worst]:.3e}")
    del l_net, l_ren, l_step, c_net, c_ren, c_step, got, ref, g

    # ---- (c) the warm-up step of build_renderer with bf16 products
    cfg = load_config("warmup").merge({"near": 9.0, "far": 13.0})
    warm = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        c = ConfigNode(cfg.to_dict())
        c.RENDERER.bf16 = bf16
        r = build_renderer(c, dev, torch.Generator().manual_seed(0))
        r.load_state_dict(init_state[1])
        with torch.no_grad():
            out = run("dense render", lambda: r(end, ro, rays))
        finite(f"{name} render", out)
        opt = torch.optim.Adam(r.parameters(),
                               lr=float(c.TRAIN.LR.lr))
        warm[name] = dict(out=out, step=make_warmup_train_step(r, opt),
                          peak=0, losses=[])
    diffs = {key: float((warm["bf16"]["out"][key]
                         - warm["f32"]["out"][key]).abs().max())
             for key in ("rgb0", "opacity0", "depth0", "rgb1", "opacity1",
                         "depth1")}
    for i in range(OPTION_STEPS + 1):  # f32, bf16, bf16, f32, ...
        for name in (("f32", "bf16") if i % 2 == 0 else ("bf16", "f32")):
            w = warm[name]
            torch.cuda.reset_peak_memory_stats()
            loss, (_, _, overflow) = run(
                "warm-up step",
                lambda: w["step"](end, ro_v, rays_v, rgbs_v))
            w["peak"] = max(w["peak"], torch.cuda.max_memory_allocated())
            if not math.isfinite(float(loss)) or bool(overflow):
                raise AssertionError(f"options phase, {name} warm-up step: "
                                     f"loss {float(loss)}, overflow "
                                     f"{bool(overflow)}")
            w["losses"].append(float(loss))
    print("options phase (c), the warm-up step of build_renderer, "
          "RENDERER.bf16 true against false, from the same weights: "
          + "; ".join(f"{n} peak {w['peak'] / 2 ** 30:.3f} GiB, losses "
                      + ", ".join(f"{x:.6f}" for x in w["losses"])
                      for n, w in warm.items())
          + "; render bf16 vs f32 max abs diffs "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()), flush=True)
    bad = {k: v for k, v in diffs.items()
           if not v <= BF16_TOL[k.rstrip("01")]}
    if bad or not max(diffs.values()) > 0.0:
        raise AssertionError(f"bf16 render against f32: {diffs} (tolerance "
                             f"{BF16_TOL}; bf16 must differ from f32)")
    del warm

    # ---- (d) the dense renderer's other passes and options
    with torch.no_grad():
        outs = {}
        for what, fn in (
                ("coarse_rendering",
                 lambda: d_ren.coarse_rendering(end, ro, rays)),
                ("fine_rendering",
                 lambda: d_ren.fine_rendering(end, ro, rays))):
            outs[what] = run(what, fn)
            finite(what, outs[what])
        coarse_diff = float((outs["coarse_rendering"]["rgb0"]
                             - dense_ref["rgb0"]).abs().max())
        if not (torch.equal(outs["coarse_rendering"]["num_nn_0"],
                            dense_ref["num_nn_0"]) and coarse_diff <= 1e-6):
            raise AssertionError(f"coarse_rendering differs from the full "
                                 f"render's coarse pass: rgb0 "
                                 f"{coarse_diff:.3e}")

        def seeded():
            gen = torch.Generator(device=dev).manual_seed(7)
            return d_ren(end, ro, rays, generator=gen, perturb=1.0,
                         noise_std=1.0)

        a = run("random render", seeded)
        b = run("random render", seeded)
        finite("random render", a)
        same = all(torch.equal(a[k], b[k]) for k in a)
        if not same or torch.equal(a["rgb1"], dense_ref["rgb1"]):
            raise AssertionError("the seeded random render does not repeat "
                                 "bitwise, or equals the deterministic one")
        x_ren = renderer(exclude_ray=False)
        out_x = run("exclude_ray=False render", lambda: x_ren(end, ro, rays))
        finite("exclude_ray=False render", out_x)
    print(f"options phase (d): coarse_rendering (num_nn_0 equal to the "
          f"full render's, rgb0 within {coarse_diff:.3e}), fine_rendering "
          f"(opacity1 mean "
          f"{float(outs['fine_rendering']['opacity1'].mean()):.4f}), seeded "
          f"perturb=1 noise_std=1 render bitwise equal from one seed (rgb1 "
          f"against the deterministic render max "
          f"{float((a['rgb1'] - dense_ref['rgb1']).abs().max()):.3e}), "
          f"exclude_ray=False (rgb1 against exclude_ray=True "
          f"max {float((out_x['rgb1'] - dense_ref['rgb1']).abs().max()):.3e}"
          f")", flush=True)
    del outs, a, b, out_x, d_ren, x_ren, lst

    # ---- (e) chamfer and LPIPS
    cd = float(chamfer.chamfer_distance(end, pos))
    e64, p64 = end.double().cpu().numpy(), pos.double().cpu().numpy()
    want = float(np.mean(cKDTree(p64).query(e64)[0] ** 2)
                 + np.mean(cKDTree(e64).query(p64)[0] ** 2))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lpips_", dir=build_dir)
    try:
        path = write_lpips_weights(os.path.join(tmp, "lpips_vgg.npz"))
        rng = np.random.default_rng(11)
        img_a = rng.uniform(size=LPIPS_WH + (3,)).astype(np.float32)
        img_b = np.clip(img_a + rng.normal(size=img_a.shape) * 0.1, 0, 1
                        ).astype(np.float32)
        ev = lpips.LPIPSEvaluator(path, device=dev)
        d1 = ev(img_a, img_b)
        d2 = ev(img_a, img_b)
    finally:
        shutil.rmtree(tmp)
    print(f"options phase (e): chamfer of the rollout's end state against "
          f"its start ({end.shape[0]} x {pos.shape[0]}) {cd:.9e}, cKDTree "
          f"float64 {want:.9e}, diff {abs(cd - want):.3e} (tol "
          f"{CHAMFER_TOL:.0e}); LPIPS of two {LPIPS_WH[0]} x {LPIPS_WH[1]} "
          f"images, random weights: {d1:.6e} then {d2:.6e}", flush=True)
    if not abs(cd - want) <= CHAMFER_TOL:
        raise AssertionError(f"chamfer {cd} vs cKDTree {want}")
    if not (math.isfinite(d1) and d1 > 0 and d1 == d2):
        raise AssertionError(f"LPIPS {d1}, {d2}: not finite and repeatable")
    print(f"options phase: launches {phase}", flush=True)
    return phase, k8_calls


def parallel_phase(torch, problem, init_state, reset_counts, counts,
                   build_dir):
    """Phase 14: the sharded paths of `neurofluid_torch.parallel` in a world
    of one over NCCL (a FileStore in a temporary directory under build/,
    rank 0 of 1, destroyed at the end): every collective is a real NCCL
    call that moves nothing between ranks. The multi-rank math is held on
    the CPU over gloo (tests/test_torch_parallel*.py and
    `python -m neurofluid_torch.parallel.dryrun 4`). At the bench point:
    (a) SHARDED_STEPS steps of `make_sharded_e2e_step` (the ray batch over
        a 1-D 'rays' mesh, the fused_cconv transition replicated), state
        carried, each against phase 6's step from the same weights and
        state (loss and next_pos within STEP_TOL), launches per step
        PARALLEL_LAUNCHES["ray-sharded"];
    (b) `make_sharded_particle_step` on 'auto' (the all-gather) and
        `make_halo_particle_step` on 'grid' at the 13,824-particle lattice
        with halo 1,024, each against the unsharded step (neighbour counts
        equal, positions within DRYRUN_TOL), no overflow;
    (c) SHARDED_STEPS steps of `make_spmd_e2e_step` on a 1 x 1
        ('particles', 'rays') mesh on 'auto' with the dense renderer, state
        carried, each against the replicated e2e step on 'auto' (loss,
        gradient norms, next positions within DRYRUN_TOL), launches per
        step PARALLEL_LAUNCHES["spmd"] and K8 at least once; the replicas'
        parameters and Adam states compared bitwise;
    peak memory; then the host tools: the native library built, its
    chamfer distance of the rollout's end state against the start within
    CHAMFER_TOL of ops/chamfer.py's on the card, and `cli.generate_data`
    writing a scene under build/ that `BlenderDataset` loads. Returns the
    phase's launches (the sharded steps'; the references' are
    comparisons)."""
    import numpy as np
    import torch.distributed as dist

    from neurofluid_torch import native, scene
    from neurofluid_torch.cli import generate_data
    from neurofluid_torch.data import BlenderDataset
    from neurofluid_torch.models import ParticleNet, RenderNet
    from neurofluid_torch.ops import chamfer
    from neurofluid_torch.parallel import dryrun
    from neurofluid_torch.parallel.mesh import init_world, make_mesh
    from neurofluid_torch.parallel.sharding import (
        make_halo_particle_step, make_sharded_e2e_step,
        make_sharded_particle_step, make_spmd_e2e_step, particle_rows,
        shard_ray_batch, spmd_ray_sharding,
    )
    from neurofluid_torch.train import losses
    from neurofluid_torch.train.e2e import make_e2e_train_step

    pos, vel, box, nrm, ro_v, rays_v, rgbs_v, end = problem
    phase = {k: 0 for k in counts()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_", dir=build_dir)
    dev = init_world(0, 1, f"file://{os.path.join(tmp, 'store')}", "cuda")
    print(f"parallel phase: world of {dist.get_world_size()} over "
          f"{dist.get_backend()} on {dev} (FileStore under build/)",
          flush=True)
    bounds = losses.default_box_bounds(device=dev)

    def models(backend, shard_group=None):
        """The seeded initial weights on `backend`, and their Adams."""
        net = ParticleNet(**{**scene.particle_net_kwargs(),
                             "search_backend": backend},
                          shard_group=shard_group, device=dev,
                          generator=torch.Generator().manual_seed(1))
        ren = RenderNet(device=dev, generator=torch.Generator().manual_seed(2))
        net.load_state_dict(init_state[0])
        ren.load_state_dict(init_state[1])
        return (net, ren, torch.optim.Adam(ren.parameters(), lr=LR_RENDERER),
                torch.optim.Adam(net.parameters(), lr=LR_TRANSITION))

    def steps(what, step, args, want=None, at_least=(), box_plan=None):
        """SHARDED_STEPS steps, the state carried: per step the loss, next
        state and grad norms; with `want`, each step's launches held to it
        (those named in `at_least` to at least one) and added to the
        phase's."""
        p, v = args[:2]
        out = []
        for i in range(SHARDED_STEPS):
            reset_counts()
            loss, p, v, aux = step(p, v, *args[2:], box_plan=box_plan)
            launched = counts()
            if want is not None:
                bad = {k: n for k, n in launched.items()
                       if (n < 1 if k in at_least else n != want.get(k, 0))}
                if bad:
                    raise AssertionError(f"parallel phase, {what} step {i}: "
                                         f"launches {launched}, want {want}"
                                         f" and {at_least} at least once")
                for k, n in launched.items():
                    phase[k] += n
            if bool(aux["search_overflow"]) or not torch.isfinite(loss):
                raise AssertionError(f"parallel phase, {what} step {i}: "
                                     f"loss {float(loss)}, overflow "
                                     f"{bool(aux['search_overflow'])}")
            out.append(dict(loss=float(loss), pos=p,
                            gn_r=float(aux["grad_norm_renderer"]),
                            gn_t=float(aux["grad_norm_transition"]),
                            launched={k: n for k, n in launched.items() if n}))
        return out

    def compare(what, got, want, tol):
        worst = {"loss": 0.0, "next_pos": 0.0, "grad_norm": 0.0}
        for g, w in zip(got, want):
            worst["loss"] = max(worst["loss"],
                                abs(g["loss"] - w["loss"]) / abs(w["loss"]))
            worst["next_pos"] = max(worst["next_pos"],
                                    float((g["pos"] - w["pos"]).abs().max()))
            for key in ("gn_r", "gn_t"):
                worst["grad_norm"] = max(worst["grad_norm"],
                                         abs(g[key] - w[key]) / w[key])
        bad = {k: v for k, v in worst.items() if k in tol and not v <= tol[k]}
        print(f"parallel phase, {what}: {SHARDED_STEPS} steps, losses "
              + ", ".join(f"{g['loss']:.6f}" for g in got)
              + f" (reference " + ", ".join(f"{w['loss']:.6f}" for w in want)
              + "); worst diffs " + ", ".join(f"{k} {v:.3e}"
                                              for k, v in worst.items())
              + f" (tol {tol}); launches per step {got[0]['launched']}",
              flush=True)
        if bad:
            raise AssertionError(f"parallel phase, {what}: {bad}")

    try:
        # ---- (a) the ray-sharded e2e step, the transition replicated
        mesh_r = make_mesh(axis_names=("rays",))
        e2e_args = (pos, vel, box, nrm, ro_v, shard_ray_batch(rays_v, mesh_r),
                    shard_ray_batch(rgbs_v, mesh_r))
        net, ren, opt_r, opt_t = models("fused_cconv")
        ref = steps("phase 6's step", make_e2e_train_step(
            net, ren, opt_r, opt_t, bounds, BD_WEIGHT), e2e_args,
            box_plan=net.make_box_plan(box))
        net, ren, opt_r, opt_t = models("fused_cconv")
        torch.cuda.reset_peak_memory_stats()
        got = steps("ray-sharded", make_sharded_e2e_step(
            net, ren, opt_r, opt_t, bounds, BD_WEIGHT, mesh_r), e2e_args,
            PARALLEL_LAUNCHES["ray-sharded"], box_plan=net.make_box_plan(box))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        compare(f"ray-sharded e2e step (make_sharded_e2e_step, 1 x "
                f"{rays_v.shape[1]} rays, fused_cconv; peak {peak:.2f} GiB) "
                f"against phase 6's step", got, ref,
                {"loss": STEP_TOL["loss"], "next_pos": STEP_TOL["next_pos"]})
        del ref, got, net, ren, opt_r, opt_t

        # ---- (b) the particle-sharded transition steps
        mesh_p = make_mesh(axis_names=("particles",))
        group = mesh_p.group("particles")
        lattice = tuple(torch.from_numpy(a).to(dev)
                        for a in dryrun.lattice_problem(1))
        cases = (
            ("all-gather on 'auto'", make_sharded_particle_step,
             {**scene.particle_net_kwargs(), "search_backend": "auto"},
             (pos, vel, box, nrm), DRYRUN_TOL["pos"]),
            ("halo 1,024 on 'grid', 13,824-particle lattice",
             make_halo_particle_step,
             {**dryrun.LATTICE_NET, "halo_size": LATTICE_HALO}, lattice,
             DRYRUN_TOL["lattice_pos"]))
        for what, make, kw, args, tol in cases:
            ref_kw = {k: v for k, v in kw.items() if k != "halo_size"}
            nets = [ParticleNet(**kw_, device=dev,
                                generator=torch.Generator().manual_seed(0))
                    for kw_ in ({**kw, "shard_group": group}, ref_kw)]
            nets[1].load_state_dict(nets[0].state_dict())
            step = make(nets[0], mesh_p)
            b_plan = nets[0].make_box_plan(args[2])
            rows = particle_rows(mesh_p)
            with torch.no_grad():
                sh = step(rows.local(args[0]), rows.local(args[1]), *args[2:],
                          box_plan=b_plan)
                un = nets[1](*args, box_plan=b_plan)
            mism = int((sh[2] != un[2]).sum())
            d_pos = float((sh[0] - un[0]).abs().max())
            flags = {k: bool(v) for k, v in sh[3].items()}
            print(f"parallel phase (b), particle-sharded step, {what} "
                  f"({args[0].shape[0]} particles): neighbour counts that "
                  f"differ {mism}, max |pos diff| {d_pos:.3e} (tol "
                  f"{tol:.0e}), flags {flags}", flush=True)
            if mism or not d_pos <= tol or any(flags.values()):
                raise AssertionError(f"parallel phase (b), {what}: counts "
                                     f"{mism}, pos {d_pos:.3e}, {flags}")
            del nets, step, sh, un
        del lattice

        # ---- (c) the composed step on a 1 x 1 mesh, on 'auto'
        mesh_c = make_mesh((1, 1), ("particles", "rays"))
        blocks = spmd_ray_sharding(mesh_c)
        rows = particle_rows(mesh_c)
        c_args = (rows.local(pos), rows.local(vel), box, nrm, ro_v,
                  blocks.local(rays_v), blocks.local(rgbs_v))
        net, ren, opt_r, opt_t = models("auto")
        ref = steps("replicated on 'auto'", make_e2e_train_step(
            net, ren, opt_r, opt_t, bounds, BD_WEIGHT), c_args,
            box_plan=net.make_box_plan(box))
        net, ren, opt_r, opt_t = models("auto", mesh_c.group("particles"))
        torch.cuda.reset_peak_memory_stats()
        got = steps("spmd", make_spmd_e2e_step(
            net, ren, opt_r, opt_t, bounds, BD_WEIGHT, mesh_c), c_args,
            PARALLEL_LAUNCHES["spmd"], at_least=("K8",),
            box_plan=net.make_box_plan(box))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        equal = dryrun.replicas_equal(mesh_c, (ren, net), (opt_r, opt_t))
        compare(f"composed e2e step (make_spmd_e2e_step, 1 x 1 mesh, "
                f"'auto', dense renderer; peak {peak:.2f} GiB; replicas "
                f"bitwise equal {equal}) against the replicated step on "
                f"'auto'", got, ref,
                {"loss": DRYRUN_TOL["loss"], "grad_norm":
                 DRYRUN_TOL["grad_norm"], "next_pos": DRYRUN_TOL["pos"]})
        if not equal:
            raise AssertionError("parallel phase (c): replicas differ")
        del ref, got, net, ren, opt_r, opt_t
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp)

    # ---- host tools: the native library, generate_data
    if not native.available():
        raise AssertionError("the native library did not build")
    e_np, p_np = end.cpu().numpy(), pos.cpu().numpy()
    cd_native = native.chamfer(e_np, p_np)
    cd_card = float(chamfer.chamfer_distance(end, pos))
    scene_dir = tempfile.mkdtemp(prefix="chip_smoke_generate_", dir=build_dir)
    try:
        generate_data.main(["--out", os.path.join(scene_dir, "scene"),
                            "--frames", "2", "--img-size", "64",
                            "--n-side", "8"])
        ds = BlenderDataset(os.path.join(scene_dir, "scene"), img_wh=(64, 64),
                            view_names=["view_1"], end_index=2)
        sample = ds[0]
    finally:
        shutil.rmtree(scene_dir)
    print(f"parallel phase, host tools: native library "
          f"({native.library_path().name}) built and loaded; its chamfer of "
          f"the rollout's end state against the start {cd_native:.9e} on the "
          f"host, ops/chamfer.py on the card {cd_card:.9e}, diff "
          f"{abs(cd_native - cd_card):.3e} "
          f"(tol {CHAMFER_TOL:.0e}); generate_data wrote a 2-frame 64 x 64 "
          f"scene of {sample['particles_pos'].shape[0]} particles that "
          f"BlenderDataset loaded ({len(ds)} samples, rays "
          f"{tuple(sample['rays'].shape)})", flush=True)
    if not abs(cd_native - cd_card) <= CHAMFER_TOL:
        raise AssertionError(f"native chamfer {cd_native} vs {cd_card}")
    if sample["particles_pos"].shape != (512, 3) or not np.isfinite(
            sample["rays"]).all():
        raise AssertionError("generate_data's scene did not load")
    print(f"parallel phase: launches {phase}", flush=True)
    return phase


def protocol_phase(torch, build_dir, counts):
    """Phase 15: `full_protocol_run.main`, the port's reference-protocol
    run, on the card at PROTOCOL_SCENE with PROTOCOL_KNOBS (the runner's
    roots in a temporary directory under build/, its record there too):
    every key of PROTOCOL_R5.json and `device` in the record, every metric
    finite; per stage its peak memory and launches, the set of
    kernels launched as PROTOCOL_KERNELS says and the counts the stage
    implies (transition K1 = K2 = 10 a window, each rollout K1 5 a step, an
    e2e step K1 = K2 = 5, the warm-up K6 8 a step, a full frame K3 = K5 2
    a chunk); then `reval_e2e_rollout.main` on the saved e2e checkpoint
    (the first run's `pred2gt_mm` windows within PROTOCOL_RESUME_TOL), and
    a second `main` on the same root, which trains neither the warm-up
    (its loss None) nor the transition (no launch there, its loss None)
    and gives the first run's pretrained row within PROTOCOL_RESUME_TOL.
    Returns the phase's launches."""
    from neurofluid_torch.cli import full_protocol_run as fpr
    from neurofluid_torch.cli import reval_e2e_rollout

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "PROTOCOL_R5.json")) as f:
        r5_keys = set(json.load(f))
    img = PROTOCOL_SCENE["img"]
    phase_before = counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_protocol_", dir=build_dir)
    record = os.path.join(tmp, "PROTOCOL_TORCH.json")
    env = dict(PROTOCOL_KNOBS, PROTO_ROOT=os.path.join(tmp, "root"),
               PROTO_PRETRAIN=os.path.join(tmp, "pretrain"))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def finite(where, x):
        if isinstance(x, dict):
            for k, v in x.items():
                finite(f"{where}.{k}", v)
        elif isinstance(x, list):
            for i, v in enumerate(x):
                finite(f"{where}[{i}]", v)
        elif isinstance(x, float) and not math.isfinite(x):
            raise AssertionError(f"protocol phase: {where} is {x}")

    def rows_diff(a, b):
        keys = [k for k, v in a.items() if isinstance(v, float)]
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in keys)

    def check_stages(rec, what):
        stages = rec["device"]["stages"]
        if set(stages) != set(PROTOCOL_KERNELS):
            raise AssertionError(f"protocol phase, {what}: stages "
                                 f"{sorted(stages)}")
        # at conv_precision 'default' K1 and K2 run as K1d and K2d
        kid = ({"K1": "K1d", "K2": "K2d"}
               if rec["config"]["conv_precision"] == "default" else {})
        for name, st in stages.items():
            want = tuple(kid.get(k, k) for k in PROTOCOL_KERNELS[name])
            if what != "first run" and name in ("warmup", "transition"):
                # resumed fully trained: the warm-up's eval renders alone
                want = ("K3", "K5") if name == "warmup" else ()
            if set(st["launches"]) != set(want):
                raise AssertionError(f"protocol phase, {what}, {name}: "
                                     f"launches {st['launches']}; expected "
                                     f"only {want}")
        lau = {n: st["launches"] for n, st in stages.items()}
        rendered = rec["image_metrics_summary"]["frames_rendered"]
        chunks = -(-img * img // 2048)
        frames = len(range(0, 60, int(PROTOCOL_KNOBS["PROTO_RENDER_STRIDE"])))
        expect = {("renders", "K3"): 2 * chunks * frames,
                  ("renders", "K5"): 2 * chunks * frames}
        for tag, stage in (("pred2gt_mm_pretrained", "pretrained_rollout"),
                           ("pred2gt_mm", "rollout")):
            attempts = 1 + round(math.log2(
                rec[tag]["caps_used"]["fused_slab_cap"]
                / rec["config"]["fused_slab_cap"]))
            expect[(stage, kid.get("K1", "K1"))] = 5 * 60 * attempts
        e2e_steps = lau["e2e"][kid.get("K1", "K1")] // 5
        expect[("e2e", kid.get("K2", "K2"))] = 5 * e2e_steps
        if what == "first run":
            windows = rec["transition"]["train_windows"]
            epochs = rec["config"]["trans_epochs"]
            for k in ("K1", "K2"):
                expect[("transition", kid.get(k, k))] = 10 * windows * epochs
            iters = rec["config"]["warmup_iters"]
            expect[("warmup", "K6")] = 8 * iters
            expect[("warmup", "K3")] = 8 * iters + 2 * chunks
            expect[("warmup", "K5")] = 8 * iters + 2 * chunks
        else:
            expect[("warmup", "K3")] = expect[("warmup", "K5")] = 2 * chunks
        bad = {k: (lau[k[0]].get(k[1], 0), v) for k, v in expect.items()
               if lau[k[0]].get(k[1], 0) != v}
        if bad or e2e_steps < 1 or frames != rendered:
            raise AssertionError(f"protocol phase, {what}: launches (got, "
                                 f"expected) {bad}, e2e steps {e2e_steps}, "
                                 f"frames {rendered}")
        print(f"protocol phase, {what}, per stage (peak GiB, launches): "
              + "; ".join(f"{n} {st['peak_gib']:.3f} GiB, {st['launches']}"
                          for n, st in stages.items())
              + f"; e2e steps {e2e_steps}", flush=True)

    try:
        first = fpr.main(**PROTOCOL_SCENE, record=record)
        with open(record) as f:
            rec = json.load(f)
        if set(rec) != r5_keys | {"device"}:
            raise AssertionError(f"protocol phase: record keys {sorted(rec)}"
                                 f" != PROTOCOL_R5.json's and device")
        finite("record", {k: v for k, v in rec.items() if k != "config"})
        for stage in ("warmup", "transition", "e2e"):
            if rec[stage]["final_loss"] is None:
                raise AssertionError(f"protocol phase: {stage} trained "
                                     "nothing")
        check_stages(rec, "first run")
        summary = rec["image_metrics_summary"]
        print(f"protocol phase, first run ({PROTOCOL_SCENE}, "
              f"{PROTOCOL_KNOBS}) on {rec['device']['name']}"
              f" ({rec['device']['power_limit']}): warm-up PSNR fine "
              f"{rec['warmup']['psnr_fine']:.3f}, transition loss "
              f"{rec['transition']['final_loss']:.6f} over "
              f"{rec['transition']['train_windows']} windows, Pred2GT "
              f"pretrained {rec['pred2gt_mm_pretrained']['trained_pred2gt']:.3f}"
              f" / {rec['pred2gt_mm_pretrained']['rollout_pred2gt']:.3f} mm, "
              f"after e2e {rec['pred2gt_mm']['trained_pred2gt']:.3f} / "
              f"{rec['pred2gt_mm']['rollout_pred2gt']:.3f} mm, images "
              f"{summary}", flush=True)

        before = counts()
        row = reval_e2e_rollout.main(n_frames=PROTOCOL_SCENE["n_frames"],
                                     img=img, record=record)
        reval_launches = {k: v - before[k] for k, v in counts().items()
                          if v - before[k]}
        d_reval = rows_diff(row, first["pred2gt_mm"])
        with open(record) as f:
            patched = json.load(f)
        if (patched["pred2gt_mm"] != row
                or {k: v for k, v in patched.items() if k != "pred2gt_mm"}
                != {k: v for k, v in rec.items() if k != "pred2gt_mm"}):
            raise AssertionError("protocol phase: the re-evaluation changed "
                                 "more than pred2gt_mm")

        second = fpr.main(**PROTOCOL_SCENE, record=record)
        if (second["warmup"]["final_loss"] is not None
                or second["transition"]["final_loss"] is not None):
            raise AssertionError("protocol phase: the resumed run trained "
                                 "the warm-up or the transition again")
        check_stages(second, "resumed run")
        d_resume = rows_diff(second["pred2gt_mm_pretrained"],
                             first["pred2gt_mm_pretrained"])
        print(f"protocol phase, re-evaluation of the saved e2e checkpoint "
              f"(launches {reval_launches}): pred2gt_mm "
              f"within {d_reval:.3e} of the first run's "
              f"({'bitwise' if d_reval == 0 else 'not bitwise'}); resumed "
              f"run: warm-up and transition trained "
              f"nothing, pretrained row within {d_resume:.3e} "
              f"({'bitwise' if d_resume == 0 else 'not bitwise'}); "
              f"tolerance {PROTOCOL_RESUME_TOL:.0e}", flush=True)
        if not (d_reval <= PROTOCOL_RESUME_TOL
                and d_resume <= PROTOCOL_RESUME_TOL):
            raise AssertionError(f"protocol phase: re-evaluated {d_reval}, "
                                 f"resumed {d_resume} beyond "
                                 f"{PROTOCOL_RESUME_TOL}")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp)
    launched = {k: v - phase_before[k] for k, v in counts().items()}
    print(f"protocol phase: launches {launched}", flush=True)
    return launched


def seed_summary(values) -> tuple:
    """A tensor's pin: (the exact f64 sum of its entries, its first 4,
    its last 4), from a host array."""
    flat = [float(x) for x in values.reshape(-1)]
    return math.fsum(flat), tuple(flat[:4]), tuple(flat[-4:])


def seed_models(device):
    """The protocol's warm-up renderer and its transition model as a
    seeded trainer of each stage draws them, at TRAIN.seed SEED: the first
    key of its stream (`TrainerBase.next_key` on the key of its
    `__init__`), then the stage's `build_renderer` / `build_particle_net`.
    (RenderNet, ParticleNet) on `device`."""
    from types import SimpleNamespace

    from neurofluid_torch.cli.full_protocol_run import renderer_cfg
    from neurofluid_torch.train.trainer_base import TrainerBase
    from neurofluid_torch.train.transition import build_particle_net
    from neurofluid_torch.train.warmup import build_renderer
    from neurofluid_torch.utils import jax_random
    from neurofluid_torch.utils.config import ConfigNode

    def first_key():
        return TrainerBase.next_key(
            SimpleNamespace(key=jax_random.prng_key(SEED)))

    cfg = ConfigNode(dict(near=9.0, far=13.0, TRAIN=dict(seed=SEED),
                          RENDERER=renderer_cfg()))
    return (build_renderer(cfg, device, key=first_key()),
            build_particle_net(cfg, device, key=first_key()))


def seed_phase(torch, counts):
    """Phase 16: `seed_models` on the card and on the host, every tensor
    bitwise equal (the draw is the host's), SEED_PINS met, no launch."""
    before = counts()
    on_card, on_host = seed_models("cuda"), seed_models("cpu")
    states, n_tensors = {}, 0
    for card, hosted in zip(on_card, on_host):
        want = hosted.state_dict()
        for name, p in card.state_dict().items():
            n_tensors += 1
            if not torch.equal(p.cpu(), want[name]):
                raise AssertionError(f"seed phase: {name} differs between "
                                     "the card and the host")
            states[name] = want[name].numpy()
    for name, pin in SEED_PINS.items():
        got = seed_summary(states[name])
        if got != pin:
            raise AssertionError(f"seed phase: {name} drew {got}, JAX's "
                                 f"draw is {pin}")
    launched = {k: v - before[k] for k, v in counts().items()}
    if any(launched.values()):
        raise AssertionError(f"seed phase: launches {launched}")
    print(f"seed phase: JAX's seed-{SEED} draw of the warm-up RenderNet "
          f"and the ParticleNet, {n_tensors} tensors equal on the card and "
          f"the host, {len(SEED_PINS)} pins of JAX's draw met, no launch",
          flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from neurofluid_torch import cuda as nf_cuda
    from neurofluid_torch import scene
    from neurofluid_torch.data import BlenderDataset, synthetic
    from neurofluid_torch.models import ParticleNet, RenderNet
    from neurofluid_torch.models.nerf import NeRF
    from neurofluid_torch.ops import ball_features as bf
    from neurofluid_torch.ops import composite as comp
    from neurofluid_torch.ops import dense_layer as dl
    from neurofluid_torch.ops import encode as enc
    from neurofluid_torch.ops import fused_cconv as fc
    from neurofluid_torch.ops import fused_query as fq
    from neurofluid_torch.ops import neighbor_search as ns
    from neurofluid_torch.ops import segment_ops as so
    from neurofluid_torch.train import losses
    from neurofluid_torch.train.e2e import make_e2e_train_step
    from neurofluid_torch.train.transition import (
        make_rollout_fn, make_transition_train_step,
    )

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | tf32 off",
          flush=True)

    # ---- 2. build
    nf_cuda.build(["fused_cconv.cu", "fused_cconv_bf16.cu",
                   "ball_features.cu", "composite.cu", "fused_query.cu",
                   "segment_sum.cu", "dense_layer.cu", "encode.cu"])
    print("build: 8 sources (K1-K10, K1d and K2d; headers split_gemm.cuh, "
          "ball_walk.cuh, async_copy.cuh) with nvcc -gencode "
          "arch=compute_90a,code=sm_90a", flush=True)

    # the K1/K2 library holds the 3xTF32 product, the K1d/K2d library the
    # bf16 one: split_gemm_kernel<BN, TRANS_A, BF16>, mangled
    # ...ILi64ELb0ELb1EE... in the bf16 mode
    sections = sass_sections(nf_cuda.library_path("fused_cconv.cu"))
    sections_bf16 = sass_sections(nf_cuda.library_path("fused_cconv_bf16.cu"))
    tf32_ops = sass_tensor_ops(sections)
    bf16_ops = sass_tensor_ops(sections_bf16)
    tensor_ops = {**tf32_ops, **bf16_ops}
    print(f"sass: the tensor-core product's {len(tf32_ops)} 3xTF32 "
          f"instantiations (split_gemm_kernel<BN, TRANS_A, false>), HGMMA / "
          f"HMMA / bf16 HGMMA / bf16 HMMA each: {sorted(tf32_ops.values())}; "
          f"its {len(bf16_ops)} bf16 instantiations (<BN, TRANS_A, true>): "
          f"{sorted(bf16_ops.values())}", flush=True)
    if (len(tf32_ops) != 6 or len(bf16_ops) != 6
            or not all(re.search(r"split_gemm_kernelILi\d+ELb[01]ELb1E", n)
                       for n in bf16_ops)
            or any(h == 0 or m or b for h, m, b, _ in tf32_ops.values())
            or any(h == 0 or m or b != h
                   for h, m, b, _ in bf16_ops.values())):
        raise AssertionError("the tensor-core product is not on wgmma "
                             f"(HGMMA) alone, TF32 and bf16 in their own "
                             f"instantiations: {tensor_ops}")
    # K1d's and K2d's walks: bf16 tensor-core instructions (mma.sync shows
    # as HMMA ... BF16) in each of their instantiations
    walk_ops = {**sass_tensor_ops(sections_bf16, "walk_fwd_bf16_kernel"),
                **sass_tensor_ops(sections_bf16, "walk_bwd_bf16_kernel")}
    print(f"sass: K1d's and K2d's walks, {len(walk_ops)} instantiations "
          f"(walk_fwd_bf16_kernel<QB, NT, FOLD>, walk_bwd_bf16_kernel<QB, "
          f"LOCAL>), bf16 HMMA each: "
          f"{sorted(v[3] for v in walk_ops.values())}", flush=True)
    if len(walk_ops) != BF16_WALKS or any(v[3] == 0
                                          for v in walk_ops.values()):
        raise AssertionError(f"K1d's and K2d's walks without bf16 tensor-"
                             f"core instructions: {walk_ops}")
    # the f32 walks and the 3xTF32 product: the code of the tree they were
    # last changed in (PARENT_F32_CODE, taken with the toolkit it names)
    code = f32_sass_digests(sections, targets=False)
    exact = f32_sass_digests(sections)
    nvcc_ver = nf_cuda.nvcc_version()
    same = sorted(k for k, v in code.items() if PARENT_F32_CODE.get(k) == v)
    bytewise = sorted(k for k, v in exact.items()
                      if PARENT_F32_SASS.get(k) == v)
    print(f"sass: the f32 walks and the 3xTF32 product, {len(code)} "
          f"instantiations: {len(same)} the parent's instructions, "
          f"{len(bytewise)} of them to the byte (the others' branch and "
          f"call targets moved: {sorted(set(same) - set(bytewise))}) "
          f"(nvcc {nvcc_ver}; pinned with {PARENT_F32_SASS_NVCC}); "
          f"digests {code}", flush=True)
    if nvcc_ver == PARENT_F32_SASS_NVCC and (
            len(code) != len(PARENT_F32_CODE) or len(same) != len(code)):
        raise AssertionError(f"the f32 code of K1, K2 or the 3xTF32 product "
                             f"changed: {sorted(set(code) - set(same))}")

    def product_operands(m_, k_, n_, trans, gen=None):
        """Random operands of one tensor-core product (M, K) x (K, N) and
        the keywords of its call: the K range in the splits that K1 and K2
        give it (`product_splits`); `trans`: K2's dW form, A stored (K,
        M)."""
        a_ = torch.randn((k_, m_) if trans else (m_, k_), device=dev,
                         generator=gen)
        b_ = torch.randn((k_, n_), device=dev, generator=gen)
        n_split, per = fc.product_splits(m_, n_, k_)
        kw = dict(trans_a=True) if trans else {}
        if n_split > 1:
            kw.update(n_split=n_split, k_per_split=per)
        return a_, b_, kw

    # the tensor-core product at its three uses' shapes: the 14,336 sorted
    # fluid rows of the bench point in scratch chunks, Cin 96 and 64 ->
    # Cout 64 (conv1, conv2) and Cin 64 -> Cout 3 (conv3's dW)
    gen_g = torch.Generator(device=dev).manual_seed(3)
    for use, n_rows, cin_g, cout_g in (("K1 fold", 14336, 96, 64),
                                       ("K1 fold", 14336, 64, 64),
                                       ("K2 d_acc", 14336, 96, 64),
                                       ("K2 dW", 14336, 96, 64),
                                       ("K2 dW", 14336, 64, 3)):
        klen_g = 64 * cin_g
        rows_g = min(n_rows, fc.scratch_chunk_rows(n_rows, klen_g))
        mkn = {"K1 fold": (rows_g, klen_g, cout_g, False),
               "K2 d_acc": (rows_g, cout_g, klen_g, False),
               "K2 dW": (klen_g, rows_g, cout_g, True)}[use]
        a_g, b_g, kw = product_operands(*mkn, gen=gen_g)
        before = fc.GEMM_KERNEL.launches
        got = fc.split_gemm_cuda(a_g, b_g, **kw)
        torch.cuda.synchronize()
        if fc.GEMM_KERNEL.launches != before + 1:
            raise AssertionError("the tensor-core product did not launch")
        a_op = a_g.t() if kw.get("trans_a") else a_g
        want = a_op.double() @ b_g.double()
        scale = a_op.double().abs() @ b_g.double().abs()
        err = float(((got.double() - want).abs() / scale).max())
        err_lib = float((((a_op @ b_g).double() - want).abs() / scale).max())
        m_g, k_g = a_op.shape
        print(f"tensor-core product, {use} ({m_g} x {k_g}) x ({k_g} x "
              f"{b_g.shape[1]}){', %d splits' % kw['n_split'] if 'n_split' in kw else ''}: "
              f"max err / sum|a||b| {err:.3e} (tol {GEMM_TOL:.3e}; "
              f"torch.matmul f32 {err_lib:.3e})", flush=True)
        if not err <= GEMM_TOL:
            raise AssertionError(f"tensor-core product {use}: error {err:.3e} "
                                 f"> {GEMM_TOL:.3e}")
        del a_g, b_g, got, want, scale, a_op

    # the bf16 product (precision 'default') at the same shapes, against a
    # float64 product of the bf16-rounded inputs (the products of bf16
    # values are exact: only the f32 sums differ); the kernels line gives
    # its largest absolute error over the five shapes
    product_bf16_err = 0.0
    gen_g = torch.Generator(device=dev).manual_seed(3)
    for use, n_rows, cin_g, cout_g in (("K1 fold", 14336, 96, 64),
                                       ("K1 fold", 14336, 64, 64),
                                       ("K2 d_acc", 14336, 96, 64),
                                       ("K2 dW", 14336, 96, 64),
                                       ("K2 dW", 14336, 64, 3)):
        klen_g = 64 * cin_g
        rows_g = min(n_rows, fc.scratch_chunk_rows(n_rows, klen_g))
        mkn = {"K1 fold": (rows_g, klen_g, cout_g, False),
               "K2 d_acc": (rows_g, cout_g, klen_g, False),
               "K2 dW": (klen_g, rows_g, cout_g, True)}[use]
        a_g, b_g, kw = product_operands(*mkn, gen=gen_g)
        a_g = a_g.to(torch.bfloat16)  # A in bf16, as the walks write it
        kw["precision"] = "default"
        kern = fc.BF16_KERNELS["product"]
        before = (kern.launches, fc.GEMM_KERNEL.launches)
        got = fc.split_gemm_cuda(a_g, b_g, **kw)
        torch.cuda.synchronize()
        if (kern.launches, fc.GEMM_KERNEL.launches) != (before[0] + 1,
                                                        before[1]):
            raise AssertionError("the bf16 product did not launch alone")
        a_op = a_g.t() if kw.get("trans_a") else a_g
        a_r, b_r = a_op.double(), fc.bf16_round(b_g).double()
        want = a_r @ b_r
        scale = a_r.abs() @ b_r.abs()
        err = float(((got.double() - want).abs() / scale).max())
        off_f32 = float(((got.double() - a_op.double() @ b_g.double()).abs()
                         / scale).max())
        abs_err = float((got.double() - want).abs().max())
        m_g, k_g = a_op.shape
        print(f"bf16 product, {use} ({m_g} x {k_g}) x ({k_g} x "
              f"{b_g.shape[1]}){', %d splits' % kw['n_split'] if 'n_split' in kw else ''}: "
              f"A bf16, max err / sum|a||b| {err:.3e} against float64 of the "
              f"bf16 inputs (tol {GEMM_TOL:.3e}; {off_f32:.3e} from the "
              f"product with B unrounded) max_abs_err {abs_err:.3e}",
              flush=True)
        if not (err <= GEMM_TOL and off_f32 > 100.0 * GEMM_TOL):
            raise AssertionError(f"bf16 product {use}: error {err:.3e} "
                                 f"(tol {GEMM_TOL:.3e}), {off_f32:.3e} from "
                                 f"the f32 product")
        product_bf16_err = max(product_bf16_err, abs_err)
        del a_g, b_g, got, want, scale, a_op, a_r, b_r

    # ---- scene and models
    pos, vel, box, nrm, ro_v, rays_v, rgbs_v = (
        torch.from_numpy(a).to(dev) for a in scene.build_problem())
    ro, rays = ro_v[0], rays_v[0]
    net = ParticleNet(**scene.particle_net_kwargs(), device=dev)
    ren = RenderNet(device=dev)
    bench_weights(torch.Generator().manual_seed(0), net, ren)
    with torch.no_grad():  # opaque fluid: random sigma heads are ~0 or < 0
        for nerf in (ren.nerf_coarse, ren.nerf_fine):
            nerf.sigma.bias.fill_(SIGMA_BIAS)
    init_state = (copy.deepcopy(net.state_dict()),
                  copy.deepcopy(ren.state_dict()))
    rollout = make_rollout_fn(net)

    originals = {"K1": fc.fused_cconv_cuda, "K2": fc.fused_cconv_bwd_cuda,
                 "K3": bf.ball_sums_cuda, "K4": bf.ball_sums_bwd_cuda,
                 "K5": comp.composite_weights_cuda,
                 "K6": comp.composite_weights_bwd_cuda,
                 "K7": fq.ball_query_compact_cuda, "K8": so.segment_sum_cuda,
                 "K1d": fc.fused_cconv_cuda, "K2d": fc.fused_cconv_bwd_cuda,
                 "K10": enc.encode_features_cuda}
    plain = {"K1": fc.fused_cconv_plain, "K2": fc.fused_cconv_bwd_plain,
             "K1d": fc.fused_cconv_plain, "K2d": fc.fused_cconv_bwd_plain,
             "K3": bf.ball_sums_plain, "K4": bf.ball_sums_bwd_plain,
             "K5": comp.composite_weights_plain,
             "K6": comp.composite_weights_bwd_plain,
             "K7": fq.ball_query_compact_plain, "K8": so.segment_sum_plain,
             "K9": NeRF._forward_plain, "K10": enc.encode_features_plain}
    wrapper_names = {"K1": (fc, "fused_cconv_cuda"),
                     "K2": (fc, "fused_cconv_bwd_cuda"),
                     "K3": (bf, "ball_sums_cuda"),
                     "K4": (bf, "ball_sums_bwd_cuda"),
                     "K5": (comp, "composite_weights_cuda"),
                     "K6": (comp, "composite_weights_bwd_cuda"),
                     "K7": (fq, "ball_query_compact_cuda"),
                     "K8": (so, "segment_sum_cuda"),
                     "K9": (NeRF, "_forward_k9"),
                     "K10": (enc, "encode_features_cuda")}
    counters = {"K1": fc.KERNEL, "K2": fc.BWD_KERNEL, "K3": bf.KERNEL,
                "K4": bf.BWD_KERNEL, "K5": comp.KERNEL,
                "K6": comp.BWD_KERNEL, "K7": fq.KERNEL, "K8": so.KERNEL}

    def recording(calls, names):
        def wrap(name):
            def fn(*args):
                calls[name].append(args)
                return originals[name](*args)
            return fn
        return Recorder([(*wrapper_names[n], wrap(n)) for n in names])

    def on_plain(names):
        return Recorder([(*wrapper_names[n], plain[n]) for n in names])

    def counts():
        return {k: c.launches for k, c in counters.items()}

    # K1 and K2 at precision 'default' (their bf16 instantiations) and the
    # bf16 product inside them, counted apart: the runs at 'default'
    # (phases 8 and 15) read them
    def bf16_counts():
        return {"K1d": fc.BF16_KERNELS["K1"].launches,
                "K2d": fc.BF16_KERNELS["K2"].launches,
                "product": fc.product_launches("default")}

    def reset_counts():
        for c in counters.values():
            c.launches = 0

    def k10_launches():
        """K10's launches so far, forward and backward."""
        return enc.KERNEL.launches + enc.BWD_KERNEL.launches

    kernels = {}  # the largest error of each kernel against its plain

    def check(name, i, outputs, exact=None, highest=()):
        """outputs: (label, got, want) float outputs, each held to TOL
        scaled as RELATIVE says; exact: integer-valued outputs that must
        agree exactly (in-radius counts, selection counts, ids); highest:
        (label, plain 'highest' result) of each output of a K1d or K2d
        call, from which its mean deviation must be BF16_MARGIN times that
        from its plain 'default' result."""
        err = 0.0
        want_of = {label: (got, want) for label, got, want in outputs}
        far = []
        for label, want_h in highest:
            got, want = want_of[label]
            if got is None:
                continue
            d_d = float((got - want).abs().mean())
            d_h = float((got - want_h).abs().mean())
            if not BF16_MARGIN * d_d <= d_h:
                raise AssertionError(f"{name} call {i} {label}: mean "
                                     f"deviation {d_d:.3e} from the plain "
                                     f"'default' result, {d_h:.3e} from the "
                                     f"plain 'highest' one")
            far.append(f"{label} {d_h / max(d_d, 1e-30):.0f}x")
        if far:
            print(f"{name} call {i}: mean deviation from plain 'highest' "
                  f"over that from plain 'default': " + ", ".join(far),
                  flush=True)
        for label, got, want in outputs:
            if got is None and want is None:
                continue
            e = float((got - want).abs().max())
            scale = float(want.abs().max())
            tol = KERNEL_TOL[name] * {
                "abs": 1.0, "max": scale,
                "max1": max(scale, 1.0)}[KERNEL_RELATIVE[name]]
            if not e <= tol:
                raise AssertionError(f"{name} call {i} {label}: max abs err "
                                     f"{e:.3e} > tolerance {tol:.3e}")
            err = max(err, e)
        if exact is not None:
            mismatch = int((exact[0] != exact[1]).sum())
            if mismatch:
                raise AssertionError(f"{name} call {i}: {mismatch} integer "
                                     f"sums differ from the plain version")
        kernels[name] = max(kernels.get(name, 0.0), err)
        print(f"kernel {name} call {i}: max_abs_err {err:.3e} (tol "
              f"{KERNEL_TOL[name]:.0e}, {KERNEL_RELATIVE[name]})", flush=True)

    def check_k8(i, vals, plan):
        """K8 at one recorded call against its plain version."""
        got, want = so.segment_sum_cuda(vals, plan), \
            so.segment_sum_plain(vals, plan)
        m, c = vals.shape
        # kept: the rows outside the trash segment (the lists' padding slots)
        kept = int((plan.ids < plan.n).sum())
        check("K8", f"{i} (M {m}, kept {kept}, C {c})", [("sums", got, want)])

    dense_err = dense_phase(torch, dev)

    # ---- 3. forward kernels at the serving path's shapes
    calls = {"K1": [], "K3": [], "K5": [], "K10": []}
    with torch.no_grad(), recording(calls, calls):
        traj, _ = rollout(pos, vel, box, nrm, 1)
        ren(traj[-1], ro, rays)
    torch.cuda.synchronize()

    with torch.no_grad():
        for i, args in enumerate(calls["K1"]):
            got = fc.fused_cconv_cuda(*args)
            want = fc.fused_cconv_plain(*args)
            cin, cout = args[0].shape[-2:]
            check("K1", f"{i} (Cin {cin}, Cout {cout})",
                  [("out", got[0], want[0])], exact=(got[1], want[1]))
        # K1d: the same calls at precision 'default'
        for i, args in enumerate(calls["K1"]):
            args_d = args[:8] + ("default",)
            got = fc.fused_cconv_cuda(*args_d)
            want = fc.fused_cconv_plain(*args_d)
            want_h = fc.fused_cconv_plain(*args[:8])
            cin, cout = args[0].shape[-2:]
            check("K1d", f"{i} (Cin {cin}, Cout {cout})",
                  [("out", got[0], want[0])], exact=(got[1], want[1]),
                  highest=[("out", want_h[0])])
        for i, args in enumerate(calls["K3"]):
            got, want = bf.ball_sums_cuda(*args), bf.ball_sums_plain(*args)
            check("K3", i, [("sums", got[:, 3:], want[:, 3:])],
                  exact=(got[:, :3], want[:, :3]))
        for i, args in enumerate(calls["K5"]):
            got = comp.composite_weights_cuda(*args)
            want = comp.composite_weights_plain(*args)
            check("K5", i, [("w", got, want)])
        # K10 (the coarse pass's rows, then the fine pass's from both
        # sources), and its backward from a seeded cotangent against the
        # plain VJP in float64
        gen_e = torch.Generator(device=dev).manual_seed(5)
        for i, args in enumerate(calls["K10"]):
            got = enc.encode_features_cuda(*args)
            check("K10", f"{i} ({tuple(got.shape)})",
                  [("rows", got, enc.encode_features_plain(*args))])
            sources, rays_e, ro_e, encoding, sigma_only = args
            g_e = torch.randn(got.shape, device=dev, generator=gen_e)
            grads = enc.encode_features_bwd_cuda(*args, g_e)
            args64 = ([enc.Geometry(*(None if t is None else t.double()
                                      for t in s)) for s in sources],
                      rays_e.double(), ro_e.double(), encoding, sigma_only,
                      g_e.double())
            want = enc.encode_features_bwd_plain(*args64)
            scale = enc.encode_features_bwd_plain(*args64, absolute=True)
            worst, worst_abs = 0.0, 0.0
            for gs, ws, ss in zip(grads, want, scale):
                for d, w, sc in zip(gs, ws, ss):
                    if w is None:
                        continue
                    worst = max(worst, float(((d.double() - w).abs()
                                              / sc).max()))
                    worst_abs = max(worst_abs,
                                    float((d.double() - w).abs().max()))
            print(f"kernel K10 backward call {i}: max err / sum of the "
                  f"terms' magnitudes {worst:.3e} (tol "
                  f"{ENCODE_BWD_TOL:.0e}), max_abs_err {worst_abs:.3e}",
                  flush=True)
            if not worst <= ENCODE_BWD_TOL:
                raise AssertionError(f"K10 backward call {i}: error "
                                     f"{worst:.3e} > {ENCODE_BWD_TOL:.0e}")
            kernels["K10"] = max(kernels["K10"], worst_abs)
        # K5 on longer rays (tiles of 256, the carry in a register): the
        # fine call's sigmas, depths and ray norms, sorted depths extended
        sig, z, dn = calls["K5"][-1]
        reps = -(-K5_LONG_SAMPLES // sig.shape[1])
        z_long = torch.sort(torch.cat([z + 0.001 * j for j in range(reps)],
                                      1)[:, :K5_LONG_SAMPLES], 1).values
        args = (torch.cat([sig] * reps, 1)[:, :K5_LONG_SAMPLES].contiguous(),
                z_long.contiguous(), dn)
        got = comp.composite_weights_cuda(*args)
        want = comp.composite_weights_plain(*args)
        check("K5", f"S {K5_LONG_SAMPLES} (tiles of 256; not on the main "
              "path)", [("w", got, want)])
    del calls

    # ---- 4. serving path, counted (K9 by its library's process-wide count,
    # as a difference around the run)
    reset_counts()
    k9_before, k10_before = dl.gemm_launches(), k10_launches()
    with torch.no_grad():
        traj, flags = rollout(pos, vel, box, nrm, ROLLOUT_STEPS)
        out = ren(traj[-1], ro, rays)
    serve_launches = {k: v for k, v in counts().items() if v}
    serve_launches["K9"] = dl.gemm_launches() - k9_before
    serve_launches["K10"] = k10_launches() - k10_before
    total_launches = counts()
    k9_main, k10_main = serve_launches["K9"], serve_launches["K10"]
    print(f"serving path: launches {serve_launches}", flush=True)
    if serve_launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launches {serve_launches} != "
                             f"{EXPECTED_LAUNCHES}")
    if traj.shape != (ROLLOUT_STEPS, scene.N_PARTICLES, 3):
        raise AssertionError(f"trajectory shape {tuple(traj.shape)}")
    if not bool(torch.isfinite(traj).all()):
        raise AssertionError("non-finite particle positions")
    for key, v in out.items():
        if not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"non-finite render output {key}")
    if out["rgb1"].shape != (scene.N_RAYS, 3):
        raise AssertionError(f"rgb1 shape {tuple(out['rgb1'].shape)}")
    if any(bool(v) for v in flags.values()) or bool(out["overflow"]):
        raise AssertionError(f"overflow flags set: {flags}, render "
                             f"{bool(out['overflow'])}")
    if int(out["mask_0"].sum()) == 0 or float(out["opacity1"].max()) < 0.5:
        raise AssertionError("the render is empty: no opaque sample")

    print(f"serving path: rollout {ROLLOUT_STEPS} steps, render of "
          f"{scene.N_RAYS} rays, opacity1 mean "
          f"{float(out['opacity1'].mean()):.4f}, mask_0 {int(out['mask_0'].sum())}",
          flush=True)

    # the same path on the plain versions on the card; the render is fed the
    # kernel rollout's last frame so each comparison sees the same inputs
    before = counts(), dl.gemm_launches(), k10_launches()
    with torch.no_grad(), on_plain(("K1", "K3", "K5", "K9", "K10")):
        traj_p, _ = rollout(pos, vel, box, nrm, ROLLOUT_STEPS)
        out_p = ren(traj[-1], ro, rays)
    if (counts(), dl.gemm_launches(), k10_launches()) != before:
        raise AssertionError("the plain run launched a kernel")
    diffs = {"traj": float((traj_p - traj).abs().max())}
    for key in ("rgb0", "depth0", "opacity0", "rgb1", "depth1", "opacity1"):
        diffs[key] = float((out_p[key] - out[key]).abs().max())
        diffs[key + "_mean"] = float((out_p[key] - out[key]).abs().mean())
    diffs["num_nn_0_mismatch"] = int((out_p["num_nn_0"] != out["num_nn_0"]).sum())
    print(f"plain serving path on the card: max abs diffs "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()), flush=True)
    # tolerances: f32 sums in another order compound over 10 steps; the
    # coarse pass sees identical inputs; the fine samples move with K5's
    # rounding, so a boundary particle can swap in or out of a first-K set
    limits = {"traj": 1e-4, "rgb0": 1e-4, "opacity0": 1e-4, "depth0": 1e-3,
              "rgb1_mean": 1e-4, "opacity1_mean": 1e-4, "depth1_mean": 1e-3}
    bad = {k: diffs[k] for k, lim in limits.items() if not diffs[k] <= lim}
    if bad:
        raise AssertionError(f"plain path disagrees beyond tolerance: {bad}")
    # phase 13 renders the rollout's last frame again and measures it
    # against the start
    serve_end = traj[-1].clone()
    dense_ref = {k: out[k] for k in ("num_nn_0", "mask_0", "num_nn_1",
                                     "mask_1", "rgb0", "rgb1")}
    del traj, traj_p, out, out_p

    # ---- 5. backward kernels at the shapes of one recorded train step
    bounds = losses.default_box_bounds(device=dev)
    box_plan = net.make_box_plan(box)

    def trainer():
        """Fresh models and Adam states from the seeded initial weights."""
        t_net = ParticleNet(**scene.particle_net_kwargs(), device=dev,
                            generator=torch.Generator().manual_seed(1))
        t_ren = RenderNet(device=dev, generator=torch.Generator().manual_seed(2))
        t_net.load_state_dict(init_state[0])
        t_ren.load_state_dict(init_state[1])
        opt_r = torch.optim.Adam(t_ren.parameters(), lr=LR_RENDERER)
        opt_t = torch.optim.Adam(t_net.parameters(), lr=LR_TRANSITION)
        step = make_e2e_train_step(t_net, t_ren, opt_r, opt_t, bounds,
                                   BD_WEIGHT)
        return t_net, t_ren, step

    def run_step(step, p, v):
        return step(p, v, box, nrm, ro_v, rays_v, rgbs_v, box_plan=box_plan)

    def grads_of(model):
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    t_net, t_ren, step = trainer()
    calls = {"K2": [], "K4": [], "K6": []}
    with recording(calls, calls):  # the warm-up step
        loss_w, pos_w, vel_w, aux_w = run_step(step, pos, vel)
    torch.cuda.synchronize()
    warm = dict(loss=float(loss_w), next_pos=pos_w, aux=aux_w,
                grads_renderer=grads_of(t_ren),
                grads_transition=grads_of(t_net))
    got_calls = {k: len(v) for k, v in calls.items()}
    want_calls = {k: STEP_LAUNCHES[k] for k in calls}
    if got_calls != want_calls:
        raise AssertionError(f"warm-up step calls {got_calls} != {want_calls}")

    with torch.no_grad():
        # K2 at the step's calls, then K2d: the same at precision 'default'
        for (i, args), prec in [(c, p) for p in ("highest", "default")
                                for c in enumerate(calls["K2"])]:
            cin, cout = args[0].shape[-2:]
            bf16 = prec == "default"
            for form, nd in (("step", args[9]), ("all", (True,) * 4)):
                a = args[:9] + (nd, prec)
                got = fc.fused_cconv_bwd_cuda(*a)
                want = fc.fused_cconv_bwd_plain(*a)
                labels = ("dW", "dq", "dc", "dfeats")
                highest = ()
                if bf16:
                    highest = list(zip(labels, fc.fused_cconv_bwd_plain(
                        *args[:9], nd)))
                check("K2d" if bf16 else "K2", f"{i} (Cin {cin}, Cout "
                      f"{cout}, {form} {''.join(str(int(x)) for x in nd)})",
                      list(zip(labels, got, want)),
                      highest=[(lb, h) for lb, h in highest if h is not None])
        for i, args in enumerate(calls["K4"]):
            got, want = bf.ball_sums_bwd_cuda(*args), bf.ball_sums_bwd_plain(*args)
            check("K4", i, [("d_points", got, want)])
        for i, args in enumerate(calls["K6"]):
            got = comp.composite_weights_bwd_cuda(*args)
            want = comp.composite_weights_bwd_plain(*args)
            check("K6", i, [("d_sigma", got, want)])
    del calls

    # ---- 6. train path, counted: the state carried from step to step
    reset_counts()
    k9_before, k10_before = dl.gemm_launches(), k10_launches()
    auxes, step_losses = [], []
    p, v = pos_w, vel_w
    for _ in range(TRAIN_STEPS):
        loss, p, v, aux = run_step(step, p, v)
        auxes.append(aux)
        step_losses.append(loss)
    train_launches = counts()
    train_launches["K9"] = dl.gemm_launches() - k9_before
    train_launches["K10"] = k10_launches() - k10_before
    k9_main += train_launches["K9"]
    k10_main += train_launches["K10"]
    total_launches = {k: v + train_launches[k]
                      for k, v in total_launches.items()}
    want_launches = {k: n * TRAIN_STEPS for k, n in STEP_LAUNCHES.items()}
    print(f"train path: launches {train_launches} in {TRAIN_STEPS} steps",
          flush=True)
    if train_launches != want_launches:
        raise AssertionError(f"launches {train_launches} != {want_launches}")
    for i, (loss, aux) in enumerate(zip(step_losses, auxes)):
        gn_r = float(aux["grad_norm_renderer"])
        gn_t = float(aux["grad_norm_transition"])
        if not (torch.isfinite(loss) and gn_r == gn_r and gn_t == gn_t
                and gn_r < float("inf") and gn_t < float("inf")):
            raise AssertionError(f"step {i}: loss {float(loss)}, grad norms "
                                 f"{gn_r}, {gn_t}")
        if bool(aux["search_overflow"]) or bool(aux["search_cap_exceeded"]):
            raise AssertionError(f"step {i}: a search overflow flag is set")
        if not gn_t > 0.0:
            raise AssertionError(f"step {i}: grad_norm_transition {gn_t}: no "
                                 f"image gradient reaches the simulator")
    if p.shape != (scene.N_PARTICLES, 3) or not bool(torch.isfinite(p).all()):
        raise AssertionError("non-finite or misshapen carried state")
    print(f"train path: {TRAIN_STEPS} steps, losses "
          + ", ".join(f"{float(x):.6f}" for x in step_losses)
          + f"; grad norms renderer {float(auxes[-1]['grad_norm_renderer']):.4e}"
          f" transition {float(auxes[-1]['grad_norm_transition']):.4e}",
          flush=True)
    del auxes, step_losses, p, v

    def step_diffs(loss_x, pos_x, aux_x, net_x, ren_x):
        """Differences of a step from the same weights and state against the
        warm-up step: loss and grad norms relative, next_pos absolute, each
        model's gradients relative to its largest gradient entry (grads_*)
        and its worst leaf relative to the leaf's own largest entry
        (leaf_*, named in the second result), and the neighbour counts that
        differ."""
        d = {"loss": abs(float(loss_x) - warm["loss"]) / abs(warm["loss"]),
             "next_pos": float((pos_x - warm["next_pos"]).abs().max())}
        for key in ("grad_norm_renderer", "grad_norm_transition"):
            w_ = float(warm["aux"][key])
            d[key] = abs(float(aux_x[key]) - w_) / w_
        worst = {}
        for key, model in (("renderer", ren_x), ("transition", net_x)):
            ref = warm["grads_" + key]
            top = max(max(float(g.abs().max()) for g in ref.values()), 1e-30)
            errs = {n: float((prm.grad - ref[n]).abs().max())
                    for n, prm in model.named_parameters()}
            rel = {n: e / max(float(ref[n].abs().max()), 1e-30)
                   for n, e in errs.items()}
            d["grads_" + key] = max(errs.values()) / top
            worst[key] = max(rel, key=rel.get)
            d["leaf_" + key] = rel[worst[key]]
        mism = {k: int((aux_x[k] != warm["aux"][k]).sum())
                for k in ("num_nn_0", "num_nn_1")}
        return d, worst, mism

    def show(what, d, worst, mism):
        print(f"{what}: diffs " + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
              + " (loss, grad norms relative; grads_* relative to the model's "
              "largest entry, leaf_* to the leaf's own; next_pos absolute); "
              f"worst leaves {worst}; neighbour counts that differ {mism}",
              flush=True)

    def compare(what, swapped, tol):
        """The warm-up step from the same weights and state with `swapped`
        on their plain versions: those launch no kernel, the rest launch
        as in a kernel step, and every difference is within `tol`."""
        c_net, c_ren, c_step = trainer()
        before = counts()
        k9_before, k10_before = dl.gemm_launches(), k10_launches()
        with on_plain(swapped):
            loss_c, pos_c, _, aux_c = run_step(c_step, pos, vel)
        launched = {k: v - before[k] for k, v in counts().items()}
        launched["K9"] = dl.gemm_launches() - k9_before
        launched["K10"] = k10_launches() - k10_before
        want = {k: 0 if k in swapped else STEP_LAUNCHES[k] for k in launched}
        if launched != want:
            raise AssertionError(f"{what}: launches {launched} != {want}")
        d, worst, mism = step_diffs(loss_c, pos_c, aux_c, c_net, c_ren)
        show(what, d, worst, mism)
        bad = {k: v for k, v in d.items() if k in tol and not v <= tol[k]}
        if bad:
            raise AssertionError(f"{what} disagrees beyond tolerance: {bad}")

    # the warm-up step again with the kernels, from the same weights and
    # state: its spread is the floor of the comparisons below (K2 and K4 add
    # with atomics, in an order that varies from run to run)
    compare("kernel train step rerun", (), {})
    # only the backward kernels on their plain versions: the forward is the
    # kernels' own (K1, K3 and K5 are deterministic), so every leaf's
    # gradient is held to the backward versions' summation order alone
    compare("train step with plain K2, K4, K6", ("K2", "K4", "K6"),
            BWD_STEP_TOL)
    # only the forward kernels on their plain versions, and then all six:
    # the forward's rounding, not the backward, moves the gradients here
    compare("train step with plain K1, K3, K5", ("K1", "K3", "K5"), STEP_TOL)
    compare("plain train step on the card", tuple(STEP_LAUNCHES), STEP_TOL)

    # ---- 7. list kernels at the shapes of one recorded transition step
    pos1, pos2 = pos + 0.001, pos + 0.002

    def transition_trainer(backend, precision="highest"):
        """A fresh ParticleNet on `backend` (its convs at `precision`) from
        the seeded initial weights, its Adam state, train step and box
        plan."""
        t_net = ParticleNet(**scene.particle_net_kwargs(),
                            search_backend=backend, conv_precision=precision,
                            device=dev,
                            generator=torch.Generator().manual_seed(1))
        t_net.load_state_dict(init_state[0])
        opt = torch.optim.Adam(t_net.parameters(), lr=LR_TRANSITION_ONLY)
        t_step = make_transition_train_step(t_net, opt, bounds,
                                            TRANSITION_CLIP)
        return t_net, t_step, t_net.make_box_plan(box)

    def run_transition(t_step, plan):
        return t_step(pos, vel, pos1, pos2, box, nrm, box_plan=plan)

    def first_prediction(t_net, plan):
        with torch.no_grad():
            pred, _, nn, _ = t_net(pos, vel, box, nrm, box_plan=plan)
        return pred, nn

    trainers = {b: transition_trainer(b) for b in ("fused_cconv", "fused")}
    first = {b: first_prediction(t_net, plan)
             for b, (t_net, _, plan) in trainers.items()}
    warm_t = {}
    calls = {"K2": [], "K7": [], "K8": []}
    for backend, (t_net, t_step, plan) in trainers.items():
        with recording(calls, calls):  # the warm-up steps
            loss_w, aux_w = run_transition(t_step, plan)
        torch.cuda.synchronize()
        warm_t[backend] = dict(loss=float(loss_w), aux=aux_w,
                               grads=grads_of(t_net))
    got_calls = {k: len(v) for k, v in calls.items()}
    want_calls = {"K2": TRANSITION_LAUNCHES["fused_cconv"]["K2"],
                  **TRANSITION_LAUNCHES["fused"]}
    if got_calls != want_calls:
        raise AssertionError(f"warm-up transition steps: calls {got_calls} "
                             f"!= {want_calls}")

    with torch.no_grad():
        for i, args in enumerate(calls["K7"]):
            k, excl = args[8], args[10]
            got = fq.ball_query_compact_cuda(*args)
            want = fq.ball_query_compact_plain(*args)
            mask = [torch.arange(k, device=dev)[None, :]
                    < torch.clamp(c, max=k)[:, None] for c in (got[1], want[1])]
            check("K7", f"{i} (k {k}, exclude_self {int(excl)})", [],
                  exact=tuple(torch.cat([o[0].reshape(-1), o[1],
                                         m.reshape(-1).int()])
                              for o, m in zip((got, want), mask)))
        for i, (vals, plan) in enumerate(calls["K8"]):
            check_k8(i, vals, plan)
    del calls

    # ---- 8. transition train path, counted, on each search backend
    d_first = {
        "loss": abs(warm_t["fused"]["loss"] - warm_t["fused_cconv"]["loss"])
        / abs(warm_t["fused_cconv"]["loss"]),
        "pred_pos": float((first["fused"][0]
                           - first["fused_cconv"][0]).abs().max())}
    print("transition backends, first step from the same weights: diffs "
          + ", ".join(f"{k} {v:.3e}" for k, v in d_first.items())
          + f" (loss relative, pred_pos absolute); neighbour counts that "
          f"differ {int((first['fused'][1] != first['fused_cconv'][1]).sum())}"
          f", largest count {int(first['fused'][1].max())}", flush=True)
    bad = {k: v for k, v in d_first.items() if not v <= BACKEND_TOL[k]}
    if bad:
        raise AssertionError(f"the two backends disagree beyond tolerance: "
                             f"{bad}")

    def counted_transition(backend, t_step, plan):
        """TRANSITION_STEPS counted steps of `backend` from its warm-up
        state: launches per step as TRANSITION_LAUNCHES says, finite losses
        that fall, gradients, no flag set. Returns the launches."""
        per_step = {k: TRANSITION_LAUNCHES[backend].get(k, 0)
                    for k in counters}
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        step_losses, auxes = [], []
        for _ in range(TRANSITION_STEPS):
            loss, aux = run_transition(t_step, plan)
            step_losses.append(float(loss))
            auxes.append(aux)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = counts()
        want = {k: n * TRANSITION_STEPS for k, n in per_step.items()}
        print(f"transition train path ({backend}): launches "
              f"{ {k: v for k, v in launched.items() if v} } in "
              f"{TRANSITION_STEPS} steps", flush=True)
        if launched != want:
            raise AssertionError(f"{backend}: launches {launched} != {want}")
        for i, (loss, aux) in enumerate(zip(step_losses, auxes)):
            gn = float(aux["grad_norm"])
            if not (loss == loss and abs(loss) < float("inf")
                    and 0.0 < gn < float("inf")):
                raise AssertionError(f"{backend} step {i}: loss {loss}, "
                                     f"grad_norm {gn}")
            if bool(aux["search_overflow"]) or bool(aux["search_cap_exceeded"]):
                raise AssertionError(f"{backend} step {i}: a search overflow "
                                     f"or neighbour cap flag is set")
        if not step_losses[-1] < warm_t[backend]["loss"]:
            raise AssertionError(f"{backend}: the loss does not fall: "
                                 f"{warm_t[backend]['loss']} -> {step_losses}")
        print(f"transition train path ({backend}): {TRANSITION_STEPS} steps, "
              f"peak memory {peak_gb:.2f} GB; losses "
              f"{warm_t[backend]['loss']:.6f} (warm-up), "
              + ", ".join(f"{x:.6f}" for x in step_losses)
              + f"; grad_norm {float(auxes[-1]['grad_norm']):.4e}", flush=True)
        return launched

    for backend, (t_net, t_step, plan) in trainers.items():
        launched = counted_transition(backend, t_step, plan)
        total_launches = {k: v + launched[k]
                          for k, v in total_launches.items()}

    def compare_transition(backend, what, swapped, tol):
        """The warm-up transition step of `backend` from the same weights
        with `swapped` on their plain versions: those launch no kernel, the
        rest launch as in a kernel step, every difference within `tol`."""
        c_net, c_step, c_plan = transition_trainer(backend)
        before = counts()
        with on_plain(swapped):
            loss_c, aux_c = run_transition(c_step, c_plan)
        launched = {k: v - before[k] for k, v in counts().items()}
        want = {k: 0 if k in swapped
                else TRANSITION_LAUNCHES[backend].get(k, 0) for k in launched}
        if launched != want:
            raise AssertionError(f"{what}: launches {launched} != {want}")
        ref = warm_t[backend]
        errs = {n: float((prm.grad - ref["grads"][n]).abs().max())
                for n, prm in c_net.named_parameters()}
        rel = {n: e / max(float(ref["grads"][n].abs().max()), 1e-30)
               for n, e in errs.items()}
        worst = max(rel, key=rel.get)
        gn = float(ref["aux"]["grad_norm"])
        d = {"loss": abs(float(loss_c) - ref["loss"]) / abs(ref["loss"]),
             "grad_norm": abs(float(aux_c["grad_norm"]) - gn) / gn,
             "grads": max(errs.values()) / max(
                 float(g.abs().max()) for g in ref["grads"].values()),
             "leaf": rel[worst]}
        print(f"{what}: diffs "
              + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
              + " (loss, grad_norm relative; grads relative to the model's "
              f"largest entry, leaf to the leaf's own); worst leaf {worst}",
              flush=True)
        bad = {k: v for k, v in d.items() if k in tol and not v <= tol[k]}
        if bad:
            raise AssertionError(f"{what} disagrees beyond tolerance: {bad}")

    compare_transition("fused", "fused transition step rerun", (), {})
    compare_transition("fused", "fused transition step with plain K8",
                       ("K8",), LIST_STEP_TOL)
    compare_transition("fused", "fused transition step with plain K7, K8",
                       ("K7", "K8"), LIST_STEP_TOL)
    compare_transition("fused_cconv", "fused_cconv transition step rerun",
                       (), {})
    compare_transition("fused_cconv",
                       "fused_cconv transition step with plain K1, K2",
                       ("K1", "K2"), CCONV_STEP_TOL)

    # the `fused_cconv` transition step at 'default' (K1d, K2d and the bf16
    # product: their main path) beside 'highest', from the same weights:
    # TRANSITION_STEPS counted steps each, the counts set to 0 just
    # before the 'default' steps and read just after; the first steps'
    # loss and grad_norm within BF16_STEP_TOL, and not equal
    prec_runs = {}
    for prec in ("highest", "default"):
        p_net, p_step, p_plan = transition_trainer("fused_cconv", prec)
        reset_counts()
        fc.BF16_KERNELS["K1"].launches = fc.BF16_KERNELS["K2"].launches = 0
        before_d = bf16_counts()
        step_losses, gns = [], []
        for _ in range(TRANSITION_STEPS):
            loss, aux = run_transition(p_step, p_plan)
            step_losses.append(float(loss))
            gns.append(float(aux["grad_norm"]))
        launched = {k: v for k, v in counts().items() if v}
        launched.update({k: v - before_d[k] for k, v in bf16_counts().items()
                         if v - before_d[k]})
        want = ({"K1": 10 * TRANSITION_STEPS, "K2": 10 * TRANSITION_STEPS}
                if prec == "highest" else
                {"K1d": 10 * TRANSITION_STEPS, "K2d": 10 * TRANSITION_STEPS,
                 "product": launched.get("product", 0)})
        print(f"transition train path (fused_cconv, conv_precision "
              f"'{prec}'): launches {launched} in {TRANSITION_STEPS} steps; "
              f"losses "
              + ", ".join(f"{x:.6f}" for x in step_losses)
              + f"; grad_norm first {gns[0]:.6e} last {gns[-1]:.6e}",
              flush=True)
        if launched != want or (prec == "default" and not want["product"]):
            raise AssertionError(f"{prec} transition steps: launches "
                                 f"{launched} != {want}, and the bf16 "
                                 f"product must launch at 'default'")
        if not all(math.isfinite(x) for x in step_losses + gns):
            raise AssertionError(f"{prec} transition steps: loss "
                                 f"{step_losses}, grad_norm {gns}")
        prec_runs[prec] = dict(loss=step_losses[0], grad_norm=gns[0],
                               launched=launched)
    bf16_launches = {k: prec_runs["default"]["launched"][k]
                     for k in ("K1d", "K2d", "product")}
    d_prec = {k: abs(prec_runs["default"][k] - prec_runs["highest"][k])
              / abs(prec_runs["highest"][k]) for k in BF16_STEP_TOL}
    print("fused_cconv transition step, 'default' against 'highest' from "
          "the same weights, first step: diffs "
          + ", ".join(f"{k} {v:.3e}" for k, v in d_prec.items())
          + f" (relative; tolerance {BF16_STEP_TOL})", flush=True)
    if not all(0.0 < d_prec[k] <= tol for k, tol in BF16_STEP_TOL.items()):
        raise AssertionError(f"'default' against 'highest': {d_prec} not "
                             f"within (0, {BF16_STEP_TOL}]")
    reset_counts()

    # ---- 9. the transition train path on 'auto' (the JAX trainers' own
    # search backend): which search it runs, its first step against
    # `fused`'s from the same weights, then counted as in 8
    a_net, a_step, a_plan = transition_trainer("auto")
    routes = {"fluid": a_net.search_route(scene.N_PARTICLES),
              "box": a_net.search_route(box.shape[0], a_plan)}
    print(f"transition train path (auto): resolves to {routes} (fluid "
          f"{scene.N_PARTICLES} points; box {box.shape[0]} points, its grid "
          f"passed)", flush=True)
    if routes != AUTO_ROUTES:
        raise AssertionError(f"'auto' resolves to {routes}, not "
                             f"{AUTO_ROUTES}")
    first["auto"] = first_prediction(a_net, a_plan)
    before = counts()
    loss_a, aux_a = run_transition(a_step, a_plan)  # the warm-up step
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()}
    want = {k: TRANSITION_LAUNCHES["auto"].get(k, 0) for k in counters}
    if launched != want:
        raise AssertionError(f"auto warm-up step: launches {launched} != "
                             f"{want}")
    warm_t["auto"] = dict(loss=float(loss_a), aux=aux_a,
                          grads=grads_of(a_net))
    ref = warm_t["fused"]
    rel = {n: float((prm.grad - ref["grads"][n]).abs().max())
           / max(float(ref["grads"][n].abs().max()), 1e-30)
           for n, prm in a_net.named_parameters()}
    worst = max(rel, key=rel.get)
    gn = float(ref["aux"]["grad_norm"])
    d = {"loss": abs(float(loss_a) - ref["loss"]) / abs(ref["loss"]),
         "grad_norm": abs(float(aux_a["grad_norm"]) - gn) / gn,
         "leaf": rel[worst]}
    d_pos = float((first["auto"][0] - first["fused"][0]).abs().max())
    mism = int((first["auto"][1] != first["fused"][1]).sum())
    print("auto transition step against fused, first step from the same "
          "weights: diffs " + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
          + f" (loss, grad_norm relative; leaf to the leaf's own largest "
          f"entry, worst {worst}); pred_pos {d_pos:.3e}; neighbour counts "
          f"that differ {mism}; losses {float(loss_a):.6f} / "
          f"{ref['loss']:.6f}", flush=True)
    bad = {k: v for k, v in d.items() if not v <= AUTO_STEP_TOL[k]}
    if mism or bad or not d_pos <= BACKEND_TOL["pred_pos"]:
        raise AssertionError(f"auto disagrees with fused: {bad}, pred_pos "
                             f"{d_pos:.3e}, {mism} counts")
    launched = counted_transition("auto", a_step, a_plan)
    total_launches = {k: v + launched[k] for k, v in total_launches.items()}
    compare_transition("auto", "auto transition step rerun", (), {})
    compare_transition("auto", "auto transition step with plain K8",
                       ("K8",), LIST_STEP_TOL)

    # ---- 10. the fluid's neighbour lists at the bench point three ways:
    # the plain grid and brute-force searches ('auto' and 'brute') and K7
    r_s, k_s = a_net.radius, a_net.fluid_neighbor_k
    grid_s = a_net.make_grid(pos)
    searches = {
        "grid": lambda: ns.radius_search_grid(pos, grid_s, r_s, k_s,
                                              exclude_self=True)[0],
        "brute": lambda: ns.radius_search_brute(pos, pos, r_s, k_s,
                                                exclude_self=True),
        "K7": lambda: fq.ball_query_compact(pos, grid_s, r_s, k_s,
                                            exclude_self=True)[0]}
    before = counts()
    with torch.no_grad():
        lists = {name: fn() for name, fn in searches.items()}
    torch.cuda.synchronize()
    if counts()["K7"] != before["K7"] + 1:
        raise AssertionError("the search check's K7 call did not launch")
    if bool(grid_s.overflow):
        raise AssertionError("the bench point's fluid grid overflows")
    sets = {n: torch.sort(nl.idx, dim=-1).values for n, nl in lists.items()}
    for name in ("brute", "K7"):
        if not torch.equal(lists[name].count, lists["grid"].count):
            raise AssertionError(f"search check: {name} counts differ")
        if not torch.equal(sets[name], sets["grid"]):
            raise AssertionError(f"search check: {name} neighbour sets "
                                 f"differ")
    g_sq, b_sq = lists["grid"].sq_dists, lists["brute"].sq_dists
    nearest = all(bool(((sq[:, 1:] >= sq[:, :-1]) | ~m[:, 1:]).all())
                  for sq, m in ((g_sq, lists["grid"].mask),
                                (b_sq, lists["brute"].mask)))
    if not (torch.equal(g_sq, b_sq) and nearest):
        raise AssertionError("search check: grid and brute force are not "
                             "both in nearest order")
    print(f"search check, the fluid at the bench point (k {k_s}, exclude "
          f"self): counts and neighbour sets equal across grid, brute and "
          f"K7; grid and brute in nearest order (slots whose ids differ, "
          f"ties: {int((lists['grid'].idx != lists['brute'].idx).sum())}); "
          f"grid overflow False; largest count "
          f"{int(lists['grid'].count.max())}", flush=True)
    del lists, sets, g_sq, b_sq, grid_s

    # ---- 11. a scene written by the port's generator, loaded by its
    # BlenderDataset, and 1,024 of frame 0's rays rendered
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    scene_dir = tempfile.mkdtemp(prefix="chip_smoke_scene_", dir=build_dir)
    try:
        synthetic.generate_blender_scene(scene_dir, **SCENE_KW)
        dataset = BlenderDataset(scene_dir, img_wh=SCENE_KW["img_wh"],
                                 view_names=SCENE_KW["train_views"][:1],
                                 end_index=SCENE_KW["n_frames"])
    finally:
        shutil.rmtree(scene_dir)
    frame = dataset[0]
    pick = torch.randperm(frame["rays"].shape[1],
                          generator=torch.Generator().manual_seed(5))
    pick = pick[:RENDER_RAYS]
    rays_s = torch.from_numpy(frame["rays"][0])[pick].to(dev)
    pixels = torch.from_numpy(frame["rgb"][0])[pick].to(dev)
    particles_s = torch.from_numpy(frame["particles_pos"]).to(dev)
    ro_s = torch.from_numpy(frame["cw"][0][:, 3].copy()).to(dev)
    s_ren = RenderNet(device=dev, generator=torch.Generator().manual_seed(6))
    reset_counts()
    with torch.no_grad():
        out_s = s_ren(particles_s, ro_s, rays_s)
    launched = counts()
    total_launches = {k: v + launched[k] for k, v in total_launches.items()}
    want = {k: {"K3": 2, "K5": 2}.get(k, 0) for k in counters}
    if launched != want:
        raise AssertionError(f"scene render: launches {launched} != {want}")
    for key, v in out_s.items():
        if not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"scene render: non-finite {key}")
    mse = float(((out_s["rgb1"] - pixels) ** 2).mean())
    if not (mse == mse and mse < float("inf")) or bool(out_s["overflow"]):
        raise AssertionError(f"scene render: MSE {mse}, overflow "
                             f"{bool(out_s['overflow'])}")
    print(f"scene-to-render: {SCENE_KW['n_frames']} frames of "
          f"{particles_s.shape[0]} particles, {len(SCENE_KW['train_views'])}"
          f" views at {SCENE_KW['img_wh']} written and loaded; "
          f"{RENDER_RAYS} rays of frame 0, view 1, rendered (launches "
          f"{ {k: v for k, v in launched.items() if v} }); RGB MSE against "
          f"the pixels {mse:.6f} (random weights); samples with K neighbours "
          f"{int(out_s['mask_1'].sum())}", flush=True)

    # ---- 12. the trainers and evaluators behind their entry points, at
    # full width, on a synthetic scene written under build/
    launched = trainers_phase(torch, build_dir, counts, on_plain)
    total_launches = {k: v + launched[k] for k, v in total_launches.items()}

    # ---- 13. the renderer's options and its list path at the bench point
    launched, k8_calls = options_phase(
        torch, dev, (pos, vel, box, nrm, ro_v, rays_v, rgbs_v, serve_end),
        init_state, reset_counts, counts, on_plain, build_dir, dense_ref)
    total_launches = {k: v + launched[k] for k, v in total_launches.items()}
    # K8 at the list render's shapes: the adjoint of its coarse and fine
    # row gathers, (R S K, 3) into the particles
    with torch.no_grad():
        for i, (vals, plan) in enumerate(k8_calls):  # fine pass first
            check_k8(f"list render gradient {i}", vals, plan)
    del k8_calls

    # ---- 14. the sharded paths in a world of one over NCCL, and the host
    # tools
    launched = parallel_phase(
        torch, (pos, vel, box, nrm, ro_v, rays_v, rgbs_v, serve_end),
        init_state, reset_counts, counts, build_dir)
    total_launches = {k: v + launched[k] for k, v in total_launches.items()}

    # ---- 15. the reference-protocol run of the port's runner, cut (at the
    # runner's conv_precision, 'default': K1d and K2d)
    before_d = bf16_counts()
    launched = protocol_phase(torch, build_dir, counts)
    total_launches = {k: v + launched[k] for k, v in total_launches.items()}
    bf16_launches = {k: v + bf16_counts()[k] - before_d[k]
                     for k, v in bf16_launches.items()}

    # ---- 16. JAX's seed-10 initial weights, drawn by the trainers' code
    seed_phase(torch, counts)

    # ---- 17. summary lines. launches: each kernel's count over the counted
    # runs (the serving path once, the e2e train path TRAIN_STEPS times, the
    # transition train path TRANSITION_STEPS times on each backend, the
    # scene render once, the trainers phase, the options phase, the
    # parallel phase's sharded steps, the protocol phase); max_abs_err: the
    # largest over every call held against the plain version
    sources = {
        "K1": ("fused_cconv", "fused_cconv.cu",
               "neurofluid_tpu/ops/fused_cconv.py:622"),
        "K2": ("fused_cconv_bwd", "fused_cconv.cu",
               "neurofluid_tpu/ops/fused_cconv.py:698"),
        "K3": ("ball_features", "ball_features.cu",
               "neurofluid_tpu/ops/pallas_features.py:88"),
        "K4": ("ball_features_bwd", "ball_features.cu",
               "neurofluid_tpu/ops/pallas_features.py:183"),
        "K5": ("composite_weights", "composite.cu",
               "neurofluid_tpu/ops/pallas_kernels.py:28"),
        "K6": ("composite_weights_bwd", "composite.cu",
               "neurofluid_tpu/ops/pallas_kernels.py:51"),
        "K7": ("ball_query_compact", "fused_query.cu",
               "neurofluid_tpu/ops/fused_query.py:194"),
        "K8": ("segment_sum_accumulate", "segment_sum.cu",
               "neurofluid_tpu/ops/segment_ops.py:157")}
    includes = {"fused_cconv.cu": ("split_gemm.cuh", "async_copy.cuh"),
                "fused_cconv_bf16.cu": ("fused_cconv.cu", "split_gemm.cuh",
                                        "async_copy.cuh"),
                "ball_features.cu": ("ball_walk.cuh", "async_copy.cuh"),
                "fused_query.cu": ("ball_walk.cuh", "async_copy.cuh")}
    line = {"kernels": [
        {"name": f"{kid} {name}", "route": "cuda",
         "source": f"neurofluid_torch/csrc/{src}", "replaces": replaces,
         "launches": total_launches[kid], "max_abs_err": kernels[kid],
         "includes": [f"neurofluid_torch/csrc/{h}"
                      for h in includes.get(src, ())]}
        for kid, (name, src, replaces) in sources.items()]}
    # K1 and K2 at conv_precision 'default' (launches: phase 8's 'default'
    # steps and phase 15; errors of phases 3 and 5), and the bf16 product
    # inside them (launches counted by the library where it launches them;
    # its error over phase 2's five shapes)
    for kid, name, replaces in (
            ("K1d", "fused_cconv (conv_precision 'default', bf16)",
             "neurofluid_tpu/ops/fused_cconv.py:622"),
            ("K2d", "fused_cconv_bwd (conv_precision 'default', bf16)",
             "neurofluid_tpu/ops/fused_cconv.py:698")):
        line["kernels"].append({
            "name": f"{kid} {name}", "route": "cuda",
            "source": "neurofluid_torch/csrc/fused_cconv_bf16.cu",
            "replaces": replaces, "launches": bf16_launches[kid],
            "max_abs_err": kernels[kid],
            "includes": [f"neurofluid_torch/csrc/{h}"
                         for h in includes["fused_cconv_bf16.cu"]]})
    line["kernels"].append({
        "name": "split_gemm bf16 product (K1d/K2d contractions)",
        "route": "cuda", "source": "neurofluid_torch/csrc/split_gemm.cuh",
        "replaces": "neurofluid_tpu/ops/fused_cconv.py:509",
        "launches": bf16_launches["product"],
        "max_abs_err": product_bf16_err})
    line["kernels"].append({
        "name": "K9 dense_layer (the NeRF's wide layers)", "route": "cuda",
        "source": "neurofluid_torch/csrc/dense_layer.cu",
        "replaces": "none (the JAX package's dense layers are XLA's)",
        "launches": k9_main, "max_abs_err": dense_err,
        "includes": ["neurofluid_torch/csrc/split_gemm.cuh",
                     "neurofluid_torch/csrc/async_copy.cuh"]})
    line["kernels"].append({
        "name": "K10 encode (the render's feature encoding, and its "
                "backward)", "route": "cuda",
        "source": "neurofluid_torch/csrc/encode.cu",
        "replaces": "none (the JAX package's encoding is XLA's)",
        "launches": k10_main, "max_abs_err": kernels["K10"]})
    for k in line["kernels"]:
        if not k["launches"]:
            raise AssertionError(f"{k['name']}: no launch on its path")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
