// K1: fused continuous convolution, forward; K2: its backward.
//
// K1 replaces neurofluid_tpu/ops/fused_cconv.py `_fwd_kernel` (reached via
// `_run_fwd` from `fused_cconv`, called by every ContinuousConvLayer of a
// ParticleNet step). For each sorted query row:
//
//   out[q] = sum_{t, c} A[q, t, c] * W[t * Cin + c, :]
//   A[q, t, :] = sum over candidates p of the query's 9 column slabs with
//                d^2/r^2 <= 1 (and d > 0 when exclude_self) of
//                poly6(min(d^2/r^2, 2)) * tap_t(ball_to_cube(dp / r)) * f_p
//   cnt[q] = number of such candidates
//
// where tap_t is the trilinear weight of filter tap t (8 non-zero corners).
// K2 replaces `_bwd_kernel` (reached via `_run_bwd` from the custom VJP of
// `fused_cconv`). With ct the (Nq, Cout) cotangent of `out`,
// d_acc[q, t, :] = ct[q] W_t^T, and per in-radius pair (q, p) the windowed
// tap weights w_t:
//   dfeats[p] += sum_t w_t d_acc[q, t, :]
//   g_t        = <d_acc[q, t, :], f_p>, pushed through the geometry adjoint
//                (window, ball -> cube map, taps) into g_off; then
//                dc[p] += g_off / r and dq[q] -= g_off / r
//   dW[t]      = sum_q A[q, t, :]^T ct[q]
//
// Design for the H100. The TPU kernel keeps a (64 * T_g, Cin) tap-feature
// block of a whole 16-query group in VMEM and contracts it with W on the
// MXU in the same body. A Hopper block has 227 KB of shared memory, so the
// work is cut into a candidate walk and matrix products:
//
// * The walk (`walk_fwd_kernel`). A block owns `qb` queries of one group
//   and one (64, Cin) accumulator per query in shared memory; all blocks of
//   a group walk the group's 9 slabs, taken as one sequence, in tiles of 32
//   candidates (only the last tile of a walk is ragged). A slab is a
//   contiguous row range of the sorted positions and features, so tile
//   t + 1 is fetched by `cp.async` into the other half of a two-stage ring
//   while tile t is processed; a tile costs two block barriers and no
//   thread waits on a global load.
//     phase 1, one thread per (query, candidate): the in-radius test, the
//       window, the ball-to-cube map and the trilinear corners in corner /
//       fraction form, so a pair costs 8 taps, not 64. The squared distance
//       is computed without contraction (__fmul_rn/__fadd_rn) in the order
//       of the plain version, so the two agree on which pairs are in radius;
//     phase 2, one thread per (query, 4 channels): add the 8 weighted
//       features of every in-radius pair of the tile (the phase-1 ballot
//       mask, about one candidate in eight at the bench point) into its own
//       accumulator columns with 16-byte shared-memory accesses: no two
//       threads write the same word, no atomics.
//   Groups own disjoint ranges of sorted rows, so every output row is
//   written once by the block that owns its query.
// * The contractions with W. Where W does not fit a block's shared memory
//   (the wide layers: 1.5 MB at Cin 96, Cout 64) the walk owns no W: it
//   writes its accumulator rows to a scratch buffer (a chunk of query rows
//   at a time, so the scratch stays bounded) and `nf::split_gemm`
//   (split_gemm.cuh: 3xTF32 `wgmma` fed by TMA, f32-class accuracy)
//   computes out = rows W, d_acc = ct W^T and dW = rows^T ct in (128, 64)
//   tiles, W split once per call into K-major hi / lo scratch: W leaves L2
//   once per 128 query rows instead of once per 4- or 8-query block; the
//   fold and dW cut their k range into splits that fill the card, summed in
//   order. Where W fits (<= 64 KB: the input layers and the
//   3-channel output layer), it is staged once into the shared memory of a
//   block that then walks at least 64 query rows, and the fold (K1) or
//   d_acc (K2) stays in the walk kernel.
// * K2 walks twice. `walk_fwd_kernel` recomputes the accumulator rows for
//   dW (rows^T ct over fixed splits of the rows, the splits summed in
//   order: dW is bitwise repeatable). `walk_bwd_kernel` holds d_acc of its
//   queries in shared memory (copied from the scratch rows by `cp.async`,
//   or contracted from the staged W^T) and per tile:
//     phase 1 as in K1;
//     position gradient, whole warps: the tile's in-radius pairs are
//       numbered in (query, candidate) order from the ballot masks; a warp
//       takes one pair at a time with its lanes over the channels, forms
//       the 8 tap cotangents <d_acc[tap], f> and folds them across lanes
//       with 9 shuffles; then one thread per pair runs the hand-derived
//       geometry adjoint `pair_vjp`; then dq is summed per query and dc per
//       candidate in pair order (no shared atomics), dq stored once by the
//       block that owns the query, dc added with one global f32 atomic per
//       candidate and axis;
//     dfeats, one thread per (candidate in some query's radius, 4
//       channels): summed over the block's queries in registers, then one
//       global 16-byte f32 atomic.
//   Blocks of other groups add into the same dc and dfeats rows, so their
//   last bits vary from run to run; dW and dq do not.
// Shared memory and blocks per SM (qb and the block size are chosen by
// ops/fused_cconv.py `walk_config`: the qb that keeps the most queries
// resident on an SM, 256 threads). Forward: Cin 96, qb 8, 226 KB, one block
// per SM; Cin 64, qb 4, 85 KB, two blocks; the staged layers Cin 64 -> 3,
// qb 8 with W, 210 KB, one block, and Cin 4, a whole 16-query group, 84 KB,
// two blocks. Backward: Cin 96, qb 2, 77 KB, two blocks; Cin 64, qb 4,
// 89 KB, two blocks.
//
// Bound on the card: operations. The pair geometry (about 70 operations per
// in-radius pair) and the tap accumulation (16 * Cin per pair) run on the
// f32 pipes, the contractions (2 * 64 * Cin * Cout per query, three TF32
// passes each) on the tensor cores. What limits the kernels now is the
// products and the walk's skeleton, not its arithmetic: with no pair in
// radius at all (tile loads, barriers, distance tests, zeroing and writing
// the rows, the products) K1 still takes two thirds of its time on an
// H100; the tap accumulation is a quarter and the ball -> cube map under a
// tenth (tools/profile_torch_port.py --walk-phases). No block shape (1 to
// 16 queries, 128 to 512 threads) moved a walk by more than a tenth beyond
// the one chosen, and neither did the 16-byte phase 2 nor tiles that run
// across slab borders. On `wgmma` the products take a quarter of K1's
// time at the wide layers (conv1 0.19 of 0.76 ms on an H100, PERF.md),
// and the walk the rest. The scratch rows are traffic of this design, not
// bytes the function has to move, so the bound leaves them out.
//
// precision 'default' runs K1d and K2d, kernels of their own in
// fused_cconv_bf16.cu, which includes this file for the device helpers
// above the kernels (NF_CCONV_HELPERS_ONLY leaves the f32 kernels and
// entry points out of it).

#include <cuda_runtime.h>

#include "split_gemm.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kTile = 32;  // candidates per tile; one warp per query in phase 1
// W reads in flight per thread of the in-walk fold
constexpr int kFoldBatch = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-8f;
constexpr float kFourOverPi = 1.27323954473516f;
// dynamic shared memory a block may take on this card
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

// arctan on [-1, 1]: the odd minimax polynomial of the TPU kernel (_atan01)
__device__ __forceinline__ float atan01(float t) {
  const float u = t * t;
  float acc = 3.049968069371e-03f;
  acc = acc * u - 1.682744852802e-02f;
  acc = acc * u + 4.385559905435e-02f;
  acc = acc * u - 7.596809867133e-02f;
  acc = acc * u + 1.068142103287e-01f;
  acc = acc * u - 1.421319619692e-01f;
  acc = acc * u + 1.999371614268e-01f;
  acc = acc * u - 3.333312078100e-01f;
  acc = acc * u + 9.999999880828e-01f;
  return acc * t;
}

// volume-preserving unit ball -> unit cube (ball -> cylinder -> cube)
__device__ __forceinline__ void ball_to_cube(float x, float y, float z,
                                             float sq_norm, float& ux,
                                             float& uy, float& uz) {
  const bool degenerate = sq_norm < kEps * kEps;
  const float norm = sqrtf(degenerate ? 1.0f : sq_norm);
  const float rho2 = x * x + y * y;
  float cx, cy, cz;
  if (1.25f * z * z > rho2) {  // cap region -> end discs
    const float s = sqrtf(3.0f * norm / (norm + fabsf(z) + kEps));
    cx = x * s;
    cy = y * s;
    cz = sgn(z) * norm;
  } else {  // side band -> lateral surface
    const float s = norm / sqrtf(fmaxf(rho2, kEps * kEps));
    cx = x * s;
    cy = y * s;
    cz = 1.5f * z;
  }
  if (degenerate) cx = cy = cz = 0.0f;
  uz = cz;
  const float crho2 = cx * cx + cy * cy;
  if (crho2 < kEps * kEps) {
    ux = uy = 0.0f;
    return;
  }
  const float crho = sqrtf(crho2);
  if (fabsf(cx) >= fabsf(cy)) {  // inverse Shirley-Chiu, |x| >= |y| wedge
    const float safe_x = fabsf(cx) < kEps ? 1.0f : cx;
    ux = sgn(cx) * crho;
    uy = kFourOverPi * ux * atan01(fminf(fmaxf(cy / safe_x, -1.0f), 1.0f));
  } else {
    const float safe_y = fabsf(cy) < kEps ? 1.0f : cy;
    uy = sgn(cy) * crho;
    ux = kFourOverPi * uy * atan01(fminf(fmaxf(cx / safe_y, -1.0f), 1.0f));
  }
}

// trilinear corner (i0) and fraction on a k-tap axis, align_corners=True
__device__ __forceinline__ void axis_tap(float u, int k, int& i0, float& f) {
  const float km1 = static_cast<float>(k - 1);
  const float t = fminf(fmaxf((u * 0.5f + 0.5f) * km1, 0.0f), km1);
  i0 = min(max(static_cast<int>(floorf(t)), 0), k - 2);
  f = t - static_cast<float>(i0);
}
// the 9 candidate slabs of a group: neighbour column (dx, dy) over the
// group's z cells -1..+1, as first sorted row and length
__device__ __forceinline__ void group_slabs(int col, int zlo, int zhi,
                                            const int* __restrict__ pstarts,
                                            int d0, int d1, int d2,
                                            int* s_start, int* s_len) {
  const int i = threadIdx.x;
  if (i < 9) {
    const int nx = col / d1 + i / 3 - 1, ny = col % d1 + i % 3 - 1;
    const bool ok = nx >= 0 && nx < d0 && ny >= 0 && ny < d1;
    const int base = (nx * d1 + ny) * d2;
    const int z0 = max(zlo - 1, 0), z1 = min(zhi + 1, d2 - 1);
    s_start[i] = ok ? pstarts[base + z0] : 0;
    s_len[i] = ok ? pstarts[base + z1 + 1] - pstarts[base + z0] : 0;
  }
}

// the candidates of the 9 slabs taken as one sequence: their number, and
// the sorted row of candidate `flat` of it
__device__ __forceinline__ int count_candidates(const int* s_len) {
  int n = 0;
  for (int sl = 0; sl < 9; ++sl) n += s_len[sl];
  return n;
}

__device__ __forceinline__ int flat_row(int flat, const int* s_start,
                                        const int* s_len) {
  int sl = 0;
  for (; sl < 8; ++sl) {
    if (flat < s_len[sl]) break;
    flat -= s_len[sl];
  }
  return s_start[sl] + flat;
}

// rows[j] = sorted row of candidate j of tile t (tiles run across slab
// borders, so only the last tile of a walk is ragged)
__device__ __forceinline__ void tile_rows(int t, int total, const int* s_start,
                                          const int* s_len, int* rows) {
  const int j = threadIdx.x;
  if (j < kTile) {
    const int flat = t * kTile + j;
    rows[j] = flat < total ? flat_row(flat, s_start, s_len) : 0;
  }
}

// start the asynchronous copy of a tile's positions and features
__device__ __forceinline__ void fetch_tile(float* fe, float* cp,
                                           const float* __restrict__ feats,
                                           const float* __restrict__ cpos,
                                           const int* rows, int nc, int cin,
                                           bool fvec) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int i = tid; i < nc * 3; i += nthreads)
    nf::cp_async4(cp + i, cpos + static_cast<long>(rows[i / 3]) * 3 + i % 3,
                  true);
  if (fvec) {
    const int c4 = cin / 4;
    for (int i = tid; i < nc * c4; i += nthreads) {
      const int j = i / c4, k = i - j * c4;
      nf::cp_async16(fe + 4 * i,
                     feats + static_cast<long>(rows[j]) * cin + 4 * k);
    }
  } else {
    for (int i = tid; i < nc * cin; i += nthreads) {
      const int j = i / cin, k = i - j * cin;
      nf::cp_async4(fe + i, feats + static_cast<long>(rows[j]) * cin + k,
                    true);
    }
  }
}

// normalized offset of candidate j from query q and its squared length, in
// the plain version's order of operations
__device__ __forceinline__ void pair_offset(const float* cp, const float* qp,
                                            int q, int j, float inv_r,
                                            float& ox, float& oy, float& oz,
                                            float& d2n) {
  ox = __fmul_rn(__fsub_rn(cp[3 * j], qp[3 * q]), inv_r);
  oy = __fmul_rn(__fsub_rn(cp[3 * j + 1], qp[3 * q + 1]), inv_r);
  oz = __fmul_rn(__fsub_rn(cp[3 * j + 2], qp[3 * q + 2]), inv_r);
  d2n = __fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)),
                  __fmul_rn(oz, oz));
}

__device__ __forceinline__ void axpy4(float4& a, float w, const float4& f) {
  a.x += w * f.x;
  a.y += w * f.y;
  a.z += w * f.z;
  a.w += w * f.w;
}

// Phase 1 for pair p = q * kTile + j: the in-radius test and, for a pair in
// radius, its first tap pt[p] and the 8 windowed corner weights
// pw[8 * p + c] (corners z outer, x inner).
__device__ __forceinline__ bool pair_geometry(const float* cp, const float* qp,
                                              int q, int j, bool live,
                                              float inv_r, int exclude_self,
                                              int kz, int ky, int kx, int p,
                                              int* pt, float* pw) {
  if (!live) return false;
  float ox, oy, oz, d2n;
  pair_offset(cp, qp, q, j, inv_r, ox, oy, oz, d2n);
  const bool within = d2n <= 1.0f && (!exclude_self || d2n > 0.0f);
  if (within) {
    const float t = 1.0f - fminf(d2n, 2.0f);
    const float win = fminf(fmaxf(t * t * t, 0.0f), 1.0f);
    float ux, uy, uz;
    ball_to_cube(ox, oy, oz, d2n, ux, uy, uz);
    int ix, iy, iz;
    float fx, fy, fz;
    axis_tap(ux, kx, ix, fx);
    axis_tap(uy, ky, iy, fy);
    axis_tap(uz, kz, iz, fz);
    pt[p] = (iz * ky + iy) * kx + ix;
    const float wz[2] = {(1.0f - fz) * win, fz * win};
    const float wy[2] = {1.0f - fy, fy};
    const float wx[2] = {1.0f - fx, fx};
    float4* dst = reinterpret_cast<float4*>(pw + 8 * p);
    dst[0] = make_float4(wz[0] * wy[0] * wx[0], wz[0] * wy[0] * wx[1],
                         wz[0] * wy[1] * wx[0], wz[0] * wy[1] * wx[1]);
    dst[1] = make_float4(wz[1] * wy[0] * wx[0], wz[1] * wy[0] * wx[1],
                         wz[1] * wy[1] * wx[0], wz[1] * wy[1] * wx[1]);
  }
  return within;
}

#ifndef NF_CCONV_HELPERS_ONLY
// The forward walk. A block takes work items item = (group, y) in turn and
// in each the query rows b0 = lo + y * QB, lo + (y + ysplit) * QB, ... of
// the group's rows inside [row_lo, row_hi). FOLD: W is staged into shared
// memory once and out (Nq, Cout) = acc W is written; otherwise the
// accumulator rows go to out ((row_hi - row_lo), 64 * Cin), row - row_lo.
// cnt (absolute rows) may be null.
template <int QB, bool FOLD>
__global__ void __launch_bounds__(kMaxThreads) walk_fwd_kernel(
    const int* __restrict__ gcol, const int* __restrict__ gzlo,
    const int* __restrict__ gzhi, const int* __restrict__ gstart,
    const int* __restrict__ pstarts, const float* __restrict__ qpos,
    const float* __restrict__ cpos, const float* __restrict__ feats,
    const float* __restrict__ w, float* __restrict__ out,
    float* __restrict__ cnt, int n_items, int ysplit, int row_lo, int row_hi,
    int d0, int d1, int d2, int kz, int ky, int kx, int cin, int cout,
    float inv_r, int exclude_self) {
  constexpr int qb = QB;
  constexpr int pairs = QB * kTile;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_start[9], s_len[9], s_rows[3][kTile];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % 32;
  const int n_taps = kz * ky * kx;
  const int tap_len = n_taps * cin;
  float* wsm = smem;                                         // tap_len * cout
  float* acc = wsm + (FOLD ? tap_len * cout : 0);            // qb * tap_len
  float* fe = acc + qb * tap_len;                            // 2 * kTile * cin
  float* cp = fe + 2 * kTile * cin;                          // 2 * kTile * 3
  float* pw = cp + 2 * kTile * 3;                            // 8 * pairs
  int* pt = reinterpret_cast<int*>(pw + 8 * pairs);          // pairs
  float* qp = reinterpret_cast<float*>(pt + pairs);          // qb * 3
  int* qcnt = reinterpret_cast<int*>(qp + qb * 3);           // qb
  unsigned* qmask = reinterpret_cast<unsigned*>(qcnt + qb);  // qb
  float* red = reinterpret_cast<float*>(qmask + qb);         // nthreads * qb
  const bool cvec = cin % 4 == 0;
  const bool fvec = cvec && nf::aligned16(feats);
  const int sy = kx, sz = ky * kx;

  if (FOLD)
    for (int i = tid; i < tap_len * cout; i += nthreads) wsm[i] = w[i];
  const int ks_count = nthreads / cout;  // fold: k split across threads
  const int fo = tid % cout, fks = tid / cout;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int g = item / ysplit, y = item % ysplit;
    const int col = gcol[g];
    if (col >= d0 * d1) continue;  // empty tail group: owns no rows
    const int lo = max(gstart[g], row_lo), hi = min(gstart[g + 1], row_hi);
    if (lo >= hi) continue;
    __syncthreads();  // the last item's readers of the slabs are done
    group_slabs(col, gzlo[g], gzhi[g], pstarts, d0, d1, d2, s_start, s_len);
    __syncthreads();
    const int total = count_candidates(s_len);
    const int n_tiles = (total + kTile - 1) / kTile;

    // A group longer than group_size (only if the plan's overflow flag is
    // set) is still covered: its blocks stride over its rows.
    for (int b0 = lo + y * qb; b0 < hi; b0 += ysplit * qb) {
      const int nq = min(qb, hi - b0);
      for (int i = tid; i < qb * tap_len; i += nthreads) acc[i] = 0.0f;
      if (tid < qb * 3)
        qp[tid] = tid / 3 < nq ? qpos[static_cast<long>(b0) * 3 + tid] : 0.0f;
      if (tid < qb) qcnt[tid] = 0;
      tile_rows(0, total, s_start, s_len, s_rows[0]);
      tile_rows(1, total, s_start, s_len, s_rows[1]);
      __syncthreads();

      if (n_tiles > 0)
        fetch_tile(fe, cp, feats, cpos, s_rows[0], min(kTile, total), cin,
                   fvec);
      nf::cp_async_commit();
      for (int t = 0; t < n_tiles; ++t) {
        const int buf = t & 1;
        nf::cp_async_wait<0>();  // tile t has landed
        __syncthreads();  // ... for every thread; tile t - 1 is consumed
        tile_rows(t + 2, total, s_start, s_len, s_rows[(t + 2) % 3]);
        if (t + 1 < n_tiles)
          fetch_tile(fe + (buf ^ 1) * kTile * cin, cp + (buf ^ 1) * kTile * 3,
                     feats, cpos, s_rows[(t + 1) % 3],
                     min(kTile, total - (t + 1) * kTile), cin, fvec);
        nf::cp_async_commit();
        const int nc = min(kTile, total - t * kTile);
        const float* tcp = cp + buf * kTile * 3;
        const float* tfe = fe + buf * kTile * cin;

        // phase 1: a warp is the 32 candidates of one query
        for (int p = tid; p < pairs; p += nthreads) {
          const int q = p / kTile, j = p % kTile;
          const bool within =
              pair_geometry(tcp, qp, q, j, q < nq && j < nc, inv_r,
                            exclude_self, kz, ky, kx, p, pt, pw);
          const unsigned hits = __ballot_sync(kFull, within);
          if (lane == 0) {
            qcnt[q] += __popc(hits);
            qmask[q] = hits;
          }
        }
        __syncthreads();

        // phase 2: a thread owns accumulator columns acc[q, :, c..c + 3]
        // (one column where Cin is no multiple of 4). The 8 corners of a
        // pair are 8 different words: read all, then write all.
        if (cvec) {
          const int c4n = cin / 4;
          for (int item2 = tid; item2 < qb * c4n; item2 += nthreads) {
            const int q = item2 / c4n, c = (item2 - q * c4n) * 4;
            float* a = acc + q * tap_len + c;
            for (unsigned m = qmask[q]; m != 0; m &= m - 1) {
              const int j = __ffs(m) - 1;
              const int p = q * kTile + j;
              const float4 f =
                  *reinterpret_cast<const float4*>(tfe + j * cin + c);
              float* at = a + pt[p] * cin;
              const float4 w0 = *reinterpret_cast<const float4*>(pw + 8 * p);
              const float4 w1 =
                  *reinterpret_cast<const float4*>(pw + 8 * p + 4);
              float4* t0 = reinterpret_cast<float4*>(at);
              float4* t1 = reinterpret_cast<float4*>(at + cin);
              float4* t2 = reinterpret_cast<float4*>(at + sy * cin);
              float4* t3 = reinterpret_cast<float4*>(at + (sy + 1) * cin);
              float4* t4 = reinterpret_cast<float4*>(at + sz * cin);
              float4* t5 = reinterpret_cast<float4*>(at + (sz + 1) * cin);
              float4* t6 = reinterpret_cast<float4*>(at + (sz + sy) * cin);
              float4* t7 = reinterpret_cast<float4*>(at + (sz + sy + 1) * cin);
              float4 a0 = *t0, a1 = *t1, a2 = *t2, a3 = *t3;
              float4 a4 = *t4, a5 = *t5, a6 = *t6, a7 = *t7;
              axpy4(a0, w0.x, f);
              axpy4(a1, w0.y, f);
              axpy4(a2, w0.z, f);
              axpy4(a3, w0.w, f);
              axpy4(a4, w1.x, f);
              axpy4(a5, w1.y, f);
              axpy4(a6, w1.z, f);
              axpy4(a7, w1.w, f);
              *t0 = a0;
              *t1 = a1;
              *t2 = a2;
              *t3 = a3;
              *t4 = a4;
              *t5 = a5;
              *t6 = a6;
              *t7 = a7;
            }
          }
        } else {
          for (int item2 = tid; item2 < qb * cin; item2 += nthreads) {
            const int q = item2 / cin, c = item2 % cin;
            float* a = acc + q * tap_len + c;
            for (unsigned m = qmask[q]; m != 0; m &= m - 1) {
              const int j = __ffs(m) - 1;
              const int p = q * kTile + j;
              const float f = tfe[j * cin + c];
              float* at = a + pt[p] * cin;
              const float4 w0 = *reinterpret_cast<const float4*>(pw + 8 * p);
              const float4 w1 =
                  *reinterpret_cast<const float4*>(pw + 8 * p + 4);
              const float a0 = at[0], a1 = at[cin], a2 = at[sy * cin];
              const float a3 = at[(sy + 1) * cin], a4 = at[sz * cin];
              const float a5 = at[(sz + 1) * cin], a6 = at[(sz + sy) * cin];
              const float a7 = at[(sz + sy + 1) * cin];
              at[0] = a0 + w0.x * f;
              at[cin] = a1 + w0.y * f;
              at[sy * cin] = a2 + w0.z * f;
              at[(sy + 1) * cin] = a3 + w0.w * f;
              at[sz * cin] = a4 + w1.x * f;
              at[(sz + 1) * cin] = a5 + w1.y * f;
              at[(sz + sy) * cin] = a6 + w1.z * f;
              at[(sz + sy + 1) * cin] = a7 + w1.w * f;
            }
          }
        }
      }
      nf::cp_async_wait<0>();
      __syncthreads();

      if (FOLD) {
        // out[q, o] = sum_k acc[q, k] * W[k, o]; thread (o, ks) sums a
        // contiguous k range (a multiple of 4 long, so float4 reads stay
        // aligned), then the ks partial sums are added in order
        if (fks < ks_count) {
          float part[QB];
#pragma unroll
          for (int q = 0; q < QB; ++q) part[q] = 0.0f;
          const int chunk = ((tap_len + ks_count - 1) / ks_count + 3) & ~3;
          const int k_end = min(tap_len, (fks + 1) * chunk);
          int k = fks * chunk;
          for (; k + kFoldBatch <= k_end; k += kFoldBatch) {
            float wv[kFoldBatch];
#pragma unroll
            for (int u = 0; u < kFoldBatch; ++u)
              wv[u] = wsm[(k + u) * cout + fo];
#pragma unroll
            for (int u = 0; u < kFoldBatch; u += 4) {
#pragma unroll
              for (int q = 0; q < QB; ++q) {
                const float4 a = *reinterpret_cast<const float4*>(
                    acc + q * tap_len + k + u);
                part[q] += a.x * wv[u];
                part[q] += a.y * wv[u + 1];
                part[q] += a.z * wv[u + 2];
                part[q] += a.w * wv[u + 3];
              }
            }
          }
          for (; k < k_end; ++k) {
            const float wv = wsm[k * cout + fo];
#pragma unroll
            for (int q = 0; q < QB; ++q) part[q] += acc[q * tap_len + k] * wv;
          }
#pragma unroll
          for (int q = 0; q < QB; ++q)
            red[(fks * QB + q) * cout + fo] = part[q];
        }
        __syncthreads();
        for (int i = tid; i < nq * cout; i += nthreads) {
          const int q = i / cout, o = i % cout;
          float v = 0.0f;
          for (int ks = 0; ks < ks_count; ++ks)
            v += red[(ks * qb + q) * cout + o];
          out[static_cast<long>(b0 - row_lo + q) * cout + o] = v;
        }
      } else {
        float4* dst = reinterpret_cast<float4*>(
            out + static_cast<long>(b0 - row_lo) * tap_len);
        const float4* src = reinterpret_cast<const float4*>(acc);
        for (int i = tid; i < nq * tap_len / 4; i += nthreads) dst[i] = src[i];
      }
      if (cnt != nullptr && tid < nq)
        cnt[b0 + tid] = static_cast<float>(qcnt[tid]);
      __syncthreads();
    }
  }
}


#endif  // NF_CCONV_HELPERS_ONLY

// d atan01 / dt
__device__ __forceinline__ float atan01_grad(float t) {
  const float u = t * t;
  float acc = 17.0f * 3.049968069371e-03f;
  acc = acc * u - 15.0f * 1.682744852802e-02f;
  acc = acc * u + 13.0f * 4.385559905435e-02f;
  acc = acc * u - 11.0f * 7.596809867133e-02f;
  acc = acc * u + 9.0f * 1.068142103287e-01f;
  acc = acc * u - 7.0f * 1.421319619692e-01f;
  acc = acc * u + 5.0f * 1.999371614268e-01f;
  acc = acc * u - 3.0f * 3.333312078100e-01f;
  acc = acc * u + 9.999999880828e-01f;
  return acc;
}

// Adjoint of one pair's windowed tap weights: g8 (cotangent of the 8
// corner weights times the window, corners z outer, x inner) -> cotangent
// of the normalized offset (x, y, z). The forward is recomputed; the
// selected branch of every choice is differentiated, sign' = 0, a clamp
// passes the gradient inside its closed range, and a degenerate offset gets
// zero (ops/cconv.py `tap_weights_vjp`, the plain twin).
__device__ void pair_vjp(float x, float y, float z, float d2n, int kz, int ky,
                         int kx, const float* g8, float& gx, float& gy,
                         float& gz) {
  gx = gy = gz = 0.0f;
  if (d2n < kEps * kEps) return;
  // window on min(d2n, 2)
  const float tw = 1.0f - fminf(d2n, 2.0f);
  const float tw3 = tw * tw * tw;
  const float win = fminf(fmaxf(tw3, 0.0f), 1.0f);
  const float dwin =
      (tw3 >= 0.0f && tw3 <= 1.0f && d2n <= 2.0f) ? -3.0f * tw * tw : 0.0f;
  // ball -> cylinder
  const float norm = sqrtf(d2n);
  const float rho2 = x * x + y * y;
  const bool cap = 1.25f * z * z > rho2;
  const float den = norm + fabsf(z) + kEps;
  const float s_cap = sqrtf(3.0f * norm / den);
  const float m = sqrtf(fmaxf(rho2, kEps * kEps));
  const float s = cap ? s_cap : norm / m;
  const float cx = x * s, cy = y * s;
  const float cz = cap ? sgn(z) * norm : 1.5f * z;
  // cylinder -> cube; `lead` is the wedge's major-axis output
  const float crho2 = cx * cx + cy * cy;
  const bool cdeg = crho2 < kEps * kEps;
  const float crho = sqrtf(cdeg ? 1.0f : crho2);
  const bool x_ge = fabsf(cx) >= fabsf(cy);
  const float num = x_ge ? cy : cx, dnm = x_ge ? cx : cy;
  const bool small = fabsf(dnm) < kEps;
  const float safe = small ? 1.0f : dnm;
  const float ratio_raw = num / safe;
  const float ratio = fminf(fmaxf(ratio_raw, -1.0f), 1.0f);
  const float at = atan01(ratio);
  const float lead = sgn(dnm) * crho;
  const float other = kFourOverPi * lead * at;
  const float ux = cdeg ? 0.0f : (x_ge ? lead : other);
  const float uy = cdeg ? 0.0f : (x_ge ? other : lead);
  // trilinear taps
  int i0[3];
  float f[3], scale[3];
  bool inside[3];
  const float u3[3] = {ux, uy, cz};
  const int k3[3] = {kx, ky, kz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float km1 = static_cast<float>(k3[a] - 1);
    const float traw = (u3[a] * 0.5f + 0.5f) * km1;
    axis_tap(u3[a], k3[a], i0[a], f[a]);
    inside[a] = traw >= 0.0f && traw <= km1;
    scale[a] = 0.5f * km1;
  }
  // taps backward
  const float wz[2] = {1.0f - f[2], f[2]};
  const float wy[2] = {1.0f - f[1], f[1]};
  const float wx[2] = {1.0f - f[0], f[0]};
  float g_win = 0.0f, gfx = 0.0f, gfy = 0.0f, gfz = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dz = c >> 2, dy = (c >> 1) & 1, dx = c & 1;
    const float g = g8[c];
    g_win += g * wz[dz] * wy[dy] * wx[dx];
    const float gw = g * win;
    gfx += gw * wz[dz] * wy[dy] * (dx ? 1.0f : -1.0f);
    gfy += gw * wz[dz] * wx[dx] * (dy ? 1.0f : -1.0f);
    gfz += gw * wy[dy] * wx[dx] * (dz ? 1.0f : -1.0f);
  }
  const float gux = inside[0] ? gfx * scale[0] : 0.0f;
  const float guy = inside[1] ? gfy * scale[1] : 0.0f;
  const float gcz = inside[2] ? gfz * scale[2] : 0.0f;
  // cylinder -> cube backward
  float gcx = 0.0f, gcy = 0.0f;
  if (!cdeg) {
    const float g_lead_out = x_ge ? gux : guy;
    const float g_other = x_ge ? guy : gux;
    const float g_crho = (g_lead_out + g_other * kFourOverPi * at) * sgn(dnm);
    float g_ratio = g_other * kFourOverPi * lead * atan01_grad(ratio);
    if (!(ratio_raw >= -1.0f && ratio_raw <= 1.0f)) g_ratio = 0.0f;
    const float g_num = g_ratio / safe;
    const float g_dnm = small ? 0.0f : -g_ratio * ratio_raw / safe;
    gcx = (x_ge ? g_dnm : g_num) + g_crho * cx / crho;
    gcy = (x_ge ? g_num : g_dnm) + g_crho * cy / crho;
  }
  // ball -> cylinder backward
  const float g_s = gcx * x + gcy * y;
  gx = gcx * s;
  gy = gcy * s;
  float g_norm;
  if (cap) {
    const float g_v = g_s / (2.0f * s_cap);
    g_norm = gcz * sgn(z) + g_v * 3.0f / den * (1.0f - norm / den);
    gz = -g_v * 3.0f * norm / (den * den) * sgn(z);
  } else {
    const float g_m = rho2 >= kEps * kEps ? -g_s * norm / (m * m * m) : 0.0f;
    g_norm = g_s / m;
    gx += g_m * x;
    gy += g_m * y;
    gz = 1.5f * gcz;
  }
  const float g_r = g_norm / norm + 2.0f * g_win * dwin;
  gx += g_r * x;
  gy += g_r * y;
  gz += g_r * z;
}

// (query, candidate) of the tile's in-radius pair number i, pairs numbered
// query by query and, within a query, by candidate
template <int QB>
__device__ __forceinline__ void nth_pair(const unsigned* qmask, int i, int& q,
                                         int& j) {
  q = 0;
  while (q < QB - 1) {
    const int n = __popc(qmask[q]);
    if (i < n) break;
    i -= n;
    ++q;
  }
  j = __fns(qmask[q], 0, i + 1);
}

#ifndef NF_CCONV_HELPERS_ONLY
// The backward walk: dq, dc (both or neither) and dfeats of the query rows
// in [row_lo, row_hi), work items as in walk_fwd_kernel. LOCAL: W^T
// (cout, 64 * cin) is staged into shared memory once and d_acc = ct W^T is
// contracted per query block; otherwise d_acc rows are read from
// dacc_rows ((row_hi - row_lo), 64 * cin), row - row_lo.
template <int QB, bool LOCAL>
__global__ void __launch_bounds__(kMaxThreads) walk_bwd_kernel(
    const int* __restrict__ gcol, const int* __restrict__ gzlo,
    const int* __restrict__ gzhi, const int* __restrict__ gstart,
    const int* __restrict__ pstarts, const float* __restrict__ qpos,
    const float* __restrict__ cpos, const float* __restrict__ feats,
    const float* __restrict__ wt, const float* __restrict__ ct,
    const float* __restrict__ dacc_rows, float* __restrict__ dq,
    float* __restrict__ dc, float* __restrict__ df, int n_items, int ysplit,
    int row_lo, int row_hi, int d0, int d1, int d2, int kz, int ky, int kx,
    int cin, int cout, float inv_r, int exclude_self) {
  constexpr int qb = QB;
  constexpr int pairs = QB * kTile;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_start[9], s_len[9], s_rows[3][kTile];
  const bool need_pos = dq != nullptr;
  const bool need_f = df != nullptr;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, n_warps = nthreads / 32;
  const int n_taps = kz * ky * kx;
  const int tap_len = n_taps * cin;
  float* wts = smem;                                         // cout * tap_len
  float* dacc = wts + (LOCAL ? cout * tap_len : 0);          // qb * tap_len
  float* fe = dacc + qb * tap_len;                           // 2 * kTile * cin
  float* cp = fe + 2 * kTile * cin;                          // 2 * kTile * 3
  float* pw = cp + 2 * kTile * 3;                            // 8 * pairs
  float* g8s = pw + 8 * pairs;                               // 8 * pairs
  int* pt = reinterpret_cast<int*>(g8s + 8 * pairs);         // pairs
  float* qp = reinterpret_cast<float*>(pt + pairs);          // qb * 3
  float* sdq = qp + qb * 3;                                  // qb * 3
  unsigned* qmask = reinterpret_cast<unsigned*>(sdq + qb * 3);  // qb
  float* sct = reinterpret_cast<float*>(qmask + qb);         // qb * cout
  const bool cvec = cin % 4 == 0;
  const bool fvec = cvec && nf::aligned16(feats);
  const int sy = kx, sz = ky * kx;
  const int coff[8] = {0, 1, sy, sy + 1, sz, sz + 1, sz + sy, sz + sy + 1};

  if (LOCAL)
    for (int i = tid; i < cout * tap_len; i += nthreads) wts[i] = wt[i];

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int g = item / ysplit, y = item % ysplit;
    const int col = gcol[g];
    if (col >= d0 * d1) continue;  // empty tail group: owns no rows
    const int lo = max(gstart[g], row_lo), hi = min(gstart[g + 1], row_hi);
    if (lo >= hi) continue;
    __syncthreads();  // the last item's readers of the slabs are done
    group_slabs(col, gzlo[g], gzhi[g], pstarts, d0, d1, d2, s_start, s_len);
    __syncthreads();
    const int total = count_candidates(s_len);
    const int n_tiles = (total + kTile - 1) / kTile;

    for (int b0 = lo + y * qb; b0 < hi; b0 += ysplit * qb) {
      const int nq = min(qb, hi - b0);
      if (tid < qb * 3) {
        qp[tid] = tid / 3 < nq ? qpos[static_cast<long>(b0) * 3 + tid] : 0.0f;
        sdq[tid] = 0.0f;
      }
      if (LOCAL) {
        for (int i = tid; i < qb * cout; i += nthreads)
          sct[i] = i / cout < nq ? ct[static_cast<long>(b0) * cout + i] : 0.0f;
        __syncthreads();  // also after the staging of W^T
        // d_acc[q, k] = sum_o ct[q, o] W^T[o, k]
        for (int k = tid; k < tap_len; k += nthreads) {
          float part[QB];
#pragma unroll
          for (int q = 0; q < QB; ++q) part[q] = 0.0f;
          for (int o = 0; o < cout; ++o) {
            const float wv = wts[o * tap_len + k];
#pragma unroll
            for (int q = 0; q < QB; ++q) part[q] += sct[q * cout + o] * wv;
          }
#pragma unroll
          for (int q = 0; q < QB; ++q) dacc[q * tap_len + k] = part[q];
        }
      } else {
        const float* src =
            dacc_rows + static_cast<long>(b0 - row_lo) * tap_len;
        for (int i = tid; i < nq * tap_len / 4; i += nthreads)
          nf::cp_async16(dacc + 4 * i, src + 4 * i);
      }
      tile_rows(0, total, s_start, s_len, s_rows[0]);
      tile_rows(1, total, s_start, s_len, s_rows[1]);
      __syncthreads();

      if (n_tiles > 0)
        fetch_tile(fe, cp, feats, cpos, s_rows[0], min(kTile, total), cin,
                   fvec);
      nf::cp_async_commit();
      for (int t = 0; t < n_tiles; ++t) {
        const int buf = t & 1;
        nf::cp_async_wait<0>();  // tile t (and d_acc) has landed
        __syncthreads();  // ... for every thread; tile t - 1 is consumed
        tile_rows(t + 2, total, s_start, s_len, s_rows[(t + 2) % 3]);
        if (t + 1 < n_tiles)
          fetch_tile(fe + (buf ^ 1) * kTile * cin, cp + (buf ^ 1) * kTile * 3,
                     feats, cpos, s_rows[(t + 1) % 3],
                     min(kTile, total - (t + 1) * kTile), cin, fvec);
        nf::cp_async_commit();
        const int nc = min(kTile, total - t * kTile);
        const float* tcp = cp + buf * kTile * 3;
        const float* tfe = fe + buf * kTile * cin;
        const int* rows = s_rows[t % 3];

        // phase 1: pair geometry as in the forward walk
        for (int p = tid; p < pairs; p += nthreads) {
          const int q = p / kTile, j = p % kTile;
          const bool within =
              pair_geometry(tcp, qp, q, j, q < nq && j < nc, inv_r,
                            exclude_self, kz, ky, kx, p, pt, pw);
          const unsigned hits = __ballot_sync(kFull, within);
          if (lane == 0) qmask[q] = hits;
        }
        __syncthreads();

        int n_in = 0;
#pragma unroll
        for (int q = 0; q < QB; ++q) n_in += __popc(qmask[q]);

        if (need_pos) {
          // tap cotangents: a warp per in-radius pair, lanes over channels
          for (int i = warp; i < n_in; i += n_warps) {
            int q, j;
            nth_pair<QB>(qmask, i, q, j);
            const float* dr = dacc + q * tap_len + pt[q * kTile + j] * cin;
            const float* fr = tfe + j * cin;
            float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            for (int ch = lane; ch < cin; ch += 32) {
              const float f = fr[ch];
#pragma unroll
              for (int c = 0; c < 8; ++c) v[c] += dr[coff[c] * cin + ch] * f;
            }
            // fold the 8 sums across the warp: after the three halving
            // steps lane l holds corner (l >> 2) & 7 (bit 4 of the lane is
            // bit 2 of the corner), then two full steps finish the sum
            float a4[4], a2[2], a1;
            {
              const bool up = (lane & 16) != 0;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float send = up ? v[c] : v[c + 4];
                const float keep = up ? v[c + 4] : v[c];
                a4[c] = keep + __shfl_xor_sync(kFull, send, 16);
              }
            }
            {
              const bool up = (lane & 8) != 0;
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float send = up ? a4[c] : a4[c + 2];
                const float keep = up ? a4[c + 2] : a4[c];
                a2[c] = keep + __shfl_xor_sync(kFull, send, 8);
              }
            }
            {
              const bool up = (lane & 4) != 0;
              const float send = up ? a2[0] : a2[1];
              const float keep = up ? a2[1] : a2[0];
              a1 = keep + __shfl_xor_sync(kFull, send, 4);
            }
            a1 += __shfl_xor_sync(kFull, a1, 2);
            a1 += __shfl_xor_sync(kFull, a1, 1);
            if ((lane & 3) == 0) g8s[i * 8 + ((lane >> 2) & 7)] = a1;
          }
          __syncthreads();
          // the geometry adjoint: a thread per in-radius pair; its offset
          // cotangent over r replaces the pair's tap cotangents
          for (int i = tid; i < n_in; i += nthreads) {
            int q, j;
            nth_pair<QB>(qmask, i, q, j);
            float ox, oy, oz, d2n;
            pair_offset(tcp, qp, q, j, inv_r, ox, oy, oz, d2n);
            float g8[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) g8[c] = g8s[i * 8 + c];
            float gx, gy, gz;
            pair_vjp(ox, oy, oz, d2n, kz, ky, kx, g8, gx, gy, gz);
            g8s[i * 8] = gx * inv_r;
            g8s[i * 8 + 1] = gy * inv_r;
            g8s[i * 8 + 2] = gz * inv_r;
          }
        }

        // dfeats: thread (candidate, c) over the candidates some query of
        // the block has in radius, summed over those queries
        if (need_f) {
          unsigned some = 0;
          for (int q = 0; q < nq; ++q) some |= qmask[q];
          const int n_some = __popc(some);
          if (cvec && nf::aligned16(df)) {
            const int c4n = cin / 4;
            for (int item2 = tid; item2 < n_some * c4n; item2 += nthreads) {
              const int a = item2 / c4n, c = (item2 - a * c4n) * 4;
              const int j = __fns(some, 0, a + 1);
              float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              for (int q = 0; q < nq; ++q) {
                if (!((qmask[q] >> j) & 1u)) continue;
                const int p = q * kTile + j;
                const float* dr = dacc + q * tap_len + pt[p] * cin + c;
                const float4 w0 = *reinterpret_cast<const float4*>(pw + 8 * p);
                const float4 w1 =
                    *reinterpret_cast<const float4*>(pw + 8 * p + 4);
                axpy4(v, w0.x, *reinterpret_cast<const float4*>(dr));
                axpy4(v, w0.y, *reinterpret_cast<const float4*>(dr + cin));
                axpy4(v, w0.z, *reinterpret_cast<const float4*>(dr + sy * cin));
                axpy4(v, w0.w,
                      *reinterpret_cast<const float4*>(dr + (sy + 1) * cin));
                axpy4(v, w1.x, *reinterpret_cast<const float4*>(dr + sz * cin));
                axpy4(v, w1.y,
                      *reinterpret_cast<const float4*>(dr + (sz + 1) * cin));
                axpy4(v, w1.z,
                      *reinterpret_cast<const float4*>(dr + (sz + sy) * cin));
                axpy4(v, w1.w,
                      *reinterpret_cast<const float4*>(dr +
                                                       (sz + sy + 1) * cin));
              }
              atomicAdd(reinterpret_cast<float4*>(
                            df + static_cast<long>(rows[j]) * cin + c),
                        v);
            }
          } else {
            for (int item2 = tid; item2 < n_some * cin; item2 += nthreads) {
              const int a = item2 / cin, c = item2 - a * cin;
              const int j = __fns(some, 0, a + 1);
              float v = 0.0f;
              for (int q = 0; q < nq; ++q) {
                if (!((qmask[q] >> j) & 1u)) continue;
                const int p = q * kTile + j;
                const float* dr = dacc + q * tap_len + pt[p] * cin + c;
                const float4 w0 = *reinterpret_cast<const float4*>(pw + 8 * p);
                const float4 w1 =
                    *reinterpret_cast<const float4*>(pw + 8 * p + 4);
                v += w0.x * dr[0] + w0.y * dr[cin] + w0.z * dr[sy * cin] +
                     w0.w * dr[(sy + 1) * cin] + w1.x * dr[sz * cin] +
                     w1.y * dr[(sz + 1) * cin] + w1.z * dr[(sz + sy) * cin] +
                     w1.w * dr[(sz + sy + 1) * cin];
              }
              atomicAdd(&df[static_cast<long>(rows[j]) * cin + c], v);
            }
          }
        }

        if (need_pos) {
          __syncthreads();
          // dq per query and dc per candidate, each summed in pair order
          if (tid < qb * 3) {
            const int q = tid / 3, a = tid % 3;
            int base = 0;
            for (int s = 0; s < q; ++s) base += __popc(qmask[s]);
            const int n = __popc(qmask[q]);
            float v = 0.0f;
            for (int i = base; i < base + n; ++i) v += g8s[i * 8 + a];
            sdq[tid] -= v;
          } else if (tid >= 64 && tid < 64 + nc * 3) {
            const int j = (tid - 64) / 3, a = (tid - 64) % 3;
            int base = 0;
            float v = 0.0f;
            for (int q = 0; q < qb; ++q) {
              const unsigned m = qmask[q];
              if ((m >> j) & 1u)
                v += g8s[(base + __popc(m & ((1u << j) - 1u))) * 8 + a];
              base += __popc(m);
            }
            if (v != 0.0f)
              atomicAdd(&dc[static_cast<long>(rows[j]) * 3 + a], v);
          }
        }
      }
      nf::cp_async_wait<0>();
      __syncthreads();
      if (need_pos && tid < nq * 3)
        dq[static_cast<long>(b0) * 3 + tid] = sdq[tid];
      __syncthreads();
    }
  }
}

// dynamic shared memory of one block: the layouts at the top of the kernels
size_t fwd_smem_bytes(int qb, int threads, int n_taps, int cin, int cout,
                      bool fold) {
  const size_t q = qb, tap_len = static_cast<size_t>(n_taps) * cin;
  const size_t pairs = q * kTile;
  return sizeof(float) *
         ((fold ? tap_len * cout : 0) + q * tap_len + 2 * kTile * cin +
          2 * kTile * 3 + 8 * pairs + pairs + q * 3 + 2 * q +
          (fold ? static_cast<size_t>(threads) * q : 0));
}

size_t bwd_smem_bytes(int qb, int n_taps, int cin, int cout, bool local) {
  const size_t q = qb, tap_len = static_cast<size_t>(n_taps) * cin;
  const size_t pairs = q * kTile;
  return sizeof(float) *
         ((local ? tap_len * cout : 0) + q * tap_len + 2 * kTile * cin +
          2 * kTile * 3 + 16 * pairs + pairs + 6 * q + q +
          (local ? q * cout : 0));
}

#endif  // NF_CCONV_HELPERS_ONLY

// Blocks of a walk that stages W: each block reads W once, so at most one
// block per 64 query rows, and no more blocks than the card holds at once.
template <typename Kernel>
int staged_grid(Kernel kernel, int threads, size_t smem, int n_items,
                int n_rows) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const int grid = min(min(n_items, n_rows / 64), sms * per_sm);
  return max(grid, 1);
}

#ifndef NF_CCONV_HELPERS_ONLY
struct Walk {
  const int *gcol, *gzlo, *gzhi, *gstart, *pstarts;
  const float *qpos, *cpos, *feats;
  int n_groups, group_size, d0, d1, d2, kz, ky, kx, cin, cout;
  float inv_r;
  int exclude_self;
  cudaStream_t stream;
};

template <int QB, bool FOLD>
int launch_walk_fwd(const Walk& a, const float* w, float* out, float* cnt,
                    int threads, int row_lo, int row_hi) {
  const size_t smem =
      fwd_smem_bytes(QB, threads, a.kz * a.ky * a.kx, a.cin, a.cout, FOLD);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = walk_fwd_kernel<QB, FOLD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ysplit = (a.group_size + QB - 1) / QB;
  const int n_items = a.n_groups * ysplit;
  const int grid =
      FOLD ? staged_grid(kernel, threads, smem, n_items, row_hi - row_lo)
           : n_items;
  kernel<<<grid, threads, smem, a.stream>>>(
      a.gcol, a.gzlo, a.gzhi, a.gstart, a.pstarts, a.qpos, a.cpos, a.feats, w,
      out, cnt, n_items, ysplit, row_lo, row_hi, a.d0, a.d1, a.d2, a.kz, a.ky,
      a.kx, a.cin, a.cout, a.inv_r, a.exclude_self);
  return static_cast<int>(cudaGetLastError());
}

template <int QB, bool LOCAL>
int launch_walk_bwd(const Walk& a, const float* wt, const float* ct,
                    const float* dacc_rows, float* dq, float* dc, float* df,
                    int threads, int row_lo, int row_hi) {
  const size_t smem =
      bwd_smem_bytes(QB, a.kz * a.ky * a.kx, a.cin, a.cout, LOCAL);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = walk_bwd_kernel<QB, LOCAL>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ysplit = (a.group_size + QB - 1) / QB;
  const int n_items = a.n_groups * ysplit;
  const int grid =
      LOCAL ? staged_grid(kernel, threads, smem, n_items, row_hi - row_lo)
            : n_items;
  kernel<<<grid, threads, smem, a.stream>>>(
      a.gcol, a.gzlo, a.gzhi, a.gstart, a.pstarts, a.qpos, a.cpos, a.feats, wt,
      ct, dacc_rows, dq, dc, df, n_items, ysplit, row_lo, row_hi, a.d0, a.d1,
      a.d2, a.kz, a.ky, a.kx, a.cin, a.cout, a.inv_r, a.exclude_self);
  return static_cast<int>(cudaGetLastError());
}

// queries per block: a power of two up to 16, a template constant so that
// the per-query loops carry no predicated-off work
#define NF_DISPATCH_QB(qb, CALL)                       \
  switch (qb) {                                        \
    case 1: return CALL(1);                            \
    case 2: return CALL(2);                            \
    case 4: return CALL(4);                            \
    case 8: return CALL(8);                            \
    case 16: return CALL(16);                          \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

int walk_fwd(const Walk& a, bool fold, int qb, const float* w, float* out,
             float* cnt, int threads, int row_lo, int row_hi) {
  if (fold) {
#define NF_CALL(Q) \
  launch_walk_fwd<Q, true>(a, w, out, cnt, threads, row_lo, row_hi)
    NF_DISPATCH_QB(qb, NF_CALL)
#undef NF_CALL
  }
#define NF_CALL(Q) \
  launch_walk_fwd<Q, false>(a, w, out, cnt, threads, row_lo, row_hi)
  NF_DISPATCH_QB(qb, NF_CALL)
#undef NF_CALL
}

int walk_bwd(const Walk& a, bool local, int qb, const float* wt,
             const float* ct, const float* dacc_rows, float* dq, float* dc,
             float* df, int threads, int row_lo, int row_hi) {
  if (local) {
#define NF_CALL(Q)                                                        \
  launch_walk_bwd<Q, true>(a, wt, ct, dacc_rows, dq, dc, df, threads, row_lo, \
                           row_hi)
    NF_DISPATCH_QB(qb, NF_CALL)
#undef NF_CALL
  }
#define NF_CALL(Q)                                                         \
  launch_walk_bwd<Q, false>(a, wt, ct, dacc_rows, dq, dc, df, threads, row_lo, \
                            row_hi)
  NF_DISPATCH_QB(qb, NF_CALL)
#undef NF_CALL
}

bool bad_block(int threads, int least) {
  return threads % 32 != 0 || threads < least || threads > kMaxThreads;
}

#endif  // NF_CCONV_HELPERS_ONLY

}  // namespace

#ifndef NF_CCONV_HELPERS_ONLY
// K1. rows == null: W fits shared memory and the walk folds it itself.
// Otherwise the walk writes its accumulator rows to `rows` (chunk_rows,
// 64 * cin) one chunk of query rows at a time and the tensor-core product
// folds each chunk with W (bt: its B scratch), in k_splits splits of
// k_per_split terms written to part (k_splits, chunk_rows, cout) and
// summed in order when k_splits > 1. qb queries per block (1, 2, 4, 8 or
// 16), the block size and the splits come from ops/fused_cconv.py
// `walk_config` and `product_splits`.
extern "C" int nf_fused_cconv_fwd(
    const int* gcol, const int* gzlo, const int* gzhi, const int* gstart,
    const int* pstarts, const float* qpos, const float* cpos,
    const float* feats, const float* w, float* out, float* cnt, float* rows,
    float* bt, float* part, int n_groups, int group_size, int n_q,
    int chunk_rows, int k_splits, int k_per_split, int qb, int threads,
    int d0, int d1, int d2, int kz, int ky, int kx, int cin, int cout,
    float inv_r, int exclude_self, void* stream) {
  const bool fold = rows == nullptr;
  if (cout < 1 || cout > 256 || n_q < 1 || bad_block(threads, 32) ||
      (fold && threads < cout) ||
      (!fold && (chunk_rows < 1 || bt == nullptr || k_splits < 1 ||
                 (k_splits > 1 && part == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Walk a{gcol, gzlo, gzhi, gstart, pstarts, qpos, cpos, feats,
               n_groups, group_size, d0, d1, d2, kz, ky, kx, cin, cout,
               inv_r, exclude_self, st};
  if (fold) return walk_fwd(a, true, qb, w, out, cnt, threads, 0, n_q);
  const int klen = kz * ky * kx * cin;
  for (int lo = 0; lo < n_q; lo += chunk_rows) {
    const int hi = min(n_q, lo + chunk_rows);
    int err = walk_fwd(a, false, qb, w, rows, cnt, threads, lo, hi);
    if (err != 0) return err;
    float* out_lo = out + static_cast<long>(lo) * cout;
    err = nf::split_gemm(rows, w, k_splits > 1 ? part : out_lo, bt, hi - lo,
                         cout, klen, false, k_splits, k_per_split, st);
    if (err != 0) return err;
    if (k_splits == 1) continue;
    const int len = (hi - lo) * cout;
    nf::sum_splits_kernel<<<(len + 255) / 256, 256, 0, st>>>(part, out_lo,
                                                            k_splits, len);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

// K2. Null outputs are not computed: dw (with its scratch: part
// (n_chunks * splits_per_chunk, 64 * cin, cout)), dq/dc (positions; both or
// neither, each zeroed by the caller), df (features, zeroed by the caller).
// wt is W^T, (cout, 64 * cin). `local`: W^T fits shared memory and the
// backward walk contracts d_acc itself; otherwise d_acc = ct W^T is a
// tensor-core product into `scratch` (chunk_rows, 64 * cin), which then
// also takes the accumulator rows of the dW product, chunk by chunk. Split
// s of a chunk sums rows [s, s + 1) * rows_per_split of it (a multiple of
// 32); the splits of all chunks are added in order. bt is the products' B
// scratch (ops/fused_cconv.py `gemm_b_floats` of the larger B).
extern "C" int nf_fused_cconv_bwd(
    const int* gcol, const int* gzlo, const int* gzhi, const int* gstart,
    const int* pstarts, const float* qpos, const float* cpos,
    const float* feats, const float* wt, const float* ct, float* scratch,
    float* part, float* bt, float* dw, float* dq, float* dc, float* df,
    int n_groups, int group_size, int n_q, int chunk_rows, int splits_per_chunk,
    int rows_per_split, int local, int qb_fwd, int threads_fwd, int qb_bwd,
    int threads_bwd, int d0, int d1, int d2, int kz, int ky, int kx, int cin,
    int cout, float inv_r, int exclude_self, void* stream) {
  const bool need_w = dw != nullptr;
  const bool need_dacc = dq != nullptr || df != nullptr;
  if (cout < 1 || n_q < 1 || chunk_rows < 1 ||
      (dq == nullptr) != (dc == nullptr) ||
      ((need_w || (need_dacc && !local)) && bt == nullptr) ||
      (need_w && (part == nullptr || scratch == nullptr ||
                  bad_block(threads_fwd, 32) || splits_per_chunk < 1 ||
                  rows_per_split % 32 != 0 ||
                  static_cast<long>(splits_per_chunk) * rows_per_split <
                      min(chunk_rows, n_q))) ||
      (need_dacc && (bad_block(threads_bwd, 160) ||
                     (!local && scratch == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Walk a{gcol, gzlo, gzhi, gstart, pstarts, qpos, cpos, feats,
               n_groups, group_size, d0, d1, d2, kz, ky, kx, cin, cout,
               inv_r, exclude_self, st};
  const int klen = kz * ky * kx * cin;
  const long len = static_cast<long>(klen) * cout;
  int n_chunks = 0;
  for (int lo = 0; lo < n_q; lo += chunk_rows, ++n_chunks) {
    const int hi = min(n_q, lo + chunk_rows);
    const float* ct_lo = ct + static_cast<long>(lo) * cout;
    int err = 0;
    if (need_dacc) {
      if (!local)
        err = nf::split_gemm(ct_lo, wt, scratch, bt, hi - lo, klen, cout,
                             false, 1, 0, st);
      if (err != 0) return err;
      err = walk_bwd(a, local != 0, qb_bwd, wt, ct, scratch, dq, dc, df,
                     threads_bwd, lo, hi);
      if (err != 0) return err;
    }
    if (need_w) {
      err = walk_fwd(a, false, qb_fwd, nullptr, scratch, nullptr, threads_fwd,
                     lo, hi);
      if (err != 0) return err;
      err = nf::split_gemm(scratch, ct_lo,
                           part + n_chunks * splits_per_chunk * len, bt, klen,
                           cout, hi - lo, true, splits_per_chunk,
                           rows_per_split, st);
      if (err != 0) return err;
    }
  }
  if (!need_w) return 0;
  nf::sum_splits_kernel<<<static_cast<int>((len + 255) / 256), 256, 0, st>>>(
      part, dw, n_chunks * splits_per_chunk, static_cast<int>(len));
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core product on its own: c (m, n) = a b with a (m, k), or
// (k, m) when trans_a, and b (k, n), all row-major f32; bt is its B scratch
// (ops/fused_cconv.py `gemm_b_floats(k, n)`). With n_split > 1 the k range
// is cut into splits of k_per_split (a multiple of 32) whose products go to
// part (n_split, m, n) and are summed in order into c.
extern "C" int nf_split_gemm(const float* a, const float* b, float* c,
                             float* part, float* bt, int m, int n, int k,
                             int trans_a, int n_split, int k_per_split,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 0 || n_split < 1 ||
      (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_split == 1)
    return nf::split_gemm(a, b, c, bt, m, n, k, trans_a != 0, 1, 0, st);
  const int err = nf::split_gemm(a, b, part, bt, m, n, k, trans_a != 0,
                                 n_split, k_per_split, st);
  if (err != 0) return err;
  const int len = m * n;
  nf::sum_splits_kernel<<<(len + 255) / 256, 256, 0, st>>>(part, c, n_split,
                                                          len);
  return static_cast<int>(cudaGetLastError());
}

// Tensor-core products launched so far in this process by this library
// (in K1, K2 and nf_split_gemm), counted where each launch is accepted:
// bf16 != 0 the bf16 mode's (none here), else the TF32 mode's.
extern "C" long long nf_product_launches(int bf16) {
  return nf::product_launches()[bf16 != 0 ? 1 : 0];
}
#endif  // NF_CCONV_HELPERS_ONLY
