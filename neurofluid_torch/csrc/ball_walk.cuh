// The staged ball walk shared by K3 (ball_features.cu `ball_sums_kernel`),
// K4 (ball_features.cu `ball_sums_bwd_kernel`) and K7 (fused_query.cu
// `ball_query_compact_kernel`).
//
// The kernels take the queries of one packed group (one cell, `t` slots),
// walk the 27 cell-table rows around that cell in selection order
// o -> (o/9 - 1, (o/3)%3 - 1, o%3 - 1), slots in order, keep the first k
// in-radius particles by a warp ballot and write per-slot results (K3, K7)
// or per-candidate gradients (K4). One block owns one group:
//
// 1. `plan_group`: warp 0 lists the live slots (query below the sentinel
//    and, for K4, a cotangent that is not zero: the kernel's `Admit`)
//    first and the padded ones after them, with the live queries'
//    coordinates and the kernel's own per-slot state; every warp
//    meanwhile finds the occupied extent of its rows (one ballot per 32
//    slots); warp 0 then scans the 27 extents into the start of each row
//    in one flattened candidate list. The group's rows leave L2 once, not
//    once per query.
// 2. `for_each_batch`: the flattened list is copied into shared memory by
//    `cp.async` as structure-of-arrays (x, y, z and, for K4 and K7, the
//    particle id), in batches of at most `stage` candidates. A plan with
//    one stage holds all 27 rows at their full width (stage >= 27 cap), so
//    there is one batch; a larger cap takes two stages as a ring, batch b + 1
//    arriving while the warps walk batch b. The selection order carries
//    across batches because each live slot's running count is kept in
//    shared memory. Plain 4-byte `cp.async`, not TMA: a row's occupied
//    prefix is ragged, short (tens of particles) and starts anywhere.
// 3. The kernel's walk: the block's warps take the live slots in turn and
//    walk each batch 32 candidates at a time out of shared memory, one loop
//    with no per-row exit test. Padded slots and groups of the sentinel
//    cell never stage or walk: they only write their outputs.
//
// Table rows are filled as a prefix (`build_cell_grid`), so the extent is
// the occupied count; an empty slot inside it would hold the 1e9 sentinel
// and fail every radius test anyway.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace nf {
namespace ball {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 27;
constexpr float kEmpty = 5e8f;     // table slots at or above hold 1e9
constexpr size_t kSmemLimit = 232448;  // a block's shared memory on sm_90
constexpr int kMaxThreads = 256;   // the largest block a plan may ask for

// What every thread of a group's block knows after `plan_group`.
struct Group {
  long base[kRows];       // table offset (row * cap) of each row, in order
  int extent[kRows];      // occupied extent of each row
  int scan[kRows + 1];    // start of each row in the flattened list
  int n_live;             // live slots, listed first in `order`
};

// Dynamic shared memory of a staged walk: `n_stages` stages of `stage`
// candidates in `arrays` arrays, then `acc` arrays of `stage` words that
// the kernel keeps per staged candidate (K4's gradient, one copy whatever
// the stages), then per slot its query (3 words), its place in `order`,
// its running count and `state` words of the kernel's own. Mirrored by
// ops/ball_features.walk_smem_bytes.
inline size_t smem_bytes(int stage, int n_stages, int arrays, int acc, int t,
                         int state) {
  return 4 * (static_cast<size_t>(n_stages) * stage * arrays +
              static_cast<size_t>(stage) * acc +
              static_cast<size_t>(t) * (5 + state));
}

// The launch a plan asks for is possible: whole warps, a stage that holds
// every row of a one-stage plan, and the shared memory of one block.
inline bool plan_ok(int threads, int stage, int n_stages, int cap,
                    size_t bytes) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         stage >= 1 && (n_stages == 2 || (n_stages == 1 &&
                                          stage >= kRows * cap)) &&
         bytes + sizeof(Group) <= kSmemLimit;
}

// p[0, n) = v by threads `tid` of `nt`: 16-byte stores between a scalar
// head (up to the first 16-byte boundary) and a scalar tail.
__device__ __forceinline__ void fill(int* p, long n, int v, int tid, int nt) {
  const long head =
      min(static_cast<long>((16 - (reinterpret_cast<uintptr_t>(p) & 15u)) /
                            4 & 3),
          n);
  if (tid < head) p[tid] = v;
  int4* body = reinterpret_cast<int4*>(p + head);
  const long n4 = (n - head) / 4;
  for (long i = tid; i < n4; i += nt) body[i] = make_int4(v, v, v, v);
  for (long i = head + 4 * n4 + tid; i < n; i += nt) p[i] = v;
}

// Which slots with a query below the sentinel are live, and the state a
// kernel keeps per live slot: keep(s) is asked by lane s % 32 of warp 0
// for every slot s < t, place(at) then by the lane of each live slot, `at`
// its place in `order`. The default: every such slot, nothing kept.
struct EveryQuery {
  __device__ __forceinline__ bool keep(int) { return true; }
  __device__ __forceinline__ void place(int) {}
};

// Step 1, by every thread of the block; ends in a barrier. q: the packed
// queries of this group (t x 3); order: live slots first, then padded ones
// (from the back); sq: the live slots' queries, by place in `order`.
template <class Admit = EveryQuery>
__device__ __forceinline__ void plan_group(Group& g, const float* q, int t,
                                           int c, int d0, int d1, int d2,
                                           int cap, const float* tx,
                                           int* order, float* sq,
                                           Admit admit = Admit()) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const unsigned below = kFull >> (31 - lane) >> 1;  // lanes before mine
  if (warp == 0) {
    int n = 0;  // live slots listed so far
    for (int b = 0; b < t; b += 32) {
      const int s = b + lane;
      const float x = s < t ? q[3 * s] : 1e9f;
      const bool admitted = s < t && admit.keep(s);  // loads beside q's
      const bool live = x < kEmpty && admitted;
      const unsigned m = __ballot_sync(kFull, live);
      if (live) {
        const int at = n + __popc(m & below);
        order[at] = s;
        sq[3 * at] = x;
        sq[3 * at + 1] = q[3 * s + 1];
        sq[3 * at + 2] = q[3 * s + 2];
        admit.place(at);
      } else if (s < t) {
        order[t - 1 - (b - n) - __popc(~m & below)] = s;
      }
      n += __popc(m);
    }
    if (lane == 0) g.n_live = n;
  }
  const int cz = c % d2, cy = (c / d2) % d1, cx = c / (d1 * d2);
  for (int o = warp; o < kRows; o += warps) {
    const int ox = o / 9 - 1, oy = (o / 3) % 3 - 1, oz = o % 3 - 1;
    int end = 0;
    long base = 0;
    if (cx + ox >= 0 && cx + ox < d0 && cy + oy >= 0 && cy + oy < d1 &&
        cz + oz >= 0 && cz + oz < d2) {
      base = static_cast<long>(c + ox * d1 * d2 + oy * d2 + oz) * cap;
#pragma unroll 4
      for (int b = 0; b < cap; b += 32) {
        const int j = b + lane;
        const unsigned m =
            __ballot_sync(kFull, j < cap && tx[base + j] < kEmpty);
        if (m != 0u) end = b + 32 - __clz(m);
      }
    }
    if (lane == 0) {
      g.base[o] = base;
      g.extent[o] = end;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int v = lane < kRows ? g.extent[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += u;
    }
    if (lane < kRows) g.scan[lane + 1] = v;
    if (lane == 0) g.scan[0] = 0;
  }
  __syncthreads();
}

// Copies flattened candidates [lo, hi) into buf (array a at buf + a *
// stage) by `cp.async`; each warp takes whole rows.
template <int kArrays>
__device__ __forceinline__ void stage_batch(const Group& g,
                                            const float* const (&tab)[kArrays],
                                            float* buf, int stage, int lo,
                                            int hi) {
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int o = threadIdx.x / 32; o < kRows; o += warps) {
    const int a0 = max(g.scan[o], lo), a1 = min(g.scan[o + 1], hi);
    const long src = g.base[o] - g.scan[o];
    for (int j = a0 + lane; j < a1; j += 32) {
#pragma unroll
      for (int a = 0; a < kArrays; ++a)
        cp_async4(buf + a * stage + (j - lo), tab[a] + src + j, true);
    }
  }
}

// Step 2, by every thread of the block: visit(buf, n) once per batch, in
// order, when the batch's n candidates have landed in buf (array a at
// buf + a * stage). No batch at all when every row is empty. Shared memory
// written before the call is seen by every visit and after the call: a
// barrier precedes each visit and ends the call, batch or none.
template <int kArrays, class Visit>
__device__ __forceinline__ void for_each_batch(
    const Group& g, const float* const (&tab)[kArrays], float* stages,
    int stage, Visit&& visit) {
  const int total = g.scan[kRows];
  const int n_batches = (total + stage - 1) / stage;
  const int span = stage * kArrays;
  if (n_batches > 0) stage_batch(g, tab, stages, stage, 0, min(stage, total));
  cp_async_commit();
  for (int b = 0; b < n_batches; ++b) {
    if (b + 1 < n_batches) {  // only a two-stage plan gets here
      stage_batch(g, tab, stages + ((b + 1) & 1) * span, stage,
                  (b + 1) * stage, min((b + 2) * stage, total));
      cp_async_commit();
      cp_async_wait<1>();  // batch b has landed, b + 1 is on its way
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    visit(static_cast<const float*>(stages + (b & 1) * span),
          min(stage, total - b * stage));
    __syncthreads();  // batch b is read before batch b + 2 lands on it
  }
  if (n_batches == 0) __syncthreads();
}

// The squared distance, uncontracted and in the plain versions' order
// (dx*dx + dy*dy + dz*dz), so that a particle on the radius shell is
// decided the same way in both.
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

}  // namespace ball
}  // namespace nf
