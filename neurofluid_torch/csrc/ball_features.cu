// K3: ball-query feature sums of the particle renderer; K4: their backward.
//
// Replaces neurofluid_tpu/ops/pallas_features.py `_fwd_kernel` (reached via
// `forward` from ops/ball_features._forward). For each packed query slot:
// walk the 27 table rows around the slot's group cell in selection order,
// test every occupied slot against the strict radius, keep the first k
// in-radius particles (rows in order, slots in order) and reduce the 13 sums.
//
// The TPU kernel ranks the in-radius slots of a row with a bf16 triangular
// matmul on the MXU. Here (`ball_sums_kernel`) one block owns one group of
// up to 32 queries of one cell and runs the staged walk of ball_walk.cuh:
// the group's 27 rows leave L2 once per group, into one flattened
// candidate list in shared memory that each of its queries walks; only the
// live slots walk (a padded slot, its query at the 1e9 sentinel, writes
// zeros). A warp walks a slot's list 32 candidates per step: a
// ballot of the in-radius lanes plus __popc of the lanes at or below gives
// exact integer ranks, and the running budget is one integer kept uniform
// across the warp; each lane keeps its 13 partial sums in registers until
// one warp reduction per batch, added per slot in shared memory.
//
// Bound on the card: bytes at the bench point (each occupied slot of the
// groups' rows read once, the queries and the sums), though the walk
// itself is operations: every live query tests every occupied slot of its
// 27 rows (about nine operations each). The squared distance is computed
// without contraction (__fmul_rn/__fadd_rn), in the order of the plain
// version, so both versions select the same particles.
//
// K4 (nf_ball_sums_bwd) replaces pallas_features.py `_bwd_kernel` (reached
// via `backward` from the custom VJP of ball_features.ball_feature_sums).
// It re-walks each slot (`walk`, one warp per slot, rows from L2) and
// selects the forward's set: both walks take the first k by (row, slot)
// with the same rounding of the distance. For every selected neighbour c
// of a query q with cotangent g of the 13 sums it adds
//   (g3 + g4 cx + g5 cy + g6 cz) dw/dc + w (g4, g5, g6)
//   + [d > 0] ((g7, g8, g9) + 2 (g10 dx, g11 dy, g12 dz))
// with w = max(1 - (d/r)^3, 0), d = sqrt(max(d^2, 1e-24)) and
// dw/dc = -3 (d/r)^2 / (r d) (dx, dy, dz) where both clamps pass, into
// d_points[table_idx[row, slot]] with f32 atomics (their order varies from
// run to run). The count columns 0-2 carry no gradient. The TPU kernel
// emitted per-group table cotangents (NG, 27, cap, 3) that XLA then summed
// per cell, shifted and mapped to particles; the scatter by the table's
// slot -> particle map does all of that at once. Bound: operations, about
// nine per candidate test of every walked query, plus ~40 operations and 3
// atomics per selected neighbour.

#include <cuda_runtime.h>

#include "ball_walk.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kSums = 13;
constexpr float kEmpty = 5e8f;  // slots at or above hold the 1e9 sentinel

// K4's selection walk of one query: the 27 table rows around cell c in
// selection order, 32 slots per step, ranks from a ballot.
// Calls visit(slot index in the tables, rx, ry, rz, dx, dy, dz, d^2,
// selected) on the lane of every in-radius occupied slot.
template <class Visit>
__device__ __forceinline__ void walk(const float* __restrict__ tx,
                                     const float* __restrict__ ty,
                                     const float* __restrict__ tz, int c,
                                     float qx, float qy, float qz, int d0,
                                     int d1, int d2, int cap, float r2, int k,
                                     int lane, Visit&& visit) {
  const int cz = c % d2, cy = (c / d2) % d1, cx = c / (d1 * d2);
  const unsigned below_or_me = kFull >> (31 - lane);
  int off = 0;  // in-radius particles met so far (uniform in the warp)
  for (int o = 0; o < 27; ++o) {
    const int ox = o / 9 - 1, oy = (o / 3) % 3 - 1, oz = o % 3 - 1;
    if (cx + ox < 0 || cx + ox >= d0 || cy + oy < 0 || cy + oy >= d1 ||
        cz + oz < 0 || cz + oz >= d2)
      continue;
    const long row = static_cast<long>(c + ox * d1 * d2 + oy * d2 + oz) * cap;
    for (int base = 0; base < cap; base += 32) {
      const int j = base + lane;
      const float rx = j < cap ? tx[row + j] : 1e9f;
      const bool occupied = rx < kEmpty;
      if (!__any_sync(kFull, occupied)) break;
      const float ry = occupied ? ty[row + j] : 0.0f;
      const float rz = occupied ? tz[row + j] : 0.0f;
      const float dx = __fsub_rn(rx, qx);
      const float dy = __fsub_rn(ry, qy);
      const float dz = __fsub_rn(rz, qz);
      const float d2s = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const bool within = occupied && d2s < r2;
      const unsigned mask = __ballot_sync(kFull, within);
      const int rank = off + __popc(mask & below_or_me);
      off += __popc(mask);
      if (within) visit(row + j, rx, ry, rz, dx, dy, dz, d2s, rank <= k);
    }
  }
}

// K3: one block per group of `t` packed slots (see ball_walk.cuh).
__global__ void ball_sums_kernel(const float* __restrict__ q,
                                 const float* __restrict__ tx,
                                 const float* __restrict__ ty,
                                 const float* __restrict__ tz,
                                 const int* __restrict__ gcell,
                                 float* __restrict__ out, int t, int d0,
                                 int d1, int d2, int cap, float r2,
                                 float radius, int k, int stage,
                                 int n_stages) {
  namespace b = nf::ball;
  extern __shared__ __align__(16) float smem[];
  __shared__ b::Group g;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const long slot0 = static_cast<long>(blockIdx.x) * t;
  float* out_g = out + slot0 * kSums;
  const int c = gcell[blockIdx.x];
  if (c >= d0 * d1 * d2) {  // a group of the sentinel cell: all zeros
    b::fill(reinterpret_cast<int*>(out_g), static_cast<long>(t) * kSums, 0,
            threadIdx.x, blockDim.x);
    return;
  }
  float* sq = smem + n_stages * stage * 3;
  int* order = reinterpret_cast<int*>(sq + 3 * t);
  int* budget = order + t;  // in-radius particles met so far, per live slot
  float* acc = reinterpret_cast<float*>(budget + t);  // (live, kSums)
  b::plan_group(g, q + 3 * slot0, t, c, d0, d1, d2, cap, tx, order, sq);
  const int n_live = g.n_live;
  for (int i = n_live + warp; i < t; i += warps)  // padded slots: zeros
    if (lane < kSums) out_g[order[i] * kSums + lane] = 0.0f;
  for (int i = threadIdx.x; i < n_live * kSums; i += blockDim.x) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < n_live; i += blockDim.x) budget[i] = 0;

  const unsigned below_or_me = kFull >> (31 - lane);
  const float* const tab[3] = {tx, ty, tz};
  b::for_each_batch(g, tab, smem, stage, [&](const float* buf, int n) {
    const float* bx = buf;
    const float* by = buf + stage;
    const float* bz = buf + 2 * stage;
    for (int i = warp; i < n_live; i += warps) {
      const float qx = sq[3 * i], qy = sq[3 * i + 1], qz = sq[3 * i + 2];
      int off = budget[i];
      float s[kSums];
#pragma unroll
      for (int e = 0; e < kSums; ++e) s[e] = 0.0f;
      for (int base = 0; base < n; base += 32) {
        const int j = base + lane;
        const bool in = j < n;
        const float rx = in ? bx[j] : 1e9f;
        const float ry = in ? by[j] : 0.0f;
        const float rz = in ? bz[j] : 0.0f;
        const float dx = __fsub_rn(rx, qx);
        const float dy = __fsub_rn(ry, qy);
        const float dz = __fsub_rn(rz, qz);
        const float d2s = b::dist2(dx, dy, dz);
        const bool within = in && d2s < r2;
        const unsigned mask = __ballot_sync(kFull, within);
        const int rank = off + __popc(mask & below_or_me);
        off += __popc(mask);
        if (!within) continue;
        s[0] += 1.0f;
        if (rank > k) continue;
        const float u = sqrtf(fmaxf(d2s, 1e-24f)) / radius;
        const float w = fmaxf(1.0f - u * u * u, 0.0f);
        s[1] += 1.0f;
        s[3] += w;
        s[4] += w * rx;
        s[5] += w * ry;
        s[6] += w * rz;
        if (d2s > 0.0f) {
          s[2] += 1.0f;
          s[7] += dx;
          s[8] += dy;
          s[9] += dz;
          s[10] += dx * dx;
          s[11] += dy * dy;
          s[12] += dz * dz;
        }
      }
      float mine = 0.0f;  // lane e < kSums keeps sum e
#pragma unroll
      for (int e = 0; e < kSums; ++e) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) s[e] += __shfl_xor_sync(kFull, s[e], m);
        if (lane == e) mine = s[e];
      }
      if (lane < kSums) acc[i * kSums + lane] += mine;
      __syncwarp();
      if (lane == 0) budget[i] = off;
    }
  });
  for (int i = warp; i < n_live; i += warps)
    if (lane < kSums) out_g[order[i] * kSums + lane] = acc[i * kSums + lane];
}

__global__ void ball_sums_bwd_kernel(const float* __restrict__ q,
                                     const float* __restrict__ cot,
                                     const float* __restrict__ tx,
                                     const float* __restrict__ ty,
                                     const float* __restrict__ tz,
                                     const int* __restrict__ tidx,
                                     const int* __restrict__ gcell,
                                     float* __restrict__ d_points,
                                     int n_slots, int group_size, int d0,
                                     int d1, int d2, int cap, float r2,
                                     float radius, int k) {
  const int slot = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slot >= n_slots) return;  // whole warp leaves together
  const int c = gcell[slot / group_size];
  if (c >= d0 * d1 * d2) return;
  const float* gs = cot + static_cast<long>(slot) * kSums;
  float g[kSums];
#pragma unroll
  for (int i = 3; i < kSums; ++i) g[i] = gs[i];
  bool any = false;
#pragma unroll
  for (int i = 3; i < kSums; ++i) any |= g[i] != 0.0f;
  if (!any) return;  // culled or padded slot, or a zero cotangent
  walk(tx, ty, tz, c, q[3 * slot], q[3 * slot + 1], q[3 * slot + 2], d0, d1,
       d2, cap, r2, k, lane,
       [&](long at, float rx, float ry, float rz, float dx, float dy,
           float dz, float d2s, bool selected) {
         if (!selected) return;
         const float d = sqrtf(fmaxf(d2s, 1e-24f));
         const float u = d / radius;
         const float base = 1.0f - u * u * u;
         const float w = fmaxf(base, 0.0f);
         const float coef = (base > 0.0f && d2s > 1e-24f)
                                ? -3.0f * u * u / (radius * d) : 0.0f;
         const float a = (g[3] + g[4] * rx + g[5] * ry + g[6] * rz) * coef;
         float gx = a * dx + w * g[4];
         float gy = a * dy + w * g[5];
         float gz = a * dz + w * g[6];
         if (d2s > 0.0f) {
           gx += g[7] + 2.0f * g[10] * dx;
           gy += g[8] + 2.0f * g[11] * dy;
           gz += g[9] + 2.0f * g[12] * dz;
         }
         const long p = 3L * tidx[at];
         atomicAdd(&d_points[p], gx);
         atomicAdd(&d_points[p + 1], gy);
         atomicAdd(&d_points[p + 2], gz);
       });
}

}  // namespace

// K3. q: (n_groups * group_size, 3) packed queries, padded slots at 1e9;
// tx/ty/tz: (cells + 1, cap) coordinates, 1e9 at empty slots; gcell:
// (n_groups,) cell of each group (cells for the sentinel groups); out:
// (n_groups * group_size, 13). threads, stage, n_stages: the block and
// staging plan (ops/ball_features.walk_plan); a plan that cannot launch is
// refused with cudaErrorInvalidValue.
extern "C" int nf_ball_sums(const float* q, const float* tx, const float* ty,
                            const float* tz, const int* gcell, float* out,
                            int n_groups, int group_size, int d0, int d1,
                            int d2, int cap, float r2, float radius, int k,
                            int threads, int stage, int n_stages,
                            void* stream) {
  const size_t smem =
      nf::ball::smem_bytes(stage, n_stages, 3, group_size, kSums);
  if (!nf::ball::plan_ok(threads, stage, n_stages, cap, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(ball_sums_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  ball_sums_kernel<<<n_groups, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      q, tx, ty, tz, gcell, out, group_size, d0, d1, d2, cap, r2, radius, k,
      stage, n_stages);
  return static_cast<int>(cudaGetLastError());
}

// K4. cot: (n_groups * group_size, 13) cotangent per packed slot; tidx: the
// tables' slot -> particle map (-1 at empty slots, never selected);
// d_points: (N, 3), zeroed by the caller.
extern "C" int nf_ball_sums_bwd(const float* q, const float* cot,
                                const float* tx, const float* ty,
                                const float* tz, const int* tidx,
                                const int* gcell, float* d_points,
                                int n_groups, int group_size, int d0, int d1,
                                int d2, int cap, float r2, float radius, int k,
                                void* stream) {
  const int n_slots = n_groups * group_size;
  const int blocks = (n_slots + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ball_sums_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      q, cot, tx, ty, tz, tidx, gcell, d_points, n_slots, group_size, d0, d1,
      d2, cap, r2, radius, k);
  return static_cast<int>(cudaGetLastError());
}
