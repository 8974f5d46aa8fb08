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
// For every selected neighbour c of a query q with cotangent g of the 13
// sums it adds
//   (g3 + g4 cx + g5 cy + g6 cz) dw/dc + w (g4, g5, g6)
//   + [d > 0] ((g7, g8, g9) + 2 (g10 dx, g11 dy, g12 dz))
// with w = max(1 - (d/r)^3, 0), d = sqrt(max(d^2, 1e-24)) and
// dw/dc = -3 (d/r)^2 / (r d) (dx, dy, dz) where both clamps pass, into
// d_points[table_idx[row, slot]]. The count columns 0-2 carry no gradient.
// The TPU kernel emitted per-group table cotangents (NG, 27, cap, 3) that
// XLA then summed per cell, shifted and mapped to particles.
//
// Here (`ball_sums_bwd_kernel`) one block owns one group and runs K3's
// staged walk, with the particle id staged beside x, y, z. A slot walks
// only if its query is live and its cotangent columns 3-12 are not all
// zero (`CotangentSlot`, decided while the group is planned; a group with
// no such slot stages nothing). The walk selects the forward's set: the
// same ballot ranks, running count and rounding of the distance; and a
// slot stops once k particles are selected, since the rest of its list
// carries no gradient. Each particle appears once in a group's flattened
// list, so a shared (3, stage) accumulator beside the staged arrays sums
// the group's gradient per candidate with shared-memory atomics; after
// each batch's walk and a barrier, one global atomic triple per candidate
// whose sum is not zero goes into d_points, and the accumulator is cleared
// before the next batch. Global atomics drop from one triple per selected
// pair to one per (group, selected particle); their order still varies
// from run to run. Bound: operations, about nine per candidate test up to
// each walked slot's k-th selected neighbour, plus ~40 operations and
// three shared-memory adds per selected pair.

#include <cuda_runtime.h>

#include "ball_walk.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSums = 13;
constexpr int kCot = 10;  // K4: the cotangent columns 3-12 that carry gradient

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

// K4's live slots and their state: a slot walks if its cotangent columns
// 3-12 are not all zero (a padded or culled slot has a zero cotangent),
// and keeps them in shared memory by place in `order`.
struct CotangentSlot {
  const float* cot;  // the group's (t, kSums) cotangent rows
  float* sg;         // (t, kCot), by place in `order`
  float g[kCot];
  __device__ __forceinline__ bool keep(int s) {
    bool any = false;
#pragma unroll
    for (int e = 0; e < kCot; ++e) {
      g[e] = cot[s * kSums + 3 + e];
      any |= g[e] != 0.0f;
    }
    return any;
  }
  __device__ __forceinline__ void place(int at) {
#pragma unroll
    for (int e = 0; e < kCot; ++e) sg[at * kCot + e] = g[e];
  }
};

// K4: one block per group of `t` packed slots (see ball_walk.cuh).
__global__ void ball_sums_bwd_kernel(const float* __restrict__ q,
                                     const float* __restrict__ cot,
                                     const float* __restrict__ tx,
                                     const float* __restrict__ ty,
                                     const float* __restrict__ tz,
                                     const int* __restrict__ tidx,
                                     const int* __restrict__ gcell,
                                     float* __restrict__ d_points, int t,
                                     int d0, int d1, int d2, int cap,
                                     float r2, float radius, int k,
                                     int stage, int n_stages) {
  namespace b = nf::ball;
  extern __shared__ __align__(16) float smem[];
  __shared__ b::Group g;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const long slot0 = static_cast<long>(blockIdx.x) * t;
  const int c = gcell[blockIdx.x];
  if (c >= d0 * d1 * d2) return;  // a group of the sentinel cell
  float* acc = smem + n_stages * stage * 4;  // (3, stage) per candidate
  float* sq = acc + 3 * stage;
  int* order = reinterpret_cast<int*>(sq + 3 * t);
  int* budget = order + t;  // in-radius particles met so far, per live slot
  float* sg = reinterpret_cast<float*>(budget + t);  // (live, kCot)
  b::plan_group(g, q + 3 * slot0, t, c, d0, d1, d2, cap, tx, order, sq,
                CotangentSlot{cot + slot0 * kSums, sg});
  const int n_live = g.n_live;
  if (n_live == 0) return;  // no slot carries a gradient (the whole block)
  const int used = min(stage, g.scan[b::kRows]);  // the first batch's size
  for (int i = threadIdx.x; i < used; i += blockDim.x)
    acc[i] = acc[stage + i] = acc[2 * stage + i] = 0.0f;
  for (int i = threadIdx.x; i < n_live; i += blockDim.x) budget[i] = 0;

  const unsigned below_or_me = kFull >> (31 - lane);
  const float* const tab[4] = {tx, ty, tz,
                               reinterpret_cast<const float*>(tidx)};
  b::for_each_batch(g, tab, smem, stage, [&](const float* buf, int n) {
    const float* bx = buf;
    const float* by = buf + stage;
    const float* bz = buf + 2 * stage;
    const int* bi = reinterpret_cast<const int*>(buf + 3 * stage);
    for (int i = warp; i < n_live; i += warps) {
      int off = budget[i];
      if (off >= k) continue;  // k selected in an earlier batch
      const float qx = sq[3 * i], qy = sq[3 * i + 1], qz = sq[3 * i + 2];
      float gc[kCot];
#pragma unroll
      for (int e = 0; e < kCot; ++e) gc[e] = sg[i * kCot + e];
      for (int base = 0; base < n && off < k; base += 32) {
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
        if (!within || rank > k) continue;
        const float d = sqrtf(fmaxf(d2s, 1e-24f));
        const float u = d / radius;
        const float base_w = 1.0f - u * u * u;
        const float w = fmaxf(base_w, 0.0f);
        const float coef = (base_w > 0.0f && d2s > 1e-24f)
                               ? -3.0f * u * u / (radius * d) : 0.0f;
        const float a = (gc[0] + gc[1] * rx + gc[2] * ry + gc[3] * rz) * coef;
        float gx = a * dx + w * gc[1];
        float gy = a * dy + w * gc[2];
        float gz = a * dz + w * gc[3];
        if (d2s > 0.0f) {
          gx += gc[4] + 2.0f * gc[7] * dx;
          gy += gc[5] + 2.0f * gc[8] * dy;
          gz += gc[6] + 2.0f * gc[9] * dz;
        }
        atomicAdd(&acc[j], gx);
        atomicAdd(&acc[stage + j], gy);
        atomicAdd(&acc[2 * stage + j], gz);
      }
      __syncwarp();
      if (lane == 0) budget[i] = off;
    }
    __syncthreads();  // the batch's gradient is summed
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float gx = acc[j], gy = acc[stage + j], gz = acc[2 * stage + j];
      if (gx != 0.0f || gy != 0.0f || gz != 0.0f) {
        const long p = 3L * bi[j];
        atomicAdd(&d_points[p], gx);
        atomicAdd(&d_points[p + 1], gy);
        atomicAdd(&d_points[p + 2], gz);
        acc[j] = acc[stage + j] = acc[2 * stage + j] = 0.0f;
      }
    }
  });  // its barrier: the accumulator is clear before the next batch
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
      nf::ball::smem_bytes(stage, n_stages, 3, 0, group_size, kSums);
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
// d_points: (N, 3), zeroed by the caller. threads, stage, n_stages: the
// block and staging plan (ops/ball_features.walk_plan with the gradient
// accumulator); a plan that cannot launch is refused with
// cudaErrorInvalidValue.
extern "C" int nf_ball_sums_bwd(const float* q, const float* cot,
                                const float* tx, const float* ty,
                                const float* tz, const int* tidx,
                                const int* gcell, float* d_points,
                                int n_groups, int group_size, int d0, int d1,
                                int d2, int cap, float r2, float radius, int k,
                                int threads, int stage, int n_stages,
                                void* stream) {
  const size_t smem =
      nf::ball::smem_bytes(stage, n_stages, 4, 3, group_size, kCot);
  if (!nf::ball::plan_ok(threads, stage, n_stages, cap, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(ball_sums_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  ball_sums_bwd_kernel<<<n_groups, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, cot, tx, ty, tz, tidx, gcell, d_points, group_size, d0, d1, d2, cap,
      r2, radius, k, stage, n_stages);
  return static_cast<int>(cudaGetLastError());
}
