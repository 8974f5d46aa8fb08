// K7: fused compact ball query, the neighbour lists of the transition
// model's `fused` search backend. Forward only: the ids are discrete.
//
// Replaces neurofluid_tpu/ops/fused_query.py `_fwd_kernel` (reached via
// `_pallas_compact` from `ball_query_compact`). For each packed query slot:
// walk the 27 table rows around the slot's group cell in selection order
// o -> (o/9 - 1, (o/3)%3 - 1, o%3 - 1), test every occupied slot against the
// inclusive radius d^2 <= r^2 (and d^2 > 0 with exclude_self), and write the
// original id (optionally the coordinates) of the first k in-radius
// particles, rows in order and slots in order, into output slot
// (particles met before) + (rank in the row) - 1. The count is the true,
// uncapped number of in-radius particles.
//
// The TPU kernel ranks a row's in-radius slots with a bf16 triangular
// matmul on the MXU and scatters each payload with a (T, K, cap) one-hot
// product and a lane reduction, ids carried as f32. None of that is needed
// here. One block owns one group of up to 8 queries of one cell and runs
// the staged walk of ball_walk.cuh: the 27 rows' occupied prefixes (x, y,
// z and the particle id) are read from L2 once per group into one
// flattened candidate list in shared memory, and the block's warps take
// the live slots in turn. A warp walks the list 32 candidates at a time; a
// ballot of the in-radius lanes plus __popc of the lanes below gives each
// lane its exact integer output slot, and the lane stores its int32 id
// there itself. The running count is one integer, uniform across the warp.
// A padded query slot (its coordinates at the sentinel) and a group of the
// sentinel cell do not stage or walk: they write an empty list (ids -1,
// coordinates 0) and count 0 with 16-byte stores, as do the unfilled tails.
//
// The squared distance is computed without contraction (__fmul_rn /
// __fadd_rn) in the order of the plain version, dx*dx + dy*dy + dz*dz, so
// that a particle on the radius shell is decided the same way in both.
//
// Bound on the card: bytes at the transition grid (the occupied table
// entries, the queries, and the (slots, k) id lists written once); every
// live query also tests each occupied slot of its 27 rows, about ten
// operations each.

#include <cuda_runtime.h>

#include "ball_walk.cuh"

namespace {

namespace b = nf::ball;

// The empty list of `n` consecutive slots from `slot`: ids -1, coordinates
// 0, count 0, by threads `tid` of `nt`.
template <bool kEmitXyz>
__device__ __forceinline__ void empty_lists(int* out_idx, int* out_count,
                                            float* out_x, float* out_y,
                                            float* out_z, long slot, int n,
                                            int k, int tid, int nt) {
  const long at = slot * k, len = static_cast<long>(n) * k;
  b::fill(out_idx + at, len, -1, tid, nt);
  if (kEmitXyz) {
    float* const xyz[3] = {out_x, out_y, out_z};
    for (int a = 0; a < 3; ++a)
      b::fill(reinterpret_cast<int*>(xyz[a]) + at, len, 0, tid, nt);
  }
  b::fill(out_count + slot, n, 0, tid, nt);
}

template <bool kEmitXyz>
__global__ void ball_query_compact_kernel(
    const float* __restrict__ q, const float* __restrict__ tx,
    const float* __restrict__ ty, const float* __restrict__ tz,
    const int* __restrict__ tidx, const int* __restrict__ gcell,
    int* __restrict__ out_idx, int* __restrict__ out_count,
    float* __restrict__ out_x, float* __restrict__ out_y,
    float* __restrict__ out_z, int t, int d0, int d1, int d2, int cap,
    float r2, int k, int exclude_self, int stage, int n_stages) {
  extern __shared__ __align__(16) float smem[];
  __shared__ b::Group g;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const long slot0 = static_cast<long>(blockIdx.x) * t;
  const int c = gcell[blockIdx.x];
  if (c >= d0 * d1 * d2) {  // a group of the sentinel cell
    empty_lists<kEmitXyz>(out_idx, out_count, out_x, out_y, out_z, slot0, t,
                          k, threadIdx.x, blockDim.x);
    return;
  }
  float* sq = smem + n_stages * stage * 4;
  int* order = reinterpret_cast<int*>(sq + 3 * t);
  int* budget = order + t;  // in-radius particles met so far, per live slot
  b::plan_group(g, q + 3 * slot0, t, c, d0, d1, d2, cap, tx, order, sq);
  const int n_live = g.n_live;
  for (int i = n_live + warp; i < t; i += warps)  // padded slots
    empty_lists<kEmitXyz>(out_idx, out_count, out_x, out_y, out_z,
                          slot0 + order[i], 1, k, lane, 32);
  for (int i = threadIdx.x; i < n_live; i += blockDim.x) budget[i] = 0;

  const unsigned below = b::kFull >> (31 - lane) >> 1;  // lanes before mine
  const float* const tab[4] = {tx, ty, tz,
                               reinterpret_cast<const float*>(tidx)};
  b::for_each_batch(g, tab, smem, stage, [&](const float* buf, int n) {
    const float* bx = buf;
    const float* by = buf + stage;
    const float* bz = buf + 2 * stage;
    const int* bi = reinterpret_cast<const int*>(buf + 3 * stage);
    for (int i = warp; i < n_live; i += warps) {
      const float qx = sq[3 * i], qy = sq[3 * i + 1], qz = sq[3 * i + 2];
      const long out_row = (slot0 + order[i]) * k;
      int off = budget[i];
      for (int base = 0; base < n; base += 32) {
        const int j = base + lane;
        const bool in = j < n;
        const float rx = in ? bx[j] : 1e9f;
        const float ry = in ? by[j] : 0.0f;
        const float rz = in ? bz[j] : 0.0f;
        const float d2s = b::dist2(__fsub_rn(rx, qx), __fsub_rn(ry, qy),
                                   __fsub_rn(rz, qz));
        const bool within =
            in && d2s <= r2 && !(exclude_self && d2s <= 0.0f);
        const unsigned mask = __ballot_sync(b::kFull, within);
        const int at = off + __popc(mask & below);
        off += __popc(mask);
        if (within && at < k) {
          out_idx[out_row + at] = bi[j];
          if (kEmitXyz) {
            out_x[out_row + at] = rx;
            out_y[out_row + at] = ry;
            out_z[out_row + at] = rz;
          }
        }
      }
      __syncwarp();
      if (lane == 0) budget[i] = off;
    }
  });
  for (int i = warp; i < n_live; i += warps) {  // the unfilled tails
    const long slot = slot0 + order[i];
    const int off = budget[i];
    const int filled = min(off, k);
    b::fill(out_idx + slot * k + filled, k - filled, -1, lane, 32);
    if (kEmitXyz) {
      float* const xyz[3] = {out_x, out_y, out_z};
      for (int a = 0; a < 3; ++a)
        b::fill(reinterpret_cast<int*>(xyz[a] + slot * k + filled),
                k - filled, 0, lane, 32);
    }
    if (lane == 0) out_count[slot] = off;
  }
}

}  // namespace

// q: (n_groups * group_size, 3) packed queries, padded slots at 1e9;
// tx/ty/tz: (cells + 1, cap) coordinates, 1e9 at empty slots; tidx: the
// same shape, the original particle index of each slot; gcell: (n_groups,)
// cell of each group (cells for the sentinel groups). out_idx: (slots, k)
// int32, out_count: (slots,) int32, out_x/y/z: (slots, k) f32 or null (then
// only ids are written). Every output entry is written. threads, stage,
// n_stages: the block and staging plan (ops/ball_features.walk_plan); a
// plan that cannot launch is refused with cudaErrorInvalidValue.
extern "C" int nf_ball_query_compact(
    const float* q, const float* tx, const float* ty, const float* tz,
    const int* tidx, const int* gcell, int* out_idx, int* out_count,
    float* out_x, float* out_y, float* out_z, int n_groups, int group_size,
    int d0, int d1, int d2, int cap, float r2, int k, int exclude_self,
    int threads, int stage, int n_stages, void* stream) {
  const size_t smem = b::smem_bytes(stage, n_stages, 4, 0, group_size, 0);
  if (!b::plan_ok(threads, stage, n_stages, cap, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_x != nullptr) {
    cudaFuncSetAttribute(ball_query_compact_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    ball_query_compact_kernel<true><<<n_groups, threads, smem, s>>>(
        q, tx, ty, tz, tidx, gcell, out_idx, out_count, out_x, out_y, out_z,
        group_size, d0, d1, d2, cap, r2, k, exclude_self, stage, n_stages);
  } else {
    cudaFuncSetAttribute(ball_query_compact_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    ball_query_compact_kernel<false><<<n_groups, threads, smem, s>>>(
        q, tx, ty, tz, tidx, gcell, out_idx, out_count, out_x, out_y, out_z,
        group_size, d0, d1, d2, cap, r2, k, exclude_self, stage, n_stages);
  }
  return static_cast<int>(cudaGetLastError());
}
