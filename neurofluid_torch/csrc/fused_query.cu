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
// here: one warp owns one query and takes a row 32 slots at a time (at the
// transition grid's cap of 32 a row is exactly one warp); a ballot of the
// in-radius lanes plus __popc of the lanes below gives each lane its exact
// integer output slot, and the lane stores its int32 id there itself. The
// running count `off` is one integer, uniform across the warp. The walk is
// the one of K3 (`walk` in ball_features.cu) with the inclusive test and
// the exclude_self test added; slots of a row are filled as a prefix, so a
// row ends at the first chunk with no occupied slot (empty slots and the
// sentinel row hold 1e9 coordinates). A padded query slot (its coordinates
// at the sentinel) and a group of the sentinel cell write an empty list
// without walking.
//
// The squared distance is computed without contraction (__fmul_rn /
// __fadd_rn) in the order of the plain version, dx*dx + dy*dy + dz*dz, so
// that a particle on the radius shell is decided the same way in both.
//
// Bound on the card: bytes at the transition grid (the occupied table
// entries, the queries, and the (slots, k) id lists written once); every
// query also tests each occupied slot of its 27 rows, about ten operations
// each, while the tables (under 6 MB) stay in L2.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr float kEmpty = 5e8f;  // slots at or above hold the 1e9 sentinel

template <bool kEmitXyz>
__global__ void ball_query_compact_kernel(
    const float* __restrict__ q, const float* __restrict__ tx,
    const float* __restrict__ ty, const float* __restrict__ tz,
    const int* __restrict__ tidx, const int* __restrict__ gcell,
    int* __restrict__ out_idx, int* __restrict__ out_count,
    float* __restrict__ out_x, float* __restrict__ out_y,
    float* __restrict__ out_z, int n_slots, int group_size, int d0, int d1,
    int d2, int cap, float r2, int k, int exclude_self) {
  const int slot = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slot >= n_slots) return;  // whole warp leaves together
  const int c = gcell[slot / group_size];
  const float qx = q[3 * slot], qy = q[3 * slot + 1], qz = q[3 * slot + 2];
  const long out_row = static_cast<long>(slot) * k;
  const unsigned below = kFull >> (31 - lane) >> 1;  // lanes before mine
  int off = 0;  // in-radius particles met so far (uniform in the warp)

  if (c < d0 * d1 * d2 && qx < kEmpty) {
    const int cz = c % d2, cy = (c / d2) % d1, cx = c / (d1 * d2);
    for (int o = 0; o < 27; ++o) {
      const int ox = o / 9 - 1, oy = (o / 3) % 3 - 1, oz = o % 3 - 1;
      if (cx + ox < 0 || cx + ox >= d0 || cy + oy < 0 || cy + oy >= d1 ||
          cz + oz < 0 || cz + oz >= d2)
        continue;
      const long row =
          static_cast<long>(c + ox * d1 * d2 + oy * d2 + oz) * cap;
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
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        const bool within =
            occupied && d2s <= r2 && !(exclude_self && d2s <= 0.0f);
        const unsigned mask = __ballot_sync(kFull, within);
        const int at = off + __popc(mask & below);
        off += __popc(mask);
        if (within && at < k) {
          out_idx[out_row + at] = tidx[row + j];
          if (kEmitXyz) {
            out_x[out_row + at] = rx;
            out_y[out_row + at] = ry;
            out_z[out_row + at] = rz;
          }
        }
      }
    }
  }
  // the unfilled tail: id -1, coordinates 0
  for (int s = min(off, k) + lane; s < k; s += 32) {
    out_idx[out_row + s] = -1;
    if (kEmitXyz) {
      out_x[out_row + s] = 0.0f;
      out_y[out_row + s] = 0.0f;
      out_z[out_row + s] = 0.0f;
    }
  }
  if (lane == 0) out_count[slot] = off;
}

}  // namespace

// q: (n_groups * group_size, 3) packed queries, padded slots at 1e9;
// tx/ty/tz: (cells + 1, cap) coordinates, 1e9 at empty slots; tidx: the
// same shape, the original particle index of each slot; gcell: (n_groups,)
// cell of each group (cells for the sentinel groups). out_idx: (slots, k)
// int32, out_count: (slots,) int32, out_x/y/z: (slots, k) f32 or null (then
// only ids are written). Every output entry is written.
extern "C" int nf_ball_query_compact(
    const float* q, const float* tx, const float* ty, const float* tz,
    const int* tidx, const int* gcell, int* out_idx, int* out_count,
    float* out_x, float* out_y, float* out_z, int n_groups, int group_size,
    int d0, int d1, int d2, int cap, float r2, int k, int exclude_self,
    void* stream) {
  const int n_slots = n_groups * group_size;
  const int blocks = (n_slots + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 threads(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_x != nullptr) {
    ball_query_compact_kernel<true><<<blocks, threads, 0, s>>>(
        q, tx, ty, tz, tidx, gcell, out_idx, out_count, out_x, out_y, out_z,
        n_slots, group_size, d0, d1, d2, cap, r2, k, exclude_self);
  } else {
    ball_query_compact_kernel<false><<<blocks, threads, 0, s>>>(
        q, tx, ty, tz, tidx, gcell, out_idx, out_count, out_x, out_y, out_z,
        n_slots, group_size, d0, d1, d2, cap, r2, k, exclude_self);
  }
  return static_cast<int>(cudaGetLastError());
}
