// K8: segment-sum accumulate, the adjoint of every neighbour gather:
//   out[s, :] = sum of vals[i, :] over the rows i with id[i] == s,  s < n
// for vals (M, C) f32 and ids in [0, n], id n being a trash segment that is
// dropped (the padding slots of a neighbour list).
//
// Replaces neurofluid_tpu/ops/segment_ops.py `_segsum_kernel` (reached via
// `segment_sum_accumulate` from the VJP of `take_rows_planned`). The TPU
// kernel keeps 8 accumulator copies of the whole (n + 1, C) table in VMEM
// and walks vals in natural order with a serial read-modify-write loop, the
// copies breaking the dependence between consecutive rows. Neither the
// resident table nor the serial grid exists on this card.
//
// Design: the planned sum, not atomics. The forward already owns the
// neighbour list, so the stable sort of its ids (`AdjointPlan`: `order`,
// the rows grouped by id, natural order inside a group, and `starts`, each
// group's range) is built once per list and shared by every gather from
// that list, five per ParticleNet step. One warp owns one output row and
// sums vals[order[j]] for j in [starts[s], starts[s + 1]): no atomics, no
// zero-filled output, the same bits on every run (with atomics in natural
// order the last bits of every gradient would vary from run to run), and
// the trash rows (about a quarter of a fluid list at the bench point, all
// of which an atomic version would add into one row) are never read.
// What it costs: the sort, once per list, and reads that are whole rows
// at scattered places instead of one stream. A row is C * 4 contiguous
// bytes, so at C >= 32 every sector read is used in full.
//
// Lanes: for C > 32 a lane owns channels lane, lane + 32, ... (up to four
// accumulators, then the next 128 channels) and the warp walks the group's
// rows one by one. For C <= 32 (the position and input-feature gathers, C
// = 3 and 4) a lane-per-channel layout would idle most of the warp, so the
// warp takes 32 / Cp rows per step (Cp = C rounded up to a power of two),
// lane -> (row lane / Cp, channel lane % Cp), and folds the row partials
// with shuffles at the end.
//
// Bound on the card: bytes. The rows outside the trash segment read once
// (C * 4 bytes each), M * 4 of ids, n * C * 4 written; one add per element.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__global__ void segment_sum_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ order,
                                   const int* __restrict__ starts,
                                   float* __restrict__ out, int n, int c,
                                   int cpad) {
  const int seg = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= n) return;  // whole warp leaves together
  const int s0 = starts[seg], s1 = starts[seg + 1];
  float* dst = out + static_cast<long>(seg) * c;

  if (c <= 32) {
    const int rows_per_step = 32 / cpad;
    const int r = lane / cpad, ch = lane % cpad;
    float acc = 0.0f;
    if (ch < c) {
#pragma unroll 4
      for (int j = s0 + r; j < s1; j += rows_per_step)
        acc += vals[static_cast<long>(order[j]) * c + ch];
    }
    for (int m = cpad; m < 32; m <<= 1) acc += __shfl_xor_sync(kFull, acc, m);
    if (r == 0 && ch < c) dst[ch] = acc;
    return;
  }

  for (int c0 = 0; c0 < c; c0 += 128) {
    const int ch = c0 + lane;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int j = s0; j < s1; ++j) {
      const float* row = vals + static_cast<long>(order[j]) * c;
      if (ch < c) a0 += row[ch];
      if (ch + 32 < c) a1 += row[ch + 32];
      if (ch + 64 < c) a2 += row[ch + 64];
      if (ch + 96 < c) a3 += row[ch + 96];
    }
    if (ch < c) dst[ch] = a0;
    if (ch + 32 < c) dst[ch + 32] = a1;
    if (ch + 64 < c) dst[ch + 64] = a2;
    if (ch + 96 < c) dst[ch + 96] = a3;
  }
}

}  // namespace

// vals: (M, c) f32; order: (M,) int32, the rows sorted by id, stably;
// starts: (n + 1,) int32, starts[s] the first position in `order` of id s
// (starts[n] opens the trash segment); out: (n, c) f32, every entry written.
extern "C" int nf_segment_sum_accumulate(const float* vals, const int* order,
                                         const int* starts, float* out, int n,
                                         int c, void* stream) {
  int cpad = 1;
  while (cpad < c && cpad < 32) cpad <<= 1;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_sum_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      vals, order, starts, out, n, c, cpad);
  return static_cast<int>(cudaGetLastError());
}
