// Tensor-core matrix product at f32-class accuracy, used three times by the
// fused continuous convolution (fused_cconv.cu):
//
//   C (M, N) = A (M, K) * B (K, N)        f32 in, f32 out, row-major
//
//   K1 fold:   out   (Nq, Cout)      = rows (Nq, 64 Cin)   * W
//   K2 d_acc:  d_acc (Nq, 64 Cin)    = ct   (Nq, Cout)     * W^T
//   K2 dW:     dW    (64 Cin, Cout)  = rows^T              * ct   (TRANS_A:
//              A is stored (K, M); the K range is cut into splits whose
//              partial products are written apart and summed in order)
//
// The TPU kernels contract these inside their own bodies on the MXU at
// HIGHEST precision (neurofluid_tpu/ops/fused_cconv.py `_fwd_kernel`,
// `_bwd_kernel`). Here every f32 operand is split in registers into
// hi = tf32(x) and lo = tf32(x - hi), and each k-step of 8 runs three
// `mma.sync.m16n8k8` TF32 products, lo*hi + hi*lo + hi*hi (small terms
// first), chained through the tensor core from a zero accumulator; their
// sum is then added to the f32 accumulator with an ordinary rounded add.
// The tensor core truncates when it accumulates, so a sum carried through
// it over a long k drifts far beyond f32's own error (at k = 6,144 the
// fold then missed the kernel tests' rtol of 1e-4); summed outside, the
// truncation touches only 8-term partial sums. The dropped
// lo*lo term is below 2^-21 of |a||b|, so the result is as accurate as an
// f32 SIMT product.
//
// A block owns a (BM, BN) tile of C; with KG = 2 two groups of warps take
// alternate k-steps of the same tile and add their sums through shared
// memory at the end, which doubles the warps per SM where the grid is
// small. (BM or BK, 32)-deep tiles of A and B arrive in a three-stage ring
// of shared memory by `cp.async` (16-byte copies where the leading
// dimension and the base pointer allow, 4-byte copies with zero fill on
// ragged edges and odd widths such as Cout = 3), so every element of A and B leaves L2 once per (BM, BN) tile: once per 64
// query rows in the fold and in d_acc. Row strides of the tiles are chosen
// so that the fragment reads of a warp fall on 32 different banks.
// Bound on the card: operations (3 TF32 passes over 2 M N K) for the fold
// and dW, bytes (the M x N output) for d_acc.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace nf {

// x = hi + lo with both representable in TF32 (10-bit mantissa)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d = a b (a zero accumulator goes in)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// d += a b
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kGemmBK = 32;
constexpr int kGemmStages = 3;

// Copy a (rows, 4 * chunks) tile of the row-major matrix `src` (leading
// dimension ld), whose first element is (r0, c0), into `dst` (row stride
// `stride`); entries at rows >= r_lim or columns >= c_lim become zero.
template <int THREADS>
__device__ __forceinline__ void gemm_load_tile(float* dst, int stride,
                                               const float* src, int ld,
                                               int rows, int chunks, int r0,
                                               int c0, int r_lim, int c_lim,
                                               bool vec) {
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, cc = i % chunks;
    const int gr = r0 + r, gc = c0 + cc * 4;
    float* d = dst + r * stride + cc * 4;
    const float* s = src + static_cast<long>(gr) * ld + gc;
    if (vec && gr < r_lim && gc + 4 <= c_lim) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gr < r_lim && gc + e < c_lim;
        cp_async4(d + e, ok ? s + e : src, ok);
      }
    }
  }
}

template <int BM, int BN, bool TRANS_A>
struct GemmTiles {
  static constexpr int kAStride = TRANS_A ? BM + 8 : kGemmBK + 4;
  static constexpr int kARows = TRANS_A ? kGemmBK : BM;
  static constexpr int kBStride = BN + (BN % 32 == 0 ? 8 : 0);
  static constexpr int kATile = kARows * kAStride;
  static constexpr int kBTile = kGemmBK * kBStride;
  static constexpr size_t kSmemBytes =
      sizeof(float) * kGemmStages * (kATile + kBTile);
};

// Split z of the grid contracts k in [z * k_per_split, (z + 1) *
// k_per_split) and writes its (m, n) product at c + z * m * n. With
// TRANS_A, `a` is the (k, m) row-major matrix A^T.
template <int BM, int BN, int WARPS_M, int WARPS_N, int KG, bool TRANS_A>
__global__ void __launch_bounds__(WARPS_M* WARPS_N* KG * 32)
    split_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ c, int m, int n, int k, int lda,
                      int ldb, int k_per_split) {
  using T = GemmTiles<BM, BN, TRANS_A>;
  constexpr int kGroup = WARPS_M * WARPS_N * 32;  // threads per k-group
  constexpr int kThreads = kGroup * KG;
  constexpr int MT = BM / WARPS_M / 16, NT = BN / WARPS_N / 8;
  constexpr int AS = T::kAStride, BS = T::kBStride;
  extern __shared__ __align__(16) float gemm_smem[];
  float* sa = gemm_smem;
  float* sb = gemm_smem + kGemmStages * T::kATile;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kGemmBK - 1) / kGemmBK
                                   : 0;
  c += static_cast<long>(blockIdx.z) * m * n;
  const bool a_vec = lda % 4 == 0 && aligned16(a);
  const bool b_vec = ldb % 4 == 0 && aligned16(b);

  auto load = [&](int stage, int kt) {
    const int kb = k_begin + kt * kGemmBK;
    if (TRANS_A)
      gemm_load_tile<kThreads>(sa + stage * T::kATile, AS, a, lda, kGemmBK,
                               BM / 4, kb, m0, k_end, m, a_vec);
    else
      gemm_load_tile<kThreads>(sa + stage * T::kATile, AS, a, lda, BM,
                               kGemmBK / 4, m0, kb, m, k_end, a_vec);
    gemm_load_tile<kThreads>(sb + stage * T::kBTile, BS, b, ldb, kGemmBK,
                             BN / 4, kb, n0, k_end, n, b_vec);
  };

  const int kg = threadIdx.x / kGroup;
  const int warp = (threadIdx.x % kGroup) / 32, lane = threadIdx.x % 32;
  const int wm = (warp % WARPS_M) * (BM / WARPS_M);
  const int wn = (warp / WARPS_M) * (BN / WARPS_N);
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < n_kt) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kGemmStages - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread, and tile kt - 1 is consumed
    const int next = kt + kGemmStages - 1;
    if (next < n_kt) load(next % kGemmStages, next);
    cp_async_commit();
    const float* ta = sa + (kt % kGemmStages) * T::kATile;
    const float* tb = sb + (kt % kGemmStages) * T::kBTile;
#pragma unroll
    for (int ks = 0; ks < kGemmBK / (8 * KG); ++ks) {
      const int kk = (ks * KG + kg) * 8;
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = wm + i * 16 + g, r1 = r0 + 8;
        const int k0 = kk + t, k1 = k0 + 4;
        float x[4];
        if (TRANS_A) {
          x[0] = ta[k0 * AS + r0];
          x[1] = ta[k0 * AS + r1];
          x[2] = ta[k1 * AS + r0];
          x[3] = ta[k1 * AS + r1];
        } else {
          x[0] = ta[r0 * AS + k0];
          x[1] = ta[r1 * AS + k0];
          x[2] = ta[r0 * AS + k1];
          x[3] = ta[r1 * AS + k1];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(x[e], ah[i][e], al[i][e]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cn = wn + j * 8 + g;
        split_tf32(tb[(kk + t) * BS + cn], bh[j][0], bl[j][0]);
        split_tf32(tb[(kk + t + 4) * BS + cn], bh[j][1], bl[j][1]);
      }
      // the three products of one tile are MT * NT instructions apart, so
      // the tensor pipe never waits on its own result
      float d[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32_first(d[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[i][j], ah[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
    }
  }
  cp_async_wait<0>();
  if (KG > 1) {  // the second k-group hands its sums to the first
    float* red = gemm_smem;
    const int slot = threadIdx.x % kGroup;
    __syncthreads();  // the ring is consumed
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[((i * NT + j) * 4 + e) * kGroup + slot] = acc[i][j][e];
    }
    __syncthreads();
    if (kg != 0) return;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] += red[((i * NT + j) * 4 + e) * kGroup + slot];
  }

  const bool pair_store = (n & 1) == 0 && (reinterpret_cast<uintptr_t>(c) & 7u) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= m || col >= n) continue;
        float* dst = c + static_cast<long>(row) * n + col;
        if (pair_store && col + 1 < n) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          dst[0] = acc[i][j][2 * h];
          if (col + 1 < n) dst[1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

// out[i] = the n_split partial arrays of `len` entries summed in order
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n_split,
                                  int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float v = 0.0f;
  for (int s = 0; s < n_split; ++s) v += part[static_cast<long>(s) * len + i];
  out[i] = v;
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int KG, bool TRANS_A>
int launch_split_gemm(const float* a, const float* b, float* c, int m, int n,
                      int k, int lda, int ldb, int n_split, int k_per_split,
                      cudaStream_t stream) {
  using T = GemmTiles<BM, BN, TRANS_A>;
  static_assert(KG == 1 || KG == 2, "one or two k-groups");
  static_assert(sizeof(float) * BM * BN <= T::kSmemBytes,
                "the k-groups' sums pass through the ring");
  auto kernel = split_gemm_kernel<BM, BN, WARPS_M, WARPS_N, KG, TRANS_A>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(T::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, n_split);
  kernel<<<grid, WARPS_M * WARPS_N * KG * 32, T::kSmemBytes, stream>>>(
      a, b, c, m, n, k, lda, ldb, k_per_split);
  return static_cast<int>(cudaGetLastError());
}

// c (n_split, m, n) = per split of k, a * b. a is (m, k) row-major, or
// (k, m) with trans_a; b is (k, n) row-major. k_per_split is a multiple of
// 32 (only read when n_split > 1). n <= 8 takes (128, 8) tiles on 4 warps,
// wider outputs (64, 64) tiles on 4 warps (on two k-groups of 4 where the
// grid has at most 264 blocks); ragged edges are masked in the kernel.
inline int split_gemm(const float* a, const float* b, float* c, int m, int n,
                      int k, bool trans_a, int n_split, int k_per_split,
                      cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n_split <= 0) return 0;
  if (n_split == 1) k_per_split = ((k + kGemmBK - 1) / kGemmBK) * kGemmBK;
  if (k_per_split <= 0) k_per_split = kGemmBK;
  if (k_per_split % kGemmBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lda = trans_a ? m : k, ldb = n;
  if (n <= 8) {
    return trans_a ? launch_split_gemm<128, 8, 4, 1, 1, true>(
                         a, b, c, m, n, k, lda, ldb, n_split, k_per_split,
                         stream)
                   : launch_split_gemm<128, 8, 4, 1, 1, false>(
                         a, b, c, m, n, k, lda, ldb, n_split, k_per_split,
                         stream);
  }
  // a small grid takes two k-groups per block: twice the warps per SM
  const long blocks = static_cast<long>((m + 63) / 64) * ((n + 63) / 64) *
                      n_split;
  if (blocks <= 264) {
    return trans_a ? launch_split_gemm<64, 64, 2, 2, 2, true>(
                         a, b, c, m, n, k, lda, ldb, n_split, k_per_split,
                         stream)
                   : launch_split_gemm<64, 64, 2, 2, 2, false>(
                         a, b, c, m, n, k, lda, ldb, n_split, k_per_split,
                         stream);
  }
  return trans_a ? launch_split_gemm<64, 64, 2, 2, 1, true>(
                       a, b, c, m, n, k, lda, ldb, n_split, k_per_split,
                       stream)
                 : launch_split_gemm<64, 64, 2, 2, 1, false>(
                       a, b, c, m, n, k, lda, ldb, n_split, k_per_split,
                       stream);
}

}  // namespace nf
