// K9: the NeRF's wide dense layers on the tensor cores at f32 class
// (ops/dense_layer.py; models/nerf.py routes its 10 layers of width 128 and
// 256 here on the card at f32):
//
//   forward  out (M, N)    = act([A1 | A2] (M, k1 + k2) * W^T + b)
//   dX       dX (M, K_in)  = G (M, N) * W          G = dY (x) [out > 0]
//   dW       dW^T (K_in, N) = [A1 | A2]^T * G      (TRANS_A, M cut into
//                                                   splits summed in a fixed
//                                                   order)
//
// It replaces no TPU kernel: the JAX package leaves its dense layers to XLA,
// and the port ran them on cuBLAS's f32 SIMT path (TF32 off), about 45
// TFLOP/s, then a second pass for each ReLU and a copy for each concat.
//
// Precision: the split of split_gemm.cuh. Each f32 operand is hi =
// tf32(x) and lo = tf32(x - hi), each product three TF32 passes lo*hi +
// hi*lo + hi*hi; every k-tile of 32 is one chain of 12 `wgmma` from a zero
// accumulator, small passes first, and the chain's sum is added to the f32
// accumulator with a rounded add. A chain through the whole of k = 454
// (tests/test_torch_dense_layer.py) misses the limit of 2^-21 of sum |a||b|
// that the chains of 32 meet, so the second register accumulator stays.
//
// Bound on the card (H100 SXM): the three passes, 6 M N K / 495 TFLOP/s,
// against the bytes of A once and C once at 3.35 TB/s: a 256 x 256 layer is
// 0.79 ns of tensor work and 0.61 ns of bytes a row, near balance. So:
//
// * A (128, 128) tile of C per unit, two consumer warpgroups of 64 rows
//   each, the accumulator and a chain's sum 64 + 64 registers a thread and
//   A's fragments of two k-tiles 64 more (the producer warpgroup gives
//   registers to them with `setmaxnreg`, as split_gemm.cuh at BN = 128). N
//   = 256 is two units whose blocks run side by side (units walk N first),
//   so A comes from device memory once and from L2 the second time; N =
//   128 (`dir_encoding`) one unit. Each block walks units persistently, one
//   block per SM.
// * A is split in registers as the consumers read their fragments; B
//   (the weight, or for dW the masked cotangent) is split ahead of the
//   product into K-major hi and lo planes: one prep launch for all the
//   layers of a NeRF forward (`dense_layer_prep_kernel`, the forward's
//   planes and, under autograd, dX's transposed ones), one per layer in the
//   backward for G (`dense_layer_bwd_prep_kernel`, which also writes G
//   and the column sums of db).
// * Two sources of A: the k-tiles of A1, then those of A2, each zero-filled
//   past its width by TMA; the prep leaves the same gap in B's k. Layer 5
//   reads [input_xyz | h] and `dir_encoding` [feat | x[:, 198:]] where they
//   lie, with no concatenation. TMA takes a source whose base and row
//   stride are whole 16 bytes; any other (the dir slice starts 792 bytes
//   into x's 1,008-byte rows, and a box started off 16 bytes stops the
//   card with an illegal instruction) goes to the producer warpgroup's
//   `cp.async` copies into the same swizzled ring, 8 bytes a copy where
//   the source allows. dW reads its sources by TMA alone: the wrapper
//   copies such a slice (54 floats a row) for it.
// * The ring: three stages of (128 x 32) of A (16 KB) and B's hi and lo
//   (128 x 32 each) in TMA's 128-byte swizzle, on `mbarrier`s.
// * Epilogue: bias, then ReLU or identity, then one f32 store: C staged in
//   shared memory and stored by TMA while the next unit's chains run (its
//   stores from the registers had cost 17% of the layer's time: 0.2322
//   against 0.1965 ms without them), or, where TMA cannot take C (dX of
//   310 columns, dW's partial sums), from the registers. No second pass.
//   dW's splits go to a partial array, summed in a fixed order and
//   transposed by `dense_layer_dw_sum_kernel` (bitwise repeatable, no
//   atomics).
// * The host's side: a NeRF forward issues its ten products from one C
//   call (`nf_dense_layer_chain`), a layer's backward its launches from
//   one (`nf_dense_layer_bwd`), and the shared-memory attribute is set
//   once. On the H100's host a NeRF forward of 2,048 rows then took 385
//   us against 545 for `F.linear`'s path; a call and the attribute per
//   layer had taken 1,077 us against 400.

#include "split_gemm.cuh"

namespace nf {

constexpr int kDenseBN = 128;  // N per unit: one n128 chain per k-tile
// three stages ran as fast as four on an H100 (0.2312 / 0.2322 ms at
// 131,072 x 256 x 256): they leave room for C's staging
constexpr int kDenseStages = 3;
using DenseLayout = GemmLayout<kDenseBN>;  // A + B hi + B lo, 48 KB a stage
// a consumer warpgroup's (64 x 128) of C, in four (64 x 32) boxes in the
// 128-byte swizzle (split_gemm.cuh's `staged_at<128>`)
constexpr int kDenseStaging = 2 * 64 * kDenseBN * 4;
constexpr int kDenseBarOffset = kDenseStages * DenseLayout::kStage +
                                kDenseStaging;
constexpr size_t kDenseSmem = kDenseBarOffset + 2 * kDenseStages * 8 + 1024;
static_assert(kDenseSmem <= 232448, "the ring and the staging fit a block");

struct DenseArgs {
  const float* a[2];  // each source (cp.async path); TMA reads its map
  long lda[2];        // row strides in floats
  int width[2];       // columns of each source (0: no second source)
  int tiles[2];       // k-tiles (TRANS_A: m-tiles) of each source
  int a_tma[2];
  int a_run2[2];      // the cp.async path copies runs of 2 floats
  int c_tma;          // C stored by TMA from the staging (non-TRANS_A)
  const float* bias;  // nullptr: none
  int relu;
  float* c;
  long ldc;
  long c_split;  // floats between the partial arrays of two splits
  int m;         // rows of A's storage (the batch)
  int n;         // columns of C
  int b_row0;    // B's first row (dX of one source's columns)
  int m_tiles, n_tiles, n_split, kt_per_split, kt_total;
};

// cp.async of v (0..V) floats into V words at dst, the rest zero-filled
template <int V>
__device__ __forceinline__ void cp_async_run(uint8_t* dst, const float* src,
                                             int v) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(4 * V), "r"(4 * v)
               : "memory");
}

// The producer warpgroup's copies of one (128 rows x 32 k) tile of A
// into the swizzled ring, runs of V floats along k (V = 2 where the source
// allows 8-byte copies), zero at rows >= m or k >= width (split_gemm.cuh's
// `load_a_cp_async` with the limits of one source, on four warps).
template <int V>
__device__ __forceinline__ void dense_a_cp_async(uint8_t* tile,
                                                 const float* a, long lda,
                                                 int m, int width, int m0,
                                                 int k0, int ptid) {
  for (int i = V * ptid; i < kGemmBM * kGemmBK; i += V * 128) {
    const int r = i >> 5, c = i & 31, gm = m0 + r, gk = k0 + c;
    const int v = gm < m ? min(V, max(0, width - gk)) : 0;
    uint8_t* dst =
        tile + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
    cp_async_run<V>(dst, v > 0 ? a + static_cast<long>(gm) * lda + gk : a,
                    v);
  }
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Unit u: its tile of C (row tile, column tile) and its k-tiles.
__device__ __forceinline__ int dense_unit(const DenseArgs& p, int u,
                                          int& m_tile, int& n0, int& kt0) {
  n0 = (u % p.n_tiles) * kDenseBN;
  const int rest = u / p.n_tiles;
  m_tile = rest % p.m_tiles;
  kt0 = (rest / p.m_tiles) * p.kt_per_split;
  const int kt1 = min(p.kt_total, kt0 + p.kt_per_split);
  return kt1 > kt0 ? kt1 - kt0 : 0;
}

template <bool TRANS_A>
__global__ void __launch_bounds__(kGemmThreads, 1)
    dense_layer_gemm_kernel(const __grid_constant__ CUtensorMap a_map0,
                            const __grid_constant__ CUtensorMap a_map1,
                            const __grid_constant__ CUtensorMap b_map,
                            const __grid_constant__ CUtensorMap c_map,
                            const DenseArgs p) {
  using L = DenseLayout;
  extern __shared__ uint8_t dense_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dense_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDenseBarOffset);
  uint64_t* empty = full + kDenseStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDenseStages; ++s) {
      // thread 0's expect_tx, then lane 0 of each producer warp once its
      // lanes' copies are issued (each copy's arrival holds the phase
      // until the copy lands)
      mbar_init(&full[s], 1 + 4);
      mbar_init(&empty[s], kGemmConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int units = p.m_tiles * p.n_tiles * p.n_split;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  int m_tile, n0, kt0;

  if (wg == 0) {  // producer: thread 0 issues TMA, all four warps copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = threadIdx.x;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int n_kt = dense_unit(p, u, m_tile, n0, kt0);
      // TRANS_A: the row tile lies in one source
      const int ms = TRANS_A && m_tile >= p.tiles[0] ? 1 : 0;
      const int f0 = (m_tile - (ms ? p.tiles[0] : 0)) * kGemmBM;
      for (int i = 0; i < n_kt; ++i) {
        const int kt = kt0 + i;
        // non-TRANS_A: the k-tile lies in one source
        const int s = TRANS_A ? ms : (kt >= p.tiles[0] ? 1 : 0);
        const int kc = TRANS_A ? kt * kGemmBK
                               : (kt - (s ? p.tiles[0] : 0)) * kGemmBK;
        const CUtensorMap* a_map = s ? &a_map1 : &a_map0;
        mbar_wait(&empty[stage], phase ^ 1u);
        uint8_t* st = smem + stage * L::kStage;
        if (ptid == 0) {
          mbar_expect_tx(&full[stage],
                         L::kBLoad + (p.a_tma[s] ? L::kABytes : 0));
          tma_load_3d(st + L::kABytes, &b_map, &full[stage], kt * kGemmBK,
                      p.b_row0 + n0, 0);
          if (p.a_tma[s]) {
            if (TRANS_A) {
#pragma unroll
              for (int j = 0; j < kGemmBM / 32; ++j)
                tma_load_2d(st + j * 4096, a_map, &full[stage],
                            f0 + 32 * j, kc);
            } else {
              tma_load_2d(st, a_map, &full[stage], kc, m_tile * kGemmBM);
            }
          }
        }
        if (!TRANS_A && !p.a_tma[s]) {
          if (p.a_run2[s])
            dense_a_cp_async<2>(st, p.a[s], p.lda[s], p.m, p.width[s],
                                m_tile * kGemmBM, kc, ptid);
          else
            dense_a_cp_async<1>(st, p.a[s], p.lda[s], p.m, p.width[s],
                                m_tile * kGemmBM, kc, ptid);
          asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                           smem_addr(&full[stage]))
                       : "memory");
        }
        __syncwarp();
        if ((ptid & 31) == 0) mbar_arrive(&full[stage]);
        ring_advance<kDenseStages>(stage, phase);
      }
    }
    return;
  }

  // consumers: warpgroup cw takes rows [64 cw, 64 cw + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool vec2 = p.ldc % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(p.c) & 7u) == 0;
  float* staged = reinterpret_cast<float*>(smem + kDenseStages * L::kStage) +
                  cw * 64 * kDenseBN;
  const int bar_id = 1 + cw;  // named barrier of this warpgroup

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int n_kt = dense_unit(p, u, m_tile, n0, kt0);
    float acc[64], d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.0f;
    // A fragments of two k-tiles: the next is loaded while a chain runs
    uint32_t ah0[16], al0[16], ah1[16], al1[16];
    if (n_kt > 0) {
      mbar_wait(&full[stage], phase);
      load_a_frags<TRANS_A>(smem + stage * L::kStage, cw, w, g, t, ah0, al0);
    }
    for (int kt = 0; kt < n_kt; kt += 2) {
      int s = stage;
      ring_advance<kDenseStages>(stage, phase);
      gemm_chain<kDenseBN>(smem + s * L::kStage, d, ah0, al0);
      if (kt + 1 < n_kt) {
        mbar_wait(&full[stage], phase);
        load_a_frags<TRANS_A>(smem + stage * L::kStage, cw, w, g, t, ah1,
                              al1);
      }
      gemm_retire(acc, d, &empty[s], lane);
      if (kt + 1 >= n_kt) break;
      s = stage;
      ring_advance<kDenseStages>(stage, phase);
      gemm_chain<kDenseBN>(smem + s * L::kStage, d, ah1, al1);
      if (kt + 2 < n_kt) {
        mbar_wait(&full[stage], phase);
        load_a_frags<TRANS_A>(smem + stage * L::kStage, cw, w, g, t, ah0,
                              al0);
      }
      gemm_retire(acc, d, &empty[s], lane);
    }

    // epilogue: acc[4 j + 2 h + e] is C's (row r + 8 h, column 8 j + 2 t +
    // e) of the tile; bias, activation, one store
    const int r = 64 * cw + 16 * w + g;
    if (!TRANS_A && p.c_tma) {
      // through the staging, then a TMA store of the warpgroup's 64 rows
      // that drains while the next unit's chains run
      if (tid == 0)  // the last store has read the staging
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
#pragma unroll
      for (int j = 0; j < kDenseBN / 8; ++j) {
        const int c = 8 * j + 2 * t, col = n0 + c;
        float b0 = 0.0f, b1 = 0.0f;
        if (p.bias != nullptr && col < p.n) {
          b0 = p.bias[col];
          if (col + 1 < p.n) b1 = p.bias[col + 1];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h] + b0,
                v1 = acc[4 * j + 2 * h + 1] + b1;
          if (p.relu) {  // as torch.relu: a NaN stays NaN
            v0 = v0 < 0.0f ? 0.0f : v0;
            v1 = v1 < 0.0f ? 0.0f : v1;
          }
          *reinterpret_cast<float2*>(
              staged + staged_at<kDenseBN>(16 * w + g + 8 * h, c)) =
              make_float2(v0, v1);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
      if (tid == 0) {
#pragma unroll
        for (int jj = 0; jj < kDenseBN / 32; ++jj)
          tma_store_2d(&c_map, staged + 2048 * jj, n0 + 32 * jj,
                       m_tile * kGemmBM + 64 * cw);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      continue;
    }
    long row_at[2];
    bool row_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!TRANS_A) {
        const int row = m_tile * kGemmBM + r + 8 * h;
        row_ok[h] = row < p.m;
        row_at[h] = static_cast<long>(row) * p.ldc;
      } else {  // C's rows are the columns of A's sources, in their order
        const int ms = m_tile >= p.tiles[0] ? 1 : 0;
        const int f = (m_tile - (ms ? p.tiles[0] : 0)) * kGemmBM + r + 8 * h;
        row_ok[h] = f < p.width[ms];
        row_at[h] = static_cast<long>(f + (ms ? p.width[0] : 0)) * p.ldc;
      }
    }
    float* c = p.c + static_cast<long>(kt0 / p.kt_per_split) * p.c_split;
#pragma unroll
    for (int j = 0; j < kDenseBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= p.n) continue;
      float b0 = 0.0f, b1 = 0.0f;
      if (p.bias != nullptr) {
        b0 = p.bias[col];
        if (col + 1 < p.n) b1 = p.bias[col + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!row_ok[h]) continue;
        float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if (p.relu) {  // as torch.relu: a NaN stays NaN
          v0 = v0 < 0.0f ? 0.0f : v0;
          v1 = v1 < 0.0f ? 0.0f : v1;
        }
        float* dst = c + row_at[h] + col;
        if (vec2 && col + 1 < p.n) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < p.n) dst[1] = v1;
        }
      }
    }
  }
  if (p.c_tma && tid == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- B's planes

struct PrepJob {
  const float* w;  // the layer's weight (n, k_in), row-major
  float* out;      // hi plane (rows, cols), then the lo plane
  int kind;        // 0: the forward's planes; 1: dX's (W^T)
  int n, k_in, k1;
  int rows, cols;  // of a plane, both multiples of 32
  int tile_begin;  // the job's first block
};
constexpr int kMaxPrepJobs = 24;
struct PrepArgs {
  PrepJob job[kMaxPrepJobs];
  int n_jobs;
};

// The forward's planes (n, kp): row o holds W's row o split, source 1's k1
// columns, zeros to 32, then source 2's k_in - k1 columns, zeros to 32 (the
// product's k-tiles of A1 then A2). dX's planes (k_in padded to 128, n):
// W^T split, zero past k_in. One block a (32 x 32) tile of a plane.
__global__ void dense_layer_prep_kernel(const __grid_constant__ PrepArgs p) {
  __shared__ float tile[32][33];
  int j = 0;
  while (j + 1 < p.n_jobs && static_cast<int>(blockIdx.x) >= p.job[j + 1].tile_begin)
    ++j;
  const PrepJob& q = p.job[j];
  const int at = blockIdx.x - q.tile_begin, tiles_x = q.cols / 32;
  const int r0 = (at / tiles_x) * 32, c0 = (at % tiles_x) * 32;
  const long plane = static_cast<long>(q.rows) * q.cols;
  const int tx = threadIdx.x;
  if (q.kind == 0) {
    const int kp1 = (q.k1 + 31) / 32 * 32;
    for (int r = threadIdx.y; r < 32; r += 8) {
      const int o = r0 + r, col = c0 + tx;
      const int src = col < kp1 ? (col < q.k1 ? col : -1)
                                : (col - kp1 < q.k_in - q.k1 ? q.k1 + col - kp1
                                                             : -1);
      const float v =
          o < q.n && src >= 0 ? q.w[static_cast<long>(o) * q.k_in + src] : 0.0f;
      uint32_t h, l;
      split_tf32(v, h, l);
      const long dst = static_cast<long>(o) * q.cols + col;
      q.out[dst] = __uint_as_float(h);
      q.out[plane + dst] = __uint_as_float(l);
    }
    return;
  }
  // dX: plane row = input column c (r0..), plane column = output o (c0..)
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int o = c0 + r, cc = r0 + tx;
    tile[r][tx] =
        o < q.n && cc < q.k_in ? q.w[static_cast<long>(o) * q.k_in + cc] : 0.0f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    uint32_t h, l;
    split_tf32(tile[tx][r], h, l);
    const long dst = static_cast<long>(r0 + r) * q.cols + c0 + tx;
    q.out[dst] = __uint_as_float(h);
    q.out[plane + dst] = __uint_as_float(l);
  }
}

// The backward's cotangent of one layer: G = dY, masked by y > 0 after a
// ReLU (y != nullptr), written to g (when g != nullptr) and, split and
// transposed, to gt's planes (n, m_pad), zero past m; db_part[y block] the
// column sums of the block's 256 rows, in row order. A block takes 32
// columns (fewer at the edge) of 256 rows.
__global__ void dense_layer_bwd_prep_kernel(
    const float* __restrict__ dy, const float* __restrict__ y,
    float* __restrict__ g, float* __restrict__ gt, float* __restrict__ db_part,
    int m, int n, int m_pad) {
  __shared__ float tile[32][33];
  __shared__ float sums[8][32];
  const int n0 = blockIdx.x * 32, m0 = blockIdx.y * 256, tx = threadIdx.x;
  const long plane = static_cast<long>(n) * m_pad;
  float colsum = 0.0f;
  for (int s = 0; s < 8; ++s) {
    const int mb = m0 + 32 * s;
    if (mb >= m_pad) break;
    for (int r = threadIdx.y; r < 32; r += 8) {
      const int row = mb + r;
      float v = 0.0f;
      if (row < m && n0 + tx < n) {
        const long at = static_cast<long>(row) * n + n0 + tx;
        v = dy[at];
        if (y != nullptr && !(y[at] > 0.0f)) v = 0.0f;
        if (g != nullptr) g[at] = v;
      }
      tile[r][tx] = v;
      colsum += v;
    }
    __syncthreads();
    for (int r = threadIdx.y; r < 32 && n0 + r < n; r += 8) {
      uint32_t h, l;
      split_tf32(tile[tx][r], h, l);
      const long dst = static_cast<long>(n0 + r) * m_pad + mb + tx;
      gt[dst] = __uint_as_float(h);
      gt[plane + dst] = __uint_as_float(l);
    }
    __syncthreads();
  }
  sums[threadIdx.y][tx] = colsum;
  __syncthreads();
  if (threadIdx.y == 0 && n0 + tx < n) {
    float v = 0.0f;
    for (int i = 0; i < 8; ++i) v += sums[i][tx];
    db_part[static_cast<long>(blockIdx.y) * n + n0 + tx] = v;
  }
}

// db[c] = the column sums of db_part's rows (rows, n), column c a block:
// thread t adds the rows t, t + 256, ... in order, then a fixed tree adds
// the 256 sums (bitwise repeatable).
__global__ void dense_layer_db_kernel(const float* __restrict__ part,
                                           int rows, int n,
                                           float* __restrict__ db) {
  __shared__ float sums[256];
  const int c = blockIdx.x, t = threadIdx.x;
  float v = 0.0f;
  for (int r = t; r < rows; r += 256) v += part[static_cast<long>(r) * n + c];
  sums[t] = v;
  __syncthreads();
  for (int half = 128; half > 0; half >>= 1) {
    if (t < half) sums[t] += sums[t + half];
    __syncthreads();
  }
  if (t == 0) db[c] = sums[0];
}

// dw (n, k_in) = the n_split partial arrays (k_in, n) of dW^T summed,
// transposed. A block takes a (32 x 32) tile: thread (tx, ty) sums the
// splits z = ty, ty + 8, ... of column tx of each of the tile's rows, in
// order, then the eight partial sums of each entry are added in ty order.
// The order is fixed, so the result is bitwise repeatable.
__global__ void dense_layer_dw_sum_kernel(const float* __restrict__ part,
                                               int n_split, int k_in, int n,
                                               float* __restrict__ dw) {
  __shared__ float sums[8][32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y, nn = n0 + tx;
  const long len = static_cast<long>(k_in) * n;
#pragma unroll 4
  for (int r = 0; r < 32; ++r) {
    const int kk = k0 + r;
    float v = 0.0f;
    if (kk < k_in && nn < n) {
      const float* src = part + static_cast<long>(kk) * n + nn;
      for (int z = ty; z < n_split; z += 8) v += src[z * len];
    }
    sums[ty][r][tx] = v;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {  // dw's row n0 + r, column k0 + tx
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) v += sums[q][tx][r];
    if (n0 + r < n && k0 + tx < k_in)
      dw[static_cast<long>(n0 + r) * k_in + k0 + tx] = v;
  }
}

// dense_layer_gemm_kernel's launches so far in this process, counted
// where the runtime accepts each (every entry point launches through
// dense_gemm)
inline long long* dense_launches() {
  static long long n = 0;
  return &n;
}

// The product: A's sources a1 (width w1, row stride lda1) and a2 (w2 = 0:
// none); bt B's planes (bt_rows, bt_k), hi then lo, from b_row0 on; bias
// (nullptr: none) and relu into C (ldc). Non-TRANS_A: A (m, w1 + w2), C (m,
// n), one split. TRANS_A (dW): A stored (m, w1 + w2), both sources as TMA
// takes them; C (w1 + w2, n) per split of m into n_split runs of
// kt_per_split k-tiles, split z at c + z (w1 + w2) n.
inline int dense_gemm(const float* a1, int lda1, int w1, const float* a2,
                      int lda2, int w2, const float* bt, int bt_rows,
                      int bt_k, int b_row0, const float* bias, int relu,
                      float* c, int ldc, int m, int n, int trans_a,
                      int n_split, int kt_per_split, cudaStream_t st) {
  if (m < 1 || n < 1 || w1 < 1 || w2 < 0 || (w2 > 0 && a2 == nullptr) ||
      n_split < 1 || bt == nullptr || !aligned16(bt) || bt_k % kGemmBK != 0 ||
      (!trans_a && n_split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  DenseArgs p{};
  const float* srcs[2] = {a1, a2};
  const int ldas[2] = {lda1, lda2}, widths[2] = {w1, w2};
  const int rows_per_tile = trans_a ? kGemmBM : kGemmBK;
  CUtensorMap maps[2] = {};
  for (int s = 0; s < 2; ++s) {
    p.width[s] = widths[s];
    p.lda[s] = ldas[s];
    p.tiles[s] = (widths[s] + rows_per_tile - 1) / rows_per_tile;
    p.a[s] = srcs[s];
    if (widths[s] == 0) continue;
    // TMA takes a 16-byte base and row strides of whole 16 bytes
    p.a_tma[s] = aligned16(srcs[s]) && ldas[s] % 4 == 0;
    p.a_run2[s] = (reinterpret_cast<uintptr_t>(srcs[s]) & 7u) == 0 &&
                  ldas[s] % 2 == 0;
    if (!p.a_tma[s]) continue;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(widths[s]),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t strides[1] = {4ull * ldas[s]};
    const cuuint32_t box[2] = {kGemmBK, trans_a ? 32u : kGemmBM};
    if (!encode_map(&maps[s], srcs[s], 2, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (w2 == 0) maps[1] = maps[0];
  p.bias = bias;
  p.relu = relu;
  p.c = c;
  p.ldc = ldc;
  p.m = m;
  p.n = n;
  p.b_row0 = b_row0;
  p.n_tiles = (n + kDenseBN - 1) / kDenseBN;
  if (trans_a) {  // dW: both sources as TMA takes them
    if (!p.a_tma[0] || (w2 > 0 && !p.a_tma[1]))
      return static_cast<int>(cudaErrorInvalidValue);
    p.m_tiles = p.tiles[0] + p.tiles[1];
    p.kt_total = (m + kGemmBK - 1) / kGemmBK;
    p.n_split = n_split;
    p.kt_per_split = kt_per_split;
    p.c_split = static_cast<long>(w1 + w2) * ldc;
    if (kt_per_split < 1 ||
        static_cast<long>(n_split) * kt_per_split < p.kt_total ||
        bt_k < p.kt_total * kGemmBK)
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    p.m_tiles = (m + kGemmBM - 1) / kGemmBM;
    p.kt_total = p.tiles[0] + p.tiles[1];
    p.n_split = 1;
    p.kt_per_split = p.kt_total;
    if (bt_k != p.kt_total * kGemmBK)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // C by TMA: rows of whole 16 bytes from a 16-byte base
  p.c_tma = !trans_a && aligned16(c) && ldc % 4 == 0 && n <= ldc;
  CUtensorMap c_map{};
  if (p.c_tma) {
    const cuuint64_t c_dims[2] = {static_cast<cuuint64_t>(n),
                                  static_cast<cuuint64_t>(m)};
    const cuuint64_t c_strides[1] = {4ull * ldc};
    const cuuint32_t c_box[2] = {32u, 64u};
    if (!encode_map(&c_map, c, 2, c_dims, c_strides, c_box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap b_map{};
  const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(bt_k),
                                static_cast<cuuint64_t>(bt_rows), 2ull};
  const cuuint64_t b_strides[2] = {4ull * bt_k, 4ull * bt_k * bt_rows};
  const cuuint32_t b_box[3] = {kGemmBK, kDenseBN, 2u};
  if (!encode_map(&b_map, bt, 3, b_dims, b_strides, b_box))
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = trans_a ? dense_layer_gemm_kernel<true>
                        : dense_layer_gemm_kernel<false>;
  // the shared-memory attribute once per instantiation and device (a
  // runtime call on the host's path of every layer otherwise)
  static bool ready[2][64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  bool& set = ready[trans_a != 0][dev & 63];
  if (!set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kDenseSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    set = true;
  }
  const long units = static_cast<long>(p.m_tiles) * p.n_tiles * p.n_split;
  const int grid = static_cast<int>(
      units < gemm_sm_count() ? units : gemm_sm_count());
  kernel<<<grid, kGemmThreads, kDenseSmem, st>>>(maps[0], maps[1], b_map,
                                                 c_map, p);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++*dense_launches();
  return static_cast<int>(launched);
}

}  // namespace nf

// ---- entry points (ops/dense_layer.py)


// B's planes of several layers in one launch: `table` (host memory) holds
// n_jobs rows of 8 int64: w, out, kind, n, k_in, k1, rows, cols.
extern "C" int nf_dense_layer_prep(const long long* table, int n_jobs,
                                   void* stream) {
  using namespace nf;
  if (n_jobs < 1 || n_jobs > kMaxPrepJobs)
    return static_cast<int>(cudaErrorInvalidValue);
  PrepArgs p{};
  p.n_jobs = n_jobs;
  int tiles = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const long long* row = table + 8 * j;
    PrepJob& q = p.job[j];
    q.w = reinterpret_cast<const float*>(row[0]);
    q.out = reinterpret_cast<float*>(row[1]);
    q.kind = static_cast<int>(row[2]);
    q.n = static_cast<int>(row[3]);
    q.k_in = static_cast<int>(row[4]);
    q.k1 = static_cast<int>(row[5]);
    q.rows = static_cast<int>(row[6]);
    q.cols = static_cast<int>(row[7]);
    if (q.rows % 32 != 0 || q.cols % 32 != 0 || q.rows < 32 || q.cols < 32)
      return static_cast<int>(cudaErrorInvalidValue);
    q.tile_begin = tiles;
    tiles += (q.rows / 32) * (q.cols / 32);
  }
  dense_layer_prep_kernel<<<tiles, dim3(32, 8), 0,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Forward products of several layers in order, in one call from the host
// (a layer may read an earlier one's output): `table` (host memory) holds
// n_layers rows of 15 int64: a1, lda1, w1, a2, lda2, w2, bt, bt_rows,
// bt_k, bias, relu, c, ldc, m, n.
extern "C" int nf_dense_layer_chain(const long long* table, int n_layers,
                                    void* stream) {
  for (int i = 0; i < n_layers; ++i) {
    const long long* r = table + 15 * i;
    const int err = nf::dense_gemm(
        reinterpret_cast<const float*>(r[0]), static_cast<int>(r[1]),
        static_cast<int>(r[2]), reinterpret_cast<const float*>(r[3]),
        static_cast<int>(r[4]), static_cast<int>(r[5]),
        reinterpret_cast<const float*>(r[6]), static_cast<int>(r[7]),
        static_cast<int>(r[8]), 0, reinterpret_cast<const float*>(r[9]),
        static_cast<int>(r[10]), reinterpret_cast<float*>(r[11]),
        static_cast<int>(r[12]), static_cast<int>(r[13]),
        static_cast<int>(r[14]), 0, 1, 1, static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
}

// One layer's backward in one call from the host: G, its split planes gt
// (n, m_pad) and db's partial sums (dense_layer_bwd_prep_kernel: dy
// masked by y > 0, y == nullptr for no activation; G written to g unless g
// == nullptr); then, when dx_n > 0, dX's columns [c0, c0 + dx_n) = G W
// into dx (G from g, or dy itself without a mask) against dX's planes;
// then, when dw != nullptr, dW^T = [x1 | x2]^T G over the batch in n_split
// splits of kt_per_split k-tiles into part, summed into dw (n, wx1 + wx2);
// then, when db != nullptr, db (n) = the column sums of G.
extern "C" int nf_dense_layer_bwd(
    const float* dy, const float* y, float* g, float* gt, float* db_part,
    int m, int n, int m_pad, const float* dx_bt, int dx_bt_rows, int dx_bt_k,
    int c0, float* dx, int dx_n, const float* x1, int ldx1, int wx1,
    const float* x2, int ldx2, int wx2, float* part, int n_split,
    int kt_per_split, float* dw, float* db, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || m_pad < m || m_pad % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + 31) / 32, (m_pad + 255) / 256);
  nf::dense_layer_bwd_prep_kernel<<<grid, dim3(32, 8), 0, st>>>(
      dy, y, g, gt, db_part, m, n, m_pad);
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0 && dx_n > 0)
    err = nf::dense_gemm(y != nullptr ? g : dy, n, n, nullptr, 0, 0, dx_bt,
                         dx_bt_rows, dx_bt_k, c0, nullptr, 0, dx, dx_n, m,
                         dx_n, 0, 1, 1, st);
  if (err == 0 && dw != nullptr) {
    const int k_in = wx1 + wx2;
    err = nf::dense_gemm(x1, ldx1, wx1, x2, ldx2, wx2, gt, n, m_pad, 0,
                         nullptr, 0, part, n, m, n, 1, n_split, kt_per_split,
                         st);
    if (err == 0) {
      nf::dense_layer_dw_sum_kernel<<<dim3((k_in + 31) / 32,
                                                (n + 31) / 32),
                                           dim3(32, 8), 0, st>>>(
          part, n_split, k_in, n, dw);
      err = static_cast<int>(cudaGetLastError());
    }
  }
  if (err == 0 && db != nullptr) {
    nf::dense_layer_db_kernel<<<n, 256, 0, st>>>(db_part, grid.y, n, db);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

// dense_layer_gemm_kernel's launches so far in this process, by any entry
extern "C" long long nf_dense_layer_launches() {
  return *nf::dense_launches();
}
