// Tensor-core matrix product at f32-class accuracy, used three times by the
// fused continuous convolution (fused_cconv.cu):
//
//   C (M, N) = A (M, K) * B (K, N)        f32 in, f32 out, row-major
//
//   K1 fold:   out   (Nq, Cout)      = rows (Nq, 64 Cin)   * W
//   K2 d_acc:  d_acc (Nq, 64 Cin)    = ct   (Nq, Cout)     * W^T
//   K2 dW:     dW    (64 Cin, Cout)  = rows^T              * ct   (TRANS_A:
//              A is stored (K, M))
//
// The K range may be cut into splits whose partial products are written
// apart and summed in order (`sum_splits_kernel`): the result is bitwise
// repeatable, with no atomics.
//
// The TPU kernels contract these inside their own bodies on the MXU at
// HIGHEST precision (neurofluid_tpu/ops/fused_cconv.py `_fwd_kernel`,
// `_bwd_kernel`). Here every f32 operand is split into hi = tf32(x) and
// lo = tf32(x - hi), and each product runs as three TF32 passes, lo*hi +
// hi*lo + hi*hi, on Hopper's `wgmma`. The dropped lo*lo term is below
// 2^-21 of |a||b|. The tensor core truncates when it accumulates, so a sum
// carried through it over the whole of k drifts far beyond f32's own error
// (at k = 6,144 it missed the kernel tests' rtol of 1e-4): each k-tile of
// 32 is one chain of 12 `wgmma` from a zero accumulator, the small passes of
// its 4 k-steps first, then their hi*hi, and the chain's sum is added to
// the f32 accumulator in registers with a rounded add.
// tests/test_torch_split_gemm.py emulates chains of 8 and of 32 within the
// limit; on an H100 the chains of 32 left d_acc (k = 64, the shortest sum)
// at 0.44 of the limit with the small passes first and 0.84 with the
// passes of each k-step together.
//
// Bound on the card: bytes at every use (the fold streams the (Nq, 64 Cin)
// rows once; d_acc writes them once); the three TF32 passes are 0.034 ms
// of tensor work against 0.054 ms of bytes at conv1's fold. The design:
//
// * A block owns a (128, BN) tile of C (BN = 8 for N <= 8, 128 from N =
//   1,024, else 64) and walks (tile, split) units persistently, one block
//   per SM. Warpgroup 0 is the producer: one warp keeps a ring of shared
//   memory full, (128 x 32) of A (16 KB) plus B's hi and lo (BN x 32 each)
//   per stage, five stages (three at BN = 128), by TMA
//   (`cp.async.bulk.tensor`) completing on an `mbarrier` per stage. Up to
//   80 KB of A is in flight per SM. Warpgroups 1 and 2 each take 64 rows of
//   the tile and hand each stage back on an `mbarrier` when their chains
//   over it are done.
// * `wgmma` with TF32 reads B from shared memory K-major only, so a small
//   prep kernel (`split_gemm_kernel_b`) writes B transposed to (N, K),
//   split into hi and lo, padded to BN and to 32 in k, into scratch the
//   caller allocates. A comes from registers: each consumer thread reads
//   its fragment of the tile from shared memory once and splits it there.
// * The ring's rows are 128 bytes, loaded with TMA's 128-byte swizzle: the
//   `wgmma` descriptor of B names it, and the fragment reads of A undo it,
//   so the 8 rows a warp reads fall on 32 different banks (two-way in the
//   TRANS_A form, whose A arrives as (32 x 32) M-major sub-tiles).
// * While a tile's chain runs, each consumer waits for the next stage and
//   loads and splits its A fragments; the wait and add of one warpgroup's
//   chain overlap the other warpgroup's chain.
// * The epilogue stages C in shared memory and stores it by TMA while the
//   next unit's chains run (16-byte runs of rows by the threads where TMA
//   cannot take C). The 128-wide N-tile halves d_acc's units and their
//   starts and stores per byte of output; its 64-float sums need more than
//   the 168 registers a thread of 384 gets, so there the producer gives
//   registers to the consumers (`setmaxnreg`).
// * Where TMA cannot take A (a base address off 16 bytes or a row stride
//   that is no multiple of 16 bytes), the producer warp fills the same
//   swizzled ring with 4-byte `cp.async` copies, zero-filled at the edges,
//   completing on the same `mbarrier`.
//
// What limits it now (H100 80GB HBM3, 700 W; PERF.md): 0.52-0.65 of the
// bytes bound at the wide uses. Not the L2 reads of B (loading B once per
// unit instead of once per k-tile gained under 1%), not the ring (four to
// six stages within 3%), not the store; the third pass costs 10-15%, and a
// second chain in flight per warpgroup was 5-10% slower (it holds a stage
// longer). The chains of n64 `wgmma` with A from registers are the rest.
//
// The bf16 mode (template BF16; the JAX package's `DEFAULT` precision, one
// bf16 MXU pass with f32 accumulation): the same ring, units and epilogue;
// each k-tile of 32 is one chain of two `wgmma.m64nNk16.f32.bf16.bf16` from
// a zero accumulator, the chain's sum added in f32 as in the TF32 mode. A
// arrives in bf16, rounded once by whoever wrote it (the walk rounds its
// accumulator rows as it writes them, K2d a bf16 copy of its cotangent):
// (128 x 32) bf16 tiles of 8 KB with 64-byte rows (TRANS_A: four (32 k x
// 32 m) sub-tiles of 2 KB), loaded by TMA in the 64-byte swizzle and read
// into the m16n8k16 fragments as they are, so A's bytes, in device memory
// and in the ring, are half the TF32 mode's and a stage is smaller: eight
// stages (four at BN = 128) keep as much of A in flight. Where TMA cannot
// take A, the producer warp fills the same layout with 2-byte loads. B is
// prepared K-major in bf16 (`split_gemm_kernel_b_bf16`, rounded as it is
// transposed): (BN x 32) bf16 tiles with 64-byte rows in the same swizzle,
// which the `wgmma` descriptor names. The epilogue writes C in f32, or in
// bf16 for K2d's d_acc (`c_bf16`: rounded once, stored by the threads). The
// products of bf16 values are exact in f32, so the result differs from a
// float64 product of the rounded operands only by the f32 sums.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace nf {

constexpr int kGemmBK = 32;    // k per tile: one 128-byte swizzled row of f32
constexpr int kGemmBM = 128;   // rows per tile: two consumer warpgroups
constexpr int kGemmThreads = 384;  // producer warpgroup + two consumers
// empty-barrier arrivals per stage: one per consumer warp
constexpr int kGemmConsumerWarps = 8;

// x rounded to the nearest bf16 (ties to even), as f32
__device__ __forceinline__ float bf16_round(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// bf16(lo) in the low half, bf16(hi) in the high half of one register
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x = hi + lo with both representable in TF32 (10-bit mantissa)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive once all of this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait of more
// than ~2^35 cycles (about 20 s) can only be a pipeline that never
// completes: it traps, an error the caller sees, instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

// ---- TMA

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of r across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory descriptor of a K-major tile with 128-byte rows in TMA's
// 128-byte swizzle: 8-row groups 1,024 bytes apart (the leading offset is
// unused for this layout). A k-step of 8 f32 moves the start by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

// The same for a K-major bf16 tile with 64-byte rows in TMA's 64-byte
// swizzle: 8-row groups 512 bytes apart. A k-step of 16 bf16 moves the
// start by 32 bytes.
__device__ __forceinline__ uint64_t sw64_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (uint64_t{1} << 16) | (uint64_t{512 >> 4} << 32) |
         (uint64_t{2} << 62);
}

// d (+)= a b for one 64 x BN x 8 step: a from registers (the m16n8k8 A
// fragment of each warp's 16 rows), b from shared memory; scale_d = 0
// starts from a zero accumulator
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t* a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t* a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// d (+)= a b for one 64 x BN x 16 step in bf16: a from registers (the
// m16n8k16 A fragment of each warp's 16 rows, two bf16 a register), b a
// K-major tile in shared memory; scale_d = 0 starts from a zero accumulator
template <int BN>
struct WgmmaBf16;

template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t* a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t* a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t* a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// ---- the product

template <int BN, bool BF16 = false>
struct GemmLayout {
  // (128 x 32) of A: 16 KB in f32, 8 KB in bf16
  static constexpr int kABytes = kGemmBM * kGemmBK * (BF16 ? 2 : 4);
  // TF32: hi, then lo, (BN x 32) f32 each; bf16: one (BN x 32) bf16 tile
  static constexpr int kBBytes = BN * kGemmBK * (BF16 ? 2 : 4);
  static constexpr int kBLoad = BF16 ? kBBytes : 2 * kBBytes;  // per stage
  // a stage's B takes whole 1,024-byte blocks
  static constexpr int kStage = kABytes + (kBLoad + 1023) / 1024 * 1024;
  // five stages; three at BN = 128, whose staging of C takes 64 KB; the
  // bf16 mode's stages are about half as large, and it keeps twice as many
  // (8 and 4)
  static constexpr int kStages = BN == 128 ? (BF16 ? 4 : 3) : (BF16 ? 8 : 5);
  // a consumer's 64 rows of C: (64 x 32) boxes in the 128-byte swizzle
  // (BN = 64), or dense 32-byte rows (BN = 8)
  static constexpr int kStaging = 2 * 64 * BN * 4;
  static constexpr int kBarOffset = kStages * kStage + kStaging;
  // + the full and empty barriers, + slack to align the ring to 1,024
  static constexpr size_t kBytes = kBarOffset + 2 * kStages * 8 + 1024;
  static_assert(kStage % 1024 == 0, "swizzled tiles start on 1,024 bytes");
};
static_assert(GemmLayout<8>::kStage == 16384 + 2 * 8 * 128 &&
                  GemmLayout<64>::kStage == 16384 + 2 * 64 * 128 &&
                  GemmLayout<128>::kStage == 16384 + 2 * 128 * 128,
              "the TF32 layouts are those of the A + hi + lo stages");

struct GemmArgs {
  const float* a;  // read directly only when a_tma == 0 (bf16 in the bf16 mode)
  float* c;        // split z writes c + z * m * n; directly if c_tma == 0
  int m, n, k, lda;
  int k_per_split, n_split, m_tiles, n_tiles;
  int a_tma, c_tma;
  int c_bf16;  // the bf16 mode: C is written in bf16 (n_split 1, c_tma 0)
};

// float offset of C's (row r, column c) in a consumer's staging (c even)
template <int BN>
__device__ __forceinline__ int staged_at(int r, int c) {
  if (BN == 8) return r * 8 + c;
  return (c >> 5) * 2048 + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) +
         (c & 3);
}

// This thread's m16n8k8 A fragments of the 64 rows of warpgroup `cw` over
// the tile's 4 k-steps, split: x[4 ks + e] with e = (row g, k t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4) of the warp's 16 rows.
template <bool TRANS_A>
__device__ __forceinline__ void load_a_frags(const uint8_t* tile, int cw,
                                             int w, int g, int t,
                                             uint32_t (&hi)[16],
                                             uint32_t (&lo)[16]) {
  const int r0 = 64 * cw + 16 * w + g;  // tile row (TRANS_A: column)
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    float x[4];
    if (!TRANS_A) {  // (128 rows x 32 k), row r's 16-byte chunk j at j ^ r%8
      const uint8_t* row0 = tile + r0 * 128 + 4 * t;
      const uint8_t* row1 = row0 + 8 * 128;
      const int c0 = ((2 * ks) ^ g) << 4, c1 = ((2 * ks + 1) ^ g) << 4;
      x[0] = *reinterpret_cast<const float*>(row0 + c0);
      x[1] = *reinterpret_cast<const float*>(row1 + c0);
      x[2] = *reinterpret_cast<const float*>(row0 + c1);
      x[3] = *reinterpret_cast<const float*>(row1 + c1);
    } else {  // four (32 k x 32 m) sub-tiles, k row's chunk j at j ^ k%8
      const uint8_t* sub = tile + (r0 >> 5) * 4096 + 4 * (r0 & 3);
      const int mi0 = (r0 & 31) >> 2, mi1 = mi0 + 2;  // chunks of m, m + 8
      const uint8_t* k0 = sub + (8 * ks + t) * 128;
      const uint8_t* k1 = k0 + 4 * 128;
      x[0] = *reinterpret_cast<const float*>(k0 + ((mi0 ^ t) << 4));
      x[1] = *reinterpret_cast<const float*>(k0 + ((mi1 ^ t) << 4));
      x[2] = *reinterpret_cast<const float*>(k1 + ((mi0 ^ (t + 4)) << 4));
      x[3] = *reinterpret_cast<const float*>(k1 + ((mi1 ^ (t + 4)) << 4));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[4 * ks + e], lo[4 * ks + e]);
  }
}

// The producer's fallback for an A that TMA cannot take: 4-byte copies
// into the same swizzled layout, zero beyond m and k_end.
template <bool TRANS_A>
__device__ __forceinline__ void load_a_cp_async(uint8_t* tile,
                                                const GemmArgs& p, int m0,
                                                int k0, int k_end, int lane) {
  for (int i = lane; i < kGemmBM * kGemmBK; i += 32) {
    int r, c, gm, gk;  // (row, column) in the tile's 128-byte rows
    uint8_t* dst;
    if (!TRANS_A) {
      r = i >> 5, c = i & 31, gm = m0 + r, gk = k0 + c;
      dst = tile + r * 128;
    } else {
      const int mc = i & 127;
      r = i >> 7, c = mc & 31, gm = m0 + mc, gk = k0 + r;
      dst = tile + (mc >> 5) * 4096 + r * 128;
    }
    dst += ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
    const bool ok = gm < p.m && gk < k_end;
    const long off = TRANS_A ? static_cast<long>(gk) * p.lda + gm
                             : static_cast<long>(gm) * p.lda + gk;
    cp_async4(reinterpret_cast<float*>(dst), ok ? p.a + off : p.a, ok);
  }
}

// Byte offset of entry (row, col) of a tile of 32 bf16 a row in TMA's
// 64-byte swizzle (the tile on 512 bytes): 16-byte chunk j of row r at
// j ^ ((r >> 1) & 3).
__device__ __forceinline__ int sw64_at(int row, int col) {
  return row * 64 + (((col >> 3) ^ ((row >> 1) & 3)) << 4) + ((col & 7) << 1);
}

// byte offset of A's entry (row m, k) in a bf16 A tile: (128 m x 32 k), or
// with TRANS_A four (32 k x 32 m) sub-tiles
template <bool TRANS_A>
__device__ __forceinline__ int a_bf16_at(int m, int k) {
  return TRANS_A ? (m >> 5) * 2048 + sw64_at(k, m & 31) : sw64_at(m, k);
}

// The bf16 mode's A fragments of the tile's 2 k-steps of 16, read as they
// are: a[4 ks + e] with e = (row g, k 2t, 2t + 1), (g + 8, ...), (g, k
// 2t + 8, 2t + 9), (g + 8, ...) of the warp's 16 rows. A row's k pair is
// one word; in the TRANS_A form two entries of two k rows.
template <bool TRANS_A>
__device__ __forceinline__ void load_a_frags_bf16(const uint8_t* tile,
                                                  int cw, int w, int g, int t,
                                                  uint32_t (&a)[8]) {
  const int r0 = 64 * cw + 16 * w + g;  // tile row (TRANS_A: column)
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1), c = 16 * ks + 2 * t + 8 * (e >> 1);
      if (!TRANS_A) {
        a[4 * ks + e] = *reinterpret_cast<const uint32_t*>(
            tile + a_bf16_at<false>(r, c));
      } else {
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(
            tile + a_bf16_at<true>(r, c));
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(
            tile + a_bf16_at<true>(r, c + 1));
        a[4 * ks + e] = lo | (hi << 16);
      }
    }
  }
}

// The producer's fallback for a bf16 A that TMA cannot take: 2-byte loads
// and shared-memory stores into the same swizzled layout, zero beyond m and
// k_end (the lane then arrives on the stage's barrier).
template <bool TRANS_A>
__device__ __forceinline__ void load_a_bf16_plain(uint8_t* tile,
                                                  const GemmArgs& p, int m0,
                                                  int k0, int k_end,
                                                  int lane) {
  const uint16_t* a = reinterpret_cast<const uint16_t*>(p.a);
  for (int i = lane; i < kGemmBM * kGemmBK; i += 32) {
    const int r = TRANS_A ? i & 127 : i >> 5;  // m in the tile
    const int c = TRANS_A ? i >> 7 : i & 31;   // k in the tile
    const int gm = m0 + r, gk = k0 + c;
    const bool ok = gm < p.m && gk < k_end;
    const long off = TRANS_A ? static_cast<long>(gk) * p.lda + gm
                             : static_cast<long>(gm) * p.lda + gk;
    *reinterpret_cast<uint16_t*>(tile + a_bf16_at<TRANS_A>(r, c)) =
        ok ? a[off] : uint16_t{0};
  }
}

template <int STAGES>
__device__ __forceinline__ void ring_advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) stage = 0, phase ^= 1u;
}

// The k-tiles of unit u of the (m tile, n tile, split) walk: its first row
// and column and its k range; returns the number of k-tiles.
__device__ __forceinline__ int gemm_unit(const GemmArgs& p, int bn, int u,
                                         int& m0, int& n0, int& k_begin,
                                         int& k_end) {
  const int rest = u / p.m_tiles;
  m0 = (u % p.m_tiles) * kGemmBM;
  n0 = (rest % p.n_tiles) * bn;
  k_begin = (rest / p.n_tiles) * p.k_per_split;
  k_end = min(p.k, k_begin + p.k_per_split);
  return k_end > k_begin ? (k_end - k_begin + kGemmBK - 1) / kGemmBK : 0;
}

// Issue one chain of 12 wgmma over the k-tile in stage `st`, from a zero
// accumulator, small terms first: lo*hi and hi*lo of the 4 k-steps, then
// their hi*hi. The truncating adds of the chain then meet the large terms
// only 4 times (8 times in the order lo*hi, hi*lo, hi*hi per k-step, which
// left d_acc at 0.84 of the limit on the card).
template <int BN>
__device__ __forceinline__ void gemm_chain(const uint8_t* st,
                                           float (&d)[BN / 2],
                                           const uint32_t (&a_hi)[16],
                                           const uint32_t (&a_lo)[16]) {
  using L = GemmLayout<BN>;
  const uint64_t bh = sw128_desc(st + L::kABytes);
  const uint64_t bl = bh + (L::kBBytes >> 4);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    Wgmma<BN>::mma(d, &a_lo[4 * ks], bh + 2 * ks, ks);
    Wgmma<BN>::mma(d, &a_hi[4 * ks], bl + 2 * ks, 1);
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    Wgmma<BN>::mma(d, &a_hi[4 * ks], bh + 2 * ks, 1);
  wgmma_commit();
}

// The bf16 mode's chain over the k-tile in stage `st`: two k-steps of 16
// from a zero accumulator.
template <int BN>
__device__ __forceinline__ void gemm_chain_bf16(const uint8_t* st,
                                                float (&d)[BN / 2],
                                                const uint32_t (&a)[8]) {
  const uint64_t b = sw64_desc(st + GemmLayout<BN, true>::kABytes);
  wgmma_fence();
  WgmmaBf16<BN>::mma(d, &a[0], b, 0);
  WgmmaBf16<BN>::mma(d, &a[4], b + 2, 1);
  wgmma_commit();
}

// Wait for the chain, add its sum into acc, hand the stage back.
template <int N>
__device__ __forceinline__ void gemm_retire(float (&acc)[N], float (&d)[N],
                                            uint64_t* empty, int lane) {
  wgmma_wait_all();
  fence_regs(d);
  if (lane == 0) mbar_arrive(empty);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += d[i];
}

// Split z of the K range is [z * k_per_split, (z + 1) * k_per_split); the
// blocks walk the (m tile, n tile, split) units with a stride of the grid.
// BF16: the bf16 mode (see the top of the file).
template <int BN, bool TRANS_A, bool BF16>
__global__ void __launch_bounds__(kGemmThreads, 1)
    split_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap b_map,
                      const __grid_constant__ CUtensorMap c_map,
                      const GemmArgs p) {
  using L = GemmLayout<BN, BF16>;
  // registers moved by setmaxnreg (TF32 at BN = 128 only: the bf16 mode's
  // fragments are a quarter of the TF32 mode's, and it runs on the 168
  // registers a thread is launched with)
  constexpr bool kMoveRegs = BN == 128 && !BF16;
  constexpr int NA = BN / 2;  // accumulator floats per consumer thread
  extern __shared__ uint8_t gemm_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gemm_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + L::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], p.a_tma ? 1 : 1 + 32);
      mbar_init(&empty[s], kGemmConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int units = p.m_tiles * p.n_tiles * p.n_split;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  int m0, n0, k_begin, k_end;

  // At BN = 128 a consumer thread holds 64 floats of C, 64 of a chain's
  // sum and 64 words of A fragments: the producer gives up registers to
  // the consumers (40 and 232 of the 168 a thread of 384 is launched with).
  if (wg == 0) {  // producer: one warp fills the ring
    if (kMoveRegs)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int n_kt = gemm_unit(p, BN, u, m0, n0, k_begin, k_end);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = k_begin + kt * kGemmBK;
        mbar_wait(&empty[stage], phase ^ 1u);
        uint8_t* st = smem + stage * L::kStage;
        if (lane == 0) {
          mbar_expect_tx(&full[stage],
                         L::kBLoad + (p.a_tma ? L::kABytes : 0));
          tma_load_3d(st + L::kABytes, &b_map, &full[stage], k0, n0, 0);
          if (p.a_tma) {
            if (TRANS_A) {
#pragma unroll
              for (int j = 0; j < kGemmBM / 32; ++j)
                tma_load_2d(st + j * (BF16 ? 2048 : 4096), &a_map,
                            &full[stage], m0 + 32 * j, k0);
            } else {
              tma_load_2d(st, &a_map, &full[stage], k0, m0);
            }
          }
        }
        if (!p.a_tma) {
          if constexpr (BF16) {
            load_a_bf16_plain<TRANS_A>(st, p, m0, k0, k_end, lane);
            mbar_arrive(&full[stage]);
          } else {
          load_a_cp_async<TRANS_A>(st, p, m0, k0, k_end, lane);
          mbar_arrive_cp_async(&full[stage]);
          }
        }
        ring_advance<L::kStages>(stage, phase);
      }
    }
    return;
  }

  // consumers: warpgroup cw takes rows [64 cw, 64 cw + 64) of each tile
  if (kMoveRegs)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* staged = reinterpret_cast<float*>(smem + L::kStages * L::kStage) +
                  cw * 64 * BN;
  const int bar_id = 1 + cw;  // named barrier of this warpgroup

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int n_kt = gemm_unit(p, BN, u, m0, n0, k_begin, k_end);
    float acc[NA], d[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = d[i] = 0.0f;
    if constexpr (BF16) {
      // the same walk over the k-tiles with the bf16 fragments and chains
      uint32_t a0[8], a1[8];
      if (n_kt > 0) {
        mbar_wait(&full[stage], phase);
        load_a_frags_bf16<TRANS_A>(smem + stage * L::kStage, cw, w, g, t, a0);
      }
      for (int kt = 0; kt < n_kt; kt += 2) {
        int s = stage;
        ring_advance<L::kStages>(stage, phase);
        gemm_chain_bf16<BN>(smem + s * L::kStage, d, a0);
        if (kt + 1 < n_kt) {
          mbar_wait(&full[stage], phase);
          load_a_frags_bf16<TRANS_A>(smem + stage * L::kStage, cw, w, g, t,
                                     a1);
        }
        gemm_retire(acc, d, &empty[s], lane);
        if (kt + 1 >= n_kt) break;
        s = stage;
        ring_advance<L::kStages>(stage, phase);
        gemm_chain_bf16<BN>(smem + s * L::kStage, d, a1);
        if (kt + 2 < n_kt) {
          mbar_wait(&full[stage], phase);
          load_a_frags_bf16<TRANS_A>(smem + stage * L::kStage, cw, w, g, t,
                                     a0);
        }
        gemm_retire(acc, d, &empty[s], lane);
      }
    } else {
    // A fragments of two k-tiles: the next is loaded while a chain runs
    uint32_t ah0[16], al0[16], ah1[16], al1[16];
    if (n_kt > 0) {
      mbar_wait(&full[stage], phase);
      load_a_frags<TRANS_A>(smem + stage * L::kStage, cw, w, g, t, ah0, al0);
    }
    // tiles in pairs, so that the fragment buffers are named at compile time
    for (int kt = 0; kt < n_kt; kt += 2) {
      int s = stage;
      ring_advance<L::kStages>(stage, phase);
      gemm_chain<BN>(smem + s * L::kStage, d, ah0, al0);
      if (kt + 1 < n_kt) {
        mbar_wait(&full[stage], phase);
        load_a_frags<TRANS_A>(smem + stage * L::kStage, cw, w, g, t, ah1,
                              al1);
      }
      gemm_retire(acc, d, &empty[s], lane);
      if (kt + 1 >= n_kt) break;
      s = stage;
      ring_advance<L::kStages>(stage, phase);
      gemm_chain<BN>(smem + s * L::kStage, d, ah1, al1);
      if (kt + 2 < n_kt) {
        mbar_wait(&full[stage], phase);
        load_a_frags<TRANS_A>(smem + stage * L::kStage, cw, w, g, t, ah0,
                              al0);
      }
      gemm_retire(acc, d, &empty[s], lane);
    }
    }

    // epilogue: C through shared memory, then a TMA store of the
    // warpgroup's 64 rows (or, where TMA cannot take C, 16-byte runs of
    // rows stored by the threads); the next unit's chains start while the
    // store drains
    if (p.c_tma && tid == 0)  // the last store has read the staging
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int r = 16 * w + g, c = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(staged + staged_at<BN>(r, c)) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(staged + staged_at<BN>(r + 8, c)) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    const int z = k_begin / p.k_per_split;
    if (p.c_tma) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
      if (tid == 0) {
#pragma unroll
        for (int j = 0; j < (BN + 31) / 32; ++j)
          tma_store_3d(&c_map, staged + 2048 * j, n0 + 32 * j, m0 + 64 * cw,
                       z);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      continue;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if constexpr (BF16) {
      if (p.c_bf16) {  // C rounded to bf16 once, four entries a store
        uint16_t* c16 = reinterpret_cast<uint16_t*>(p.c);
        const bool vec8 = p.n % 4 == 0 &&
                          (reinterpret_cast<uintptr_t>(c16) & 7u) == 0;
        for (int i = tid; i < 64 * (BN / 4); i += 128) {
          const int r = i / (BN / 4), c4 = 4 * (i % (BN / 4));
          const int row = m0 + 64 * cw + r, col = n0 + c4;
          if (row >= p.m || col >= p.n) continue;
          const float* src = staged + staged_at<BN>(r, c4);
          uint16_t* dst = c16 + static_cast<long>(row) * p.n + col;
          if (vec8 && col + 4 <= p.n) {
            *reinterpret_cast<uint2*>(dst) =
                make_uint2(pack_bf16x2(src[0], src[1]),
                           pack_bf16x2(src[2], src[3]));
          } else {
            for (int e = 0; e < 4 && col + e < p.n; ++e)
              dst[e] = static_cast<uint16_t>(pack_bf16x2(src[e], 0.0f));
          }
        }
        continue;
      }
    }
    float* c = p.c + static_cast<long>(z) * p.m * p.n;
    const bool vec = p.n % 4 == 0 && aligned16(c);
    for (int i = tid; i < 64 * (BN / 4); i += 128) {
      const int r = i / (BN / 4), c4 = 4 * (i % (BN / 4));
      const int row = m0 + 64 * cw + r, col = n0 + c4;
      if (row >= p.m || col >= p.n) continue;
      const float* src = staged + staged_at<BN>(r, c4);
      float* dst = c + static_cast<long>(row) * p.n + col;
      if (vec && col + 4 <= p.n) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int e = 0; e < 4 && col + e < p.n; ++e) dst[e] = src[e];
      }
    }
  }
  if (p.c_tma && tid == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// hi / lo (n_pad, k_pad) = the TF32 parts of b^T, b (k, n) row-major; zero
// beyond k and n. (32 x 32) tiles through shared memory: both sides move in
// whole rows.
__global__ void split_gemm_kernel_b(const float* __restrict__ b, int k, int n,
                                    float* __restrict__ hi,
                                    float* __restrict__ lo, int k_pad,
                                    int n_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int kk = k0 + r, nn = n0 + threadIdx.x;
    tile[r][threadIdx.x] =
        kk < k && nn < n ? b[static_cast<long>(kk) * n + nn] : 0.0f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int nn = n0 + r, kk = k0 + threadIdx.x;
    if (nn >= n_pad) break;
    uint32_t h, l;
    split_tf32(tile[threadIdx.x][r], h, l);
    const long at = static_cast<long>(nn) * k_pad + kk;
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

// b (k, n) row-major -> bt (n_pad, k_pad) bf16 bits of b^T, rounded to the
// nearest (ties to even); zero beyond k and n
__global__ void split_gemm_kernel_b_bf16(const float* __restrict__ b, int k,
                                         int n,
                                         unsigned short* __restrict__ bt,
                                         int k_pad, int n_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int kk = k0 + r, nn = n0 + threadIdx.x;
    tile[r][threadIdx.x] =
        kk < k && nn < n ? b[static_cast<long>(kk) * n + nn] : 0.0f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int nn = n0 + r, kk = k0 + threadIdx.x;
    if (nn >= n_pad) break;
    unsigned short h;
    asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(tile[threadIdx.x][r]));
    bt[static_cast<long>(nn) * k_pad + kk] = h;
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

// ---- host side

inline int gemm_round_up(int x, int to) { return (x + to - 1) / to * to; }

// N-tile of the product: 8 for N <= 8, 128 for N >= 1,024, else 64
inline int gemm_bn(int n) { return n <= 8 ? 8 : n >= 1024 ? 128 : 64; }

using TensorMapEncoder = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's
// entry-point query so that the library needs no link against libcuda
inline TensorMapEncoder tensor_map_encoder() {
  static const TensorMapEncoder fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncoder>(f)
               : nullptr;
  }();
  return fn;
}

// f32 tensor map, in the 128-byte swizzle unless `dense`, zero fill out of
// bounds; dims and box innermost first, strides in bytes of every
// dimension but the first. `bf16`: a bf16 map in the 64-byte swizzle.
inline bool encode_map(CUtensorMap* map, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box, bool dense = false,
                       bool bf16 = false) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                rank, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                bf16    ? CU_TENSOR_MAP_SWIZZLE_64B
                : dense ? CU_TENSOR_MAP_SWIZZLE_NONE
                        : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the products launched so far in this process, [0] TF32, [1] bf16
inline long long* product_launches() {
  static long long n[2] = {0, 0};
  return n;
}

inline int gemm_sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  return sms;
}

template <int BN, bool TRANS_A, bool BF16>
int launch_split_gemm(const CUtensorMap& a_map, const CUtensorMap& b_map,
                      const CUtensorMap& c_map, const GemmArgs& p,
                      cudaStream_t stream) {
  using L = GemmLayout<BN, BF16>;
  auto kernel = split_gemm_kernel<BN, TRANS_A, BF16>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long units = static_cast<long>(p.m_tiles) * p.n_tiles * p.n_split;
  const int grid = static_cast<int>(units < gemm_sm_count() ? units
                                                            : gemm_sm_count());
  kernel<<<grid, kGemmThreads, L::kBytes, stream>>>(a_map, b_map, c_map, p);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++product_launches()[BF16];
  return static_cast<int>(launched);
}

// the instantiation of N-tile bn and form trans_a
template <bool BF16>
int launch_split_gemm_for(int bn, bool trans_a, const CUtensorMap& a_map,
                          const CUtensorMap& b_map, const CUtensorMap& c_map,
                          const GemmArgs& p, cudaStream_t stream) {
  if (bn == 8)
    return trans_a ? launch_split_gemm<8, true, BF16>(a_map, b_map, c_map, p,
                                                       stream)
                   : launch_split_gemm<8, false, BF16>(a_map, b_map, c_map,
                                                        p, stream);
  if (bn == 128)
    return trans_a ? launch_split_gemm<128, true, BF16>(a_map, b_map, c_map,
                                                         p, stream)
                   : launch_split_gemm<128, false, BF16>(a_map, b_map, c_map,
                                                          p, stream);
  return trans_a ? launch_split_gemm<64, true, BF16>(a_map, b_map, c_map, p,
                                                      stream)
                 : launch_split_gemm<64, false, BF16>(a_map, b_map, c_map, p,
                                                       stream);
}

// c (n_split, m, n) = per split of k, a * b. a is (m, k) row-major, or
// (k, m) with trans_a; b is (k, n) row-major; bt is 16-byte aligned scratch
// for B split and transposed: hi and lo, each (n padded to the N-tile, k
// padded to 32), or with bf16 one such array of bf16 (ops/fused_cconv.py
// `gemm_b_floats`). k_per_split is a multiple of 32 (only read when
// n_split > 1). Ragged edges are zero-filled by TMA (or by the fallback's
// copies). BF16: the bf16 mode, a then holds bf16 entries (row stride lda
// = its row length); c_bf16 (n_split 1): c is written in bf16. A source
// instantiates the mode it calls, and only its kernels.
template <bool BF16 = false>
inline int split_gemm(const void* a_in, const float* b, void* c_out,
                      float* bt, int m, int n, int k, bool trans_a,
                      int n_split, int k_per_split, cudaStream_t stream,
                      bool c_bf16 = false) {
  constexpr bool bf16 = BF16;
  const float* a = static_cast<const float*>(a_in);
  float* c = static_cast<float*>(c_out);
  if (m <= 0 || n <= 0 || n_split <= 0) return 0;
  if (bt == nullptr || !aligned16(bt) || (c_bf16 && (!bf16 || n_split != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_split == 1) k_per_split = gemm_round_up(k < 1 ? 1 : k, kGemmBK);
  if (k_per_split <= 0 || k_per_split % kGemmBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = gemm_bn(n);
  const int n_pad = gemm_round_up(n, bn);
  const int k_pad = gemm_round_up(k < 1 ? 1 : k, kGemmBK);
  float* bt_lo = bt + static_cast<long>(n_pad) * k_pad;
  if constexpr (BF16)
    split_gemm_kernel_b_bf16<<<dim3(k_pad / 32, (n_pad + 31) / 32),
                               dim3(32, 8), 0, stream>>>(
        b, k, n, reinterpret_cast<unsigned short*>(bt), k_pad, n_pad);
  else
    split_gemm_kernel_b<<<dim3(k_pad / 32, (n_pad + 31) / 32), dim3(32, 8),
                          0, stream>>>(b, k, n, bt, bt_lo, k_pad, n_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs p{a, c, m, n, k, trans_a ? m : k, k_per_split, n_split,
             (m + kGemmBM - 1) / kGemmBM, n_pad / bn, 0, 0};
  // TMA takes rows whose stride is a multiple of 16 bytes
  p.a_tma = aligned16(a) && p.lda % (bf16 ? 8 : 4) == 0;
  p.c_tma = !c_bf16 && aligned16(c) && n % 4 == 0;
  p.c_bf16 = c_bf16 ? 1 : 0;
  CUtensorMap a_map{}, b_map{}, c_map{};
  // (k_pad, n_pad, parts): TF32 hi and lo, or one bf16 array
  const cuuint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(k_pad),
                                static_cast<cuuint64_t>(n_pad),
                                bf16 ? 1ull : 2ull};
  const cuuint64_t b_strides[2] = {elem * k_pad, elem * k_pad * n_pad};
  const cuuint32_t b_box[3] = {kGemmBK, static_cast<cuuint32_t>(bn),
                               bf16 ? 1u : 2u};
  if (!encode_map(&b_map, bt, 3, b_dims, b_strides, b_box, false, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.a_tma) {
    const cuuint64_t a_dims[2] = {
        static_cast<cuuint64_t>(trans_a ? m : (k < 1 ? 1 : k)),
        static_cast<cuuint64_t>(trans_a ? (k < 1 ? 1 : k) : m)};
    const cuuint64_t a_strides[1] = {elem * p.lda};
    const cuuint32_t a_box[2] = {kGemmBK, trans_a ? 32u : kGemmBM};
    if (!encode_map(&a_map, a, 2, a_dims, a_strides, a_box, false, bf16))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.c_tma) {  // (n_split, m, n), stored in (64 x 32) or (64 x 8) boxes
    const cuuint64_t c_dims[3] = {static_cast<cuuint64_t>(n),
                                  static_cast<cuuint64_t>(m),
                                  static_cast<cuuint64_t>(n_split)};
    const cuuint64_t c_strides[2] = {4ull * n, 4ull * n * m};
    const cuuint32_t c_box[3] = {bn == 8 ? 8u : 32u, 64, 1};
    if (!encode_map(&c_map, c, 3, c_dims, c_strides, c_box, bn == 8))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_split_gemm_for<BF16>(bn, trans_a, a_map, b_map, c_map, p,
                                     stream);
}

}  // namespace nf
