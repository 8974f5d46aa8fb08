// K1d and K2d: K1 and K2 (fused_cconv.cu) at precision 'default'.
//
// Precision 'default' (the JAX package's `DEFAULT`: one bf16 MXU pass per
// dot in the Pallas bodies, f32 accumulation) is K1d and K2d: the same
// functions, with each operand of each contraction rounded to bf16 (round
// to nearest even) once, every product and sum in f32:
//   the slab sum        acc += bf(w_t) bf(f)
//   the fold            out  = bf(acc) bf(W)
//   d_acc               = bf(ct) bf(W)^T
//   the slab dot's VJP  g_t = <bf(d_acc[t]), bf(f)>,  dfeats += bf(w_t)
//                       bf(d_acc[t])
//   dW                  = bf(acc)^T bf(ct)
// as JAX's transpose of a `DEFAULT` dot rounds the cotangent and the other
// operand. They replace the same TPU kernels (`_fwd_kernel`, `_bwd_kernel`
// at `precision=DEFAULT`) with kernels of their own, `walk_fwd_bf16_kernel`
// and `walk_bwd_bf16_kernel` (the f32 walks of fused_cconv.cu, whose device
// helpers this file includes, are left as they were):
// * Each operand is rounded once, where it is staged: the features into a
//   bf16 copy per call (`to_bf16_kernel`, read by the tiles' `cp.async` at
//   half the bytes), the tap weights in phase 1, W as it is staged, ct
//   into a bf16 copy (K2d), d_acc by the product's epilogue or the in-walk
//   contraction, the accumulator as its rows are written. No operand is
//   rounded again at a use, as the `BF16` instantiations of the f32 walks
//   did at every pair (0.75 ms of K1d's 2.16 a ParticleNet step went with
//   that phase on an H100, PERF.md).
// * The tap-feature contraction of the forward walk runs on the bf16
//   tensor cores (`mma.sync.m16n8k16`): per tile of 128 candidates and
//   query, A (64 taps x the query's in-radius pairs, packed from the
//   phase-1 ballots, 16 a k-step) and B (the pairs' feature rows) go into
//   the fragments by `ldmatrix`: each lane places 4 of a pair's 8 corner
//   weights into its warp's A tile in shared memory and takes them out
//   again after the k-step, B's rows are gathered straight from the tile.
//   The (64, Cin) accumulator stays in registers (a query's four m-tiles
//   over 8 / QB warps). A query's pairs of a tile (about 16 at the bench
//   point, one in eight candidates) fill about one k-step, an eighth of
//   JAX's dense (64 taps x candidates) form. Building A by a corner test
//   per fragment entry in registers, over tiles of 32, was slower than the
//   f32 walk on an H100 (PERF.md). What bounds the walk is then its
//   registers: 2 QB NT accumulator floats a thread keep 4 queries in a
//   block at Cin 64 and 96 (`bf16_fwd_qb`), one block of 8 warps an SM.
// * The rows go out in bf16 (half the scratch bytes of the f32 walk, and
//   the bf16 product reads A by TMA as it is); the in-walk fold (W <= 64
//   KB) stages bf(acc) and bf(W)^T in shared memory and is a tensor-core
//   product too.
// * K2d: of the slab dot's VJP, the tap cotangents run on the tensor
//   cores as d_acc (64 taps x Cin) F^T over 8 of the query's pairs at a
//   time, of which each pair's 8 corner entries are kept: 8x the SIMT
//   form's products at the tensor-core rate, without its 9 shuffles a
//   pair. dfeats stays on the f32 pipes over the bf16 operands: as a dense
//   product (pairs x 64 taps x Cin per query) it would compute 8x its
//   products and then need a sum per candidate across the block's queries,
//   which the SIMT form does in registers. The in-walk d_acc (W <= 64 KB:
//   Cout 32 or 3) stays on the f32 pipes too: a k-step of 16 over Cout
//   and a 16-row tile over the block's queries would be mostly padding.
//   The geometry adjoint (`pair_vjp`) stays f32. d_acc is held in bf16,
//   twice the queries a block of the f32 walk holds.
// The products of bf16 values are exact in f32; the tensor cores' sums
// are f32, so the results differ from the plain version's only in the
// order of the f32 sums and in the bf16 rounding of a sum on a rounding
// edge (bf(acc), bf(d_acc)).

#define NF_CCONV_HELPERS_ONLY
#include "fused_cconv.cu"

namespace {

// ---- precision 'default': the bf16 walks of K1d and K2d (top of file)

constexpr int kBf16Threads = 256;
constexpr int kBf16Warps = kBf16Threads / 32;
// candidates per tile of the bf16 forward walk: a query's pairs of a tile
// fill about one k-step of 16 (about one candidate in eight is in radius)
constexpr int kTileF = 128;
// the code of a tap row past the grid: a corner of no pair (`corner_of`)
constexpr unsigned kNoTap = 0u;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// n-tiles of 8 channels the forward walk holds per tap (a template
// constant: 1, 2, 4, 8, 12 or 16; -1 past 128 channels) and the queries a
// block then takes, a thread's accumulator (2 QB NT floats) within 128
// registers: 8 up to Cin 32, and at Cin 64 where the block folds W (it
// walks a group's tiles half as often); 4 at Cin 64 where it writes rows
// (on an H100 8 were 0.07 ms slower at conv2, 0.12 faster at conv3) and
// at Cin 96
__host__ __device__ constexpr int bf16_ntiles(int cin) {
  const int nt = (cin + 7) / 8;
  return nt <= 2 ? nt : nt <= 4 ? 4 : nt <= 8 ? 8 : nt <= 12 ? 12
         : nt <= 16 ? 16 : -1;
}

__host__ __device__ constexpr int bf16_fwd_qb(int nt, bool fold) {
  return nt <= 4 || (fold && nt <= 8) ? 8 : nt <= 12 ? 4 : 2;
}

// channels of a row of the bf16 copy of the features (zero past cin)
__host__ __device__ constexpr int bf16_feat_width(int cin) {
  return round16(8 * bf16_ntiles(cin));
}

// Byte offsets of the bf16 forward walk's dynamic shared memory (mirrored
// by ops/fused_cconv.py `bf16_fwd_smem_bytes`). kw: the row stride of W^T
// and of the staged rows in the in-walk fold, 16 bytes past the k range
// padded to 16 (banks).
struct Bf16FwdSmem {
  int fe, zrow, w8, cp, pc, qmask, atile, wts, arow, red, qp, qn, qcnt,
      plist, bytes, kw;
};

// a warp's A tile in the bf16 forward walk: its m-tiles (16 taps each) of
// 16 pair ranks, rows kArow bf16 (48 bytes) apart, so that the 8 rows an
// `ldmatrix` reads fall on 32 different banks
constexpr int kArow = 24;

__host__ __device__ inline Bf16FwdSmem bf16_fwd_smem(int qb, int nt,
                                                     int klen, int cout,
                                                     bool fold) {
  Bf16FwdSmem L{};
  const int fs = 8 * nt + 8, pairs = qb * kTileF;
  L.kw = fold ? round16(klen) + 8 : 0;
  L.fe = 0;                                   // 2 tiles of kTileF rows of fs
  L.zrow = L.fe + 2 * kTileF * fs * 2;        // fs zeros
  L.w8 = L.zrow + fs * 2;                     // 8 bf16 weights per pair
  L.cp = L.w8 + pairs * 16;                   // 2 tiles of positions
  L.pc = L.cp + 2 * kTileF * 3 * 4;           // a corner code per pair
  L.qmask = L.pc + pairs * 4;                 // in-radius ballots
  L.atile = L.qmask + pairs / 8;              // 8 warps' A tiles, qb / 2
  L.wts = L.atile + qb * 8 * 16 * kArow;      // m-tiles each; fold: W^T
  L.arow = L.wts + (fold ? cout * L.kw * 2 : 0);   // fold: (qb, kw) bf16
  L.red = L.arow + (fold ? qb * L.kw * 2 : 0);     // fold: (8, qb, 32) f32
  L.qp = L.red + (fold ? kBf16Warps * qb * 32 * 4 : 0);
  L.qn = L.qp + qb * 3 * 4;
  L.qcnt = L.qn + qb * 4;
  L.plist = L.qcnt + qb * 4;                  // the query's pairs by rank
  L.bytes = L.plist + pairs;
  return L;
}

// Byte offsets of the bf16 backward walk's dynamic shared memory (mirrored
// by ops/fused_cconv.py `bf16_bwd_smem_bytes`): d_acc of the block's
// queries and the tile in rows of ds = round16(cin) + 8 bf16.
struct Bf16BwdSmem {
  int dacc, fe, zrow, w8, g8s, cp, pc, wts, sct, qp, sdq, qmask, qn, plist,
      bytes, ds, kwt, cs;
};

__host__ __device__ inline Bf16BwdSmem bf16_bwd_smem(int qb, int cin,
                                                     int cout, int klen,
                                                     bool local) {
  Bf16BwdSmem L{};
  const int pairs = qb * kTile;
  L.ds = round16(cin) + 8;
  L.kwt = local ? klen + 8 : 0;
  L.cs = round16(cout) + 8;
  L.dacc = 0;                                  // (qb, 64 taps, ds)
  L.fe = L.dacc + qb * 64 * L.ds * 2;          // 2 tiles of kTile rows
  L.zrow = L.fe + 2 * kTile * L.ds * 2;        // ds zeros
  L.w8 = L.zrow + L.ds * 2;                    // 8 bf16 weights per pair
  L.g8s = L.w8 + pairs * 16;                   // 8 f32 per pair
  L.cp = L.g8s + pairs * 32;
  L.pc = L.cp + 2 * kTile * 3 * 4;
  L.wts = L.pc + pairs * 4;                    // local: W^T (cout, kwt)
  L.sct = L.wts + (local ? (cout * L.kwt * 2 + 15) / 16 * 16 : 0);
  L.qp = L.sct + (local ? qb * L.cs * 2 : 0);  // local: bf(ct) (qb, cs)
  L.sdq = L.qp + qb * 3 * 4;
  L.qmask = L.sdq + qb * 3 * 4;
  L.qn = L.qmask + qb * 4;
  L.plist = L.qn + qb * 4;
  L.bytes = L.plist + pairs;
  return L;
}

// f32 -> bf16 bits, round to nearest even
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
  return h;
}

__device__ __forceinline__ float bf16_value(uint32_t h) {
  return __uint_as_float(h << 16);
}

// d += a b, one mma.sync m16n8k16 on bf16 with f32 accumulation: a the A
// fragment (rows g and g + 8 of 16; k 2t, 2t + 1, then 2t + 8, 2t + 9), b0
// and b1 B's (k 2t, 2t + 1 and 2t + 8, 2t + 9 of column g), each word two
// bf16 with the lower k in the low half; d rows g (d0, d1) and g + 8 (d2,
// d3), columns 2t, 2t + 1
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the code of filter tap `tap`, each axis index biased by 64: (ix + 64) |
// (iy + 64) << 8 | (iz + 64) << 16, so that a pair's corner code (ix | iy
// << 8 | iz << 16, `pair_geometry_bf16`) subtracts from it axis by axis
// with no borrow
__device__ __forceinline__ unsigned tap_code(int tap, int n_taps, int ky,
                                             int kx) {
  if (tap >= n_taps) return kNoTap;
  return static_cast<unsigned>(tap % kx + 64) |
         (static_cast<unsigned>((tap / kx) % ky + 64) << 8) |
         (static_cast<unsigned>(tap / (kx * ky) + 64) << 16);
}

// the corner (dz * 4 + dy * 2 + dx) that the tap with code tc is of the
// pair with corner code pc, or -1: each axis difference must be 0 or 1
__device__ __forceinline__ int corner_of(unsigned tc, unsigned pc) {
  const unsigned d = tc - pc;
  if ((d & 0x00FEFEFEu) != 0x00404040u) return -1;
  return static_cast<int>((d & 1u) | ((d >> 7) & 2u) | ((d >> 14) & 4u));
}

__device__ __forceinline__ int tap_of(unsigned code, int ky, int kx) {
  return (static_cast<int>(code >> 16) * ky +
          static_cast<int>((code >> 8) & 0xffu)) * kx +
         static_cast<int>(code & 0xffu);
}

// Fragments of a mma.sync m16n8k16 from bf16 rows in shared memory, 16
// bytes of a row each: lanes 8 i to 8 i + 7 name the 8 rows of matrix i.
// Plain, r[i] holds (row g; columns 2t, 2t + 1) of matrix i: the A
// fragment of a row-major (16 x 16) A from matrices (rows 0-7, k 0-7),
// (8-15, 0-7), (0-7, 8-15), (8-15, 8-15). Transposed, (rows 2t, 2t + 1;
// column g): B's fragment from rows of k, 8 n wide.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const uint16_t* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(nf::smem_addr(row))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint16_t* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(nf::smem_addr(row))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const uint16_t* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(nf::smem_addr(row))
      : "memory");
}

// Phase 1 of the bf16 walks for the pair p of (query q, candidate j of the
// tile): the in-radius test and geometry of `pair_geometry`; for a pair in
// radius its first corner's code pc[p] (ix | iy << 8 | iz << 16) and its 8
// windowed corner weights rounded to bf16 once, w8[8 p + c].
__device__ __forceinline__ bool pair_geometry_bf16(
    const float* cp, const float* qp, int q, int j, bool live, float inv_r,
    int exclude_self, int kz, int ky, int kx, int p, unsigned* pc,
    uint16_t* w8) {
  bool within = false;
  if (live) {
    float ox, oy, oz, d2n;
    pair_offset(cp, qp, q, j, inv_r, ox, oy, oz, d2n);
    within = d2n <= 1.0f && (!exclude_self || d2n > 0.0f);
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
      pc[p] = static_cast<unsigned>(ix) | (static_cast<unsigned>(iy) << 8) |
              (static_cast<unsigned>(iz) << 16);
      const float wz[2] = {(1.0f - fz) * win, fz * win};
      const float wy[2] = {1.0f - fy, fy};
      const float wx[2] = {1.0f - fx, fx};
      *reinterpret_cast<uint4*>(w8 + 8 * p) = make_uint4(
          nf::pack_bf16x2(wz[0] * wy[0] * wx[0], wz[0] * wy[0] * wx[1]),
          nf::pack_bf16x2(wz[0] * wy[1] * wx[0], wz[0] * wy[1] * wx[1]),
          nf::pack_bf16x2(wz[1] * wy[0] * wx[0], wz[1] * wy[0] * wx[1]),
          nf::pack_bf16x2(wz[1] * wy[1] * wx[0], wz[1] * wy[1] * wx[1]));
    }
  }
  return within;
}

// the first `TILE` candidates of tile t of the walk (as `tile_rows`)
template <int TILE>
__device__ __forceinline__ void tile_rows_n(int t, int total,
                                            const int* s_start,
                                            const int* s_len, int* rows) {
  for (int j = threadIdx.x; j < TILE; j += blockDim.x) {
    const int flat = t * TILE + j;
    rows[j] = flat < total ? flat_row(flat, s_start, s_len) : 0;
  }
}

// start the asynchronous copy of a tile's positions and bf16 feature rows
// (`chunks` 16-byte chunks of a row of the copy, fw channels apart, into
// rows fs channels apart)
__device__ __forceinline__ void fetch_tile_bf16(
    uint16_t* fe, float* cp, const uint16_t* __restrict__ fbf, int fw,
    const float* __restrict__ cpos, const int* rows, int nc, int chunks,
    int fs) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int i = tid; i < nc * 3; i += nthreads)
    nf::cp_async4(cp + i, cpos + static_cast<long>(rows[i / 3]) * 3 + i % 3,
                  true);
  for (int i = tid; i < nc * chunks; i += nthreads) {
    const int j = i / chunks, k = i - j * chunks;
    nf::cp_async16(reinterpret_cast<float*>(fe + j * fs + 8 * k),
                   reinterpret_cast<const float*>(
                       fbf + static_cast<long>(rows[j]) * fw + 8 * k));
  }
}

// bf16(v0), bf16(v1) into dst[idx], dst[idx + 1] where each is below lim
// (one word where both are and idx is even)
__device__ __forceinline__ void store_bf16_pair(uint16_t* dst, int idx,
                                                int c, int lim, float v0,
                                                float v1) {
  if (c + 1 < lim && (idx & 1) == 0) {
    *reinterpret_cast<uint32_t*>(dst + idx) = nf::pack_bf16x2(v0, v1);
  } else {
    if (c < lim) dst[idx] = bf16_bits(v0);
    if (c + 1 < lim) dst[idx + 1] = bf16_bits(v1);
  }
}

// The forward walk at precision 'default', work items as in
// walk_fwd_kernel but tiles of kTileF candidates: QB queries a block, NT
// n-tiles of 8 channels; the tile features come from the bf16 copy fbf
// (rows of fw). Per tile, phase 1 (a warp per 32 candidates of a query)
// finds the pairs in radius and packs each query's in candidate order;
// then each query's WQ warps contract its pairs' tap weights (A: 64 taps x
// 16 pair ranks, placed in each warp's A tile) with their features (B: 16
// ranks x 8 channels, the pairs' rows gathered) on the tensor cores, both
// read by `ldmatrix`, 16 pairs a k-step, the accumulator (64 taps x 8 NT
// channels per query, MT m-tiles a warp) in registers. FOLD: W is staged
// into shared memory once, as bf16 W^T; the accumulator rows go there in
// bf16 and out (Nq, Cout) = bf(acc) bf(W) is a tensor-core product over k
// split across the warps, their sums added in order. Otherwise bf(acc)
// goes to rows ((row_hi - row_lo), 64 * Cin) in bf16, row - row_lo. cnt
// (absolute rows) may be null.
template <int QB, int NT, bool FOLD>
__global__ void __launch_bounds__(kBf16Threads, 1) walk_fwd_bf16_kernel(
    const int* __restrict__ gcol, const int* __restrict__ gzlo,
    const int* __restrict__ gzhi, const int* __restrict__ gstart,
    const int* __restrict__ pstarts, const float* __restrict__ qpos,
    const float* __restrict__ cpos, const uint16_t* __restrict__ fbf, int fw,
    const float* __restrict__ w, float* __restrict__ out,
    uint16_t* __restrict__ rows, float* __restrict__ cnt, int n_items,
    int ysplit, int row_lo, int row_hi, int d0, int d1, int d2, int kz,
    int ky, int kx, int cin, int cout, float inv_r, int exclude_self) {
  constexpr int WQ = kBf16Warps / QB;  // warps per query
  constexpr int MT = 4 / WQ;           // m-tiles of 16 taps per warp
  constexpr int FS = 8 * NT + 8;       // a tile row, bf16 (+16 bytes: banks)
  static_assert(WQ * QB == kBf16Warps && MT * WQ == 4, "64 taps a query");
  extern __shared__ __align__(16) uint8_t smem8[];
  __shared__ int s_start[9], s_len[9], s_rows[3][kTileF];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int n_taps = kz * ky * kx, klen = n_taps * cin;
  const Bf16FwdSmem L = bf16_fwd_smem(QB, NT, klen, cout, FOLD);
  unsigned* qmask = reinterpret_cast<unsigned*>(smem8 + L.qmask);
  uint16_t* fe = reinterpret_cast<uint16_t*>(smem8 + L.fe);
  uint16_t* zrow = reinterpret_cast<uint16_t*>(smem8 + L.zrow);
  uint16_t* w8 = reinterpret_cast<uint16_t*>(smem8 + L.w8);
  float* cp = reinterpret_cast<float*>(smem8 + L.cp);
  unsigned* pc = reinterpret_cast<unsigned*>(smem8 + L.pc);
  uint16_t* wts = reinterpret_cast<uint16_t*>(smem8 + L.wts);
  uint16_t* arow = reinterpret_cast<uint16_t*>(smem8 + L.arow);
  float* red = reinterpret_cast<float*>(smem8 + L.red);
  float* qp = reinterpret_cast<float*>(smem8 + L.qp);
  int* qn = reinterpret_cast<int*>(smem8 + L.qn);
  int* qcnt = reinterpret_cast<int*>(smem8 + L.qcnt);
  uint8_t* plist = smem8 + L.plist;
  const int kw = L.kw, kpad = round16(klen);

  // this warp's query, its m-tiles and its A tile; the 4 corners this lane
  // places in it for a pair (`cof`: their tap offsets from the first)
  const int wq = warp / WQ, mt0 = (warp % WQ) * MT;
  uint16_t* atile =
      reinterpret_cast<uint16_t*>(smem8 + L.atile) + warp * MT * 16 * kArow;
  const int srank = lane & 15, sc0 = 4 * (lane >> 4);
  const int cof[4] = {sc0 * ky * kx / 4, sc0 * ky * kx / 4 + 1,
                      sc0 * ky * kx / 4 + kx, sc0 * ky * kx / 4 + kx + 1};

  for (int i = tid; i < FS; i += nthreads) zrow[i] = 0;
  for (int i = tid; i < kBf16Warps * MT * 16 * kArow; i += nthreads)
    reinterpret_cast<uint16_t*>(smem8 + L.atile)[i] = 0;
  if (FOLD) {
    for (int i = tid; i < cout * kw; i += nthreads) {
      const int o = i / kw, k = i - o * kw;
      wts[i] = k < klen ? bf16_bits(w[static_cast<long>(k) * cout + o]) : 0;
    }
    for (int i = tid; i < QB * kw; i += nthreads) arow[i] = 0;
  }

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int gi = item / ysplit, y = item % ysplit;
    const int col = gcol[gi];
    if (col >= d0 * d1) continue;  // empty tail group: owns no rows
    const int lo = max(gstart[gi], row_lo), hi = min(gstart[gi + 1], row_hi);
    if (lo >= hi) continue;
    __syncthreads();  // the last item's readers of the slabs are done
    group_slabs(col, gzlo[gi], gzhi[gi], pstarts, d0, d1, d2, s_start, s_len);
    __syncthreads();
    const int total = count_candidates(s_len);
    const int n_tiles = (total + kTileF - 1) / kTileF;

    for (int b0 = lo + y * QB; b0 < hi; b0 += ysplit * QB) {
      const int nq = min(QB, hi - b0);
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      if (tid < QB * 3)
        qp[tid] = tid / 3 < nq ? qpos[static_cast<long>(b0) * 3 + tid] : 0.0f;
      if (tid < QB) qcnt[tid] = 0;
      tile_rows_n<kTileF>(0, total, s_start, s_len, s_rows[0]);
      tile_rows_n<kTileF>(1, total, s_start, s_len, s_rows[1]);
      __syncthreads();

      if (n_tiles > 0)
        fetch_tile_bf16(fe, cp, fbf, fw, cpos, s_rows[0], min(kTileF, total),
                        NT, FS);
      nf::cp_async_commit();
      for (int t = 0; t < n_tiles; ++t) {
        const int buf = t & 1;
        nf::cp_async_wait<0>();  // tile t has landed
        __syncthreads();  // ... for every thread; tile t - 1 is consumed
        tile_rows_n<kTileF>(t + 2, total, s_start, s_len, s_rows[(t + 2) % 3]);
        if (t + 1 < n_tiles)
          fetch_tile_bf16(fe + (buf ^ 1) * kTileF * FS,
                          cp + (buf ^ 1) * kTileF * 3, fbf, fw, cpos,
                          s_rows[(t + 1) % 3],
                          min(kTileF, total - (t + 1) * kTileF), NT, FS);
        nf::cp_async_commit();
        const int nc = min(kTileF, total - t * kTileF);
        const float* tcp = cp + buf * kTileF * 3;
        const uint16_t* tfe = fe + buf * kTileF * FS;

        // phase 1: pair p = (query p / kTileF, candidate p % kTileF), a
        // warp 32 candidates of one query
        for (int p = tid; p < QB * kTileF; p += nthreads) {
          const int q = p / kTileF, j = p % kTileF;
          const bool within =
              pair_geometry_bf16(tcp, qp, q, j, q < nq && j < nc, inv_r,
                                 exclude_self, kz, ky, kx, p, pc, w8);
          const unsigned hits = __ballot_sync(kFull, within);
          if (lane == 0) qmask[p >> 5] = hits;
        }
        __syncthreads();
        // each query's pairs packed in candidate order: plist[rank] = j
        if (warp < QB) {
          int base = 0;
#pragma unroll
          for (int c = 0; c < kTileF / 32; ++c) {
            const unsigned m = qmask[warp * (kTileF / 32) + c];
            if ((m >> lane) & 1u)
              plist[warp * kTileF + base +
                    __popc(m & ((1u << lane) - 1u))] =
                  static_cast<uint8_t>(32 * c + lane);
            base += __popc(m);
          }
          if (lane == 0) {
            qn[warp] = base;
            qcnt[warp] += base;
          }
        }
        __syncthreads();

        // phase 2: acc[q] += A B over the query's pairs, 16 a k-step
        const int n = qn[wq];
        const uint8_t* pl = plist + wq * kTileF;
        // the row (tap of a m-tile, or pair rank) this lane names to
        // ldmatrix, and its 8-entry half
        const int lrank = (lane & 7) + 8 * ((lane >> 3) & 1);
        for (int k0 = 0; k0 < n; k0 += 16) {
          // A: lane l places 4 corners of rank k0 + (l & 15) that fall in
          // this warp's m-tiles into its A tile (zero elsewhere)
          int at[4] = {-1, -1, -1, -1};
          const int sr = k0 + srank;
          if (sr < n) {
            const int p = wq * kTileF + pl[sr];
            const int base = tap_of(pc[p], ky, kx) - 16 * mt0;
            const uint2 wv = *reinterpret_cast<const uint2*>(w8 + 8 * p + sc0);
            const uint16_t wc[4] = {
                static_cast<uint16_t>(wv.x & 0xffffu),
                static_cast<uint16_t>(wv.x >> 16),
                static_cast<uint16_t>(wv.y & 0xffffu),
                static_cast<uint16_t>(wv.y >> 16)};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int tap = base + cof[i];
              if (tap >= 0 && tap < 16 * MT) {
                at[i] = tap * kArow + srank;
                atile[at[i]] = wc[i];
              }
            }
          }
          __syncwarp();
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(a[mt], atile + (16 * mt + lrank) * kArow + 8 * (lane >> 4));
          const int lr = k0 + lrank;
          const uint16_t* frow = lr < n ? tfe + pl[lr] * FS : zrow;
#pragma unroll
          for (int nt = 0; nt + 1 < NT; nt += 2) {
            uint32_t b[4];  // n-tiles nt (b[0], b[1]) and nt + 1
            ldsm_x4_trans(b, frow + 8 * (nt + (lane >> 4)));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
              mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
            }
          }
          if constexpr (NT % 2 == 1) {
            uint32_t b[2];
            ldsm_x2_trans(b, frow + 8 * (NT - 1));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_bf16(acc[mt][NT - 1], a[mt], b[0], b[1]);
          }
          __syncwarp();  // the A tile is read: zero what this lane placed
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (at[i] >= 0) atile[at[i]] = 0;
        }
      }
      nf::cp_async_wait<0>();

      // bf(acc): its rows of tap * Cin + channel, into the fold's staging
      // or the scratch rows
      uint16_t* dst = FOLD ? arow + wq * kw
                           : rows + static_cast<long>(b0 - row_lo + wq) * klen;
      if (FOLD || wq < nq) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tap = 16 * (mt0 + mt) + g + 8 * h;
            if (tap >= n_taps) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int c = 8 * nt + 2 * t4;
              store_bf16_pair(dst, tap * cin + c, c, cin,
                              acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
            }
          }
      }
      __syncthreads();

      if (FOLD) {
        // out[q, o] = sum_k bf(acc)[q, k] bf(W)[k, o]: rows q < QB of a
        // 16-row A, 32 outputs at a time, the k-steps dealt to the warps
        for (int o0 = 0; o0 < cout; o0 += 32) {
          float f[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) f[nt][e] = 0.0f;
          for (int k0 = 16 * warp; k0 < kpad; k0 += 16 * kBf16Warps) {
            const uint16_t* ar = arow + g * kw + k0 + 2 * t4;
            const uint32_t a[4] = {
                g < QB ? *reinterpret_cast<const uint32_t*>(ar) : 0u, 0u,
                g < QB ? *reinterpret_cast<const uint32_t*>(ar + 8) : 0u, 0u};
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (8 * nt >= cout - o0) break;  // past Cout: no n-tile
              const int o = o0 + 8 * nt + g;
              const uint16_t* wr = wts + o * kw + k0 + 2 * t4;
              const uint32_t b0 =
                  o < cout ? *reinterpret_cast<const uint32_t*>(wr) : 0u;
              const uint32_t b1 =
                  o < cout ? *reinterpret_cast<const uint32_t*>(wr + 8) : 0u;
              mma_bf16(f[nt], a, b0, b1);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int oo = 8 * nt + 2 * t4 + h;
              if (g < QB) red[(warp * QB + g) * 32 + oo] = f[nt][h];
            }
          __syncthreads();
          for (int i = tid; i < nq * 32; i += nthreads) {
            const int q = i / 32, oo = i % 32;
            if (o0 + oo >= cout) continue;
            float v = 0.0f;
            for (int wp2 = 0; wp2 < kBf16Warps; ++wp2)
              v += red[(wp2 * QB + q) * 32 + oo];
            out[static_cast<long>(b0 - row_lo + q) * cout + o0 + oo] = v;
          }
          __syncthreads();
        }
      }
      if (cnt != nullptr && tid < nq)
        cnt[b0 + tid] = static_cast<float>(qcnt[tid]);
      __syncthreads();
    }
  }
}

// The backward walk at precision 'default': dq, dc (both or neither) and
// dfeats of the query rows in [row_lo, row_hi), work items as in
// walk_fwd_kernel, QB queries a block. d_acc of the block's queries is held
// in shared memory in bf16, rounded once: LOCAL, contracted in the block
// as bf(ct) bf(W)^T (f32 sums) from bf(W^T) staged once; else copied from
// the bf16 rows of the product (dacc_rows ((row_hi - row_lo), 64 * cin)).
// Per tile, after phase 1:
//   tap cotangents, tensor cores: per query, G (64 taps x 8 pair ranks) =
//     d_acc (64 x Cin) F^T over Cin, 16 channels a k-step (a query's WQ
//     warps take its m-tiles), and each pair's 8 corner entries are kept;
//   the geometry adjoint, dq and dc as in walk_bwd_kernel (f32);
//   dfeats, f32 SIMT over the bf16 operands: thread (candidate, 4
//     channels) sums bf(w_t) bf(d_acc[t]) over the block's queries.
template <int QB, bool LOCAL>
__global__ void __launch_bounds__(kBf16Threads, 2) walk_bwd_bf16_kernel(
    const int* __restrict__ gcol, const int* __restrict__ gzlo,
    const int* __restrict__ gzhi, const int* __restrict__ gstart,
    const int* __restrict__ pstarts, const float* __restrict__ qpos,
    const float* __restrict__ cpos, const uint16_t* __restrict__ fbf, int fw,
    const float* __restrict__ wt, const float* __restrict__ ct,
    const uint16_t* __restrict__ dacc_rows, float* __restrict__ dq,
    float* __restrict__ dc, float* __restrict__ df, int n_items, int ysplit,
    int row_lo, int row_hi, int d0, int d1, int d2, int kz, int ky, int kx,
    int cin, int cout, float inv_r, int exclude_self) {
  constexpr int WQ = kBf16Warps / QB;
  constexpr int MT = 4 / WQ;
  static_assert(WQ * QB == kBf16Warps && MT * WQ == 4, "64 taps a query");
  extern __shared__ __align__(16) uint8_t smem8[];
  __shared__ int s_start[9], s_len[9], s_rows[3][kTile];
  const bool need_pos = dq != nullptr;
  const bool need_f = df != nullptr;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int n_taps = kz * ky * kx, klen = n_taps * cin;
  const Bf16BwdSmem L = bf16_bwd_smem(QB, cin, cout, klen, LOCAL);
  uint16_t* dacc = reinterpret_cast<uint16_t*>(smem8 + L.dacc);
  uint16_t* fe = reinterpret_cast<uint16_t*>(smem8 + L.fe);
  uint16_t* zrow = reinterpret_cast<uint16_t*>(smem8 + L.zrow);
  uint16_t* w8 = reinterpret_cast<uint16_t*>(smem8 + L.w8);
  float* g8s = reinterpret_cast<float*>(smem8 + L.g8s);
  float* cp = reinterpret_cast<float*>(smem8 + L.cp);
  unsigned* pc = reinterpret_cast<unsigned*>(smem8 + L.pc);
  uint16_t* wts = reinterpret_cast<uint16_t*>(smem8 + L.wts);
  uint16_t* sct = reinterpret_cast<uint16_t*>(smem8 + L.sct);
  float* qp = reinterpret_cast<float*>(smem8 + L.qp);
  float* sdq = reinterpret_cast<float*>(smem8 + L.sdq);
  unsigned* qmask = reinterpret_cast<unsigned*>(smem8 + L.qmask);
  int* qn = reinterpret_cast<int*>(smem8 + L.qn);
  uint8_t* plist = smem8 + L.plist;
  const int ds = L.ds, cin16 = round16(cin), kwt = L.kwt, cs = L.cs;
  const int sy = kx, sz = ky * kx;
  const int coff[8] = {0, 1, sy, sy + 1, sz, sz + 1, sz + sy, sz + sy + 1};

  const int wq = warp / WQ, mt0 = (warp % WQ) * MT;
  unsigned tcode[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tcode[mt][h] = tap_code(16 * (mt0 + mt) + g + 8 * h, n_taps, ky, kx);

  // d_acc's channels past cin stay zero: the tap cotangents' k range
  for (int i = tid; i < QB * 64 * ds; i += nthreads) dacc[i] = 0;
  for (int i = tid; i < ds; i += nthreads) zrow[i] = 0;
  if (LOCAL)
    for (int i = tid; i < cout * kwt; i += nthreads) {
      const int o = i / kwt, k = i - o * kwt;
      wts[i] = k < klen ? bf16_bits(wt[static_cast<long>(o) * klen + k]) : 0;
    }

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int gi = item / ysplit, y = item % ysplit;
    const int col = gcol[gi];
    if (col >= d0 * d1) continue;  // empty tail group: owns no rows
    const int lo = max(gstart[gi], row_lo), hi = min(gstart[gi + 1], row_hi);
    if (lo >= hi) continue;
    __syncthreads();  // the last item's readers of the slabs are done
    group_slabs(col, gzlo[gi], gzhi[gi], pstarts, d0, d1, d2, s_start, s_len);
    __syncthreads();
    const int total = count_candidates(s_len);
    const int n_tiles = (total + kTile - 1) / kTile;

    for (int b0 = lo + y * QB; b0 < hi; b0 += ysplit * QB) {
      const int nq = min(QB, hi - b0);
      if (tid < QB * 3) {
        qp[tid] = tid / 3 < nq ? qpos[static_cast<long>(b0) * 3 + tid] : 0.0f;
        sdq[tid] = 0.0f;
      }
      if (LOCAL) {
        for (int i = tid; i < QB * cs; i += nthreads) {
          const int q = i / cs, o = i - q * cs;
          sct[i] = q < nq && o < cout
                       ? bf16_bits(ct[static_cast<long>(b0 + q) * cout + o])
                       : 0;
        }
        __syncthreads();  // also after the staging of W^T
        // d_acc[q, k] = sum_o bf(ct)[q, o] bf(W^T)[o, k] in f32 on the
        // SIMT pipes: Cout (32 at conv0, 3 at conv3) would fill a
        // tensor-core k-step of 16 poorly, and the block's QB queries a
        // 16-row tile; a thread per k = tap * Cin + c
        for (int k = tid; k < klen; k += nthreads) {
          const int tap = k / cin, c = k - tap * cin;
          float d[QB];
#pragma unroll
          for (int q = 0; q < QB; ++q) d[q] = 0.0f;
          for (int o = 0; o < cout; ++o) {
            const float wv = bf16_value(wts[o * kwt + k]);
#pragma unroll
            for (int q = 0; q < QB; ++q)
              d[q] += bf16_value(sct[q * cs + o]) * wv;
          }
#pragma unroll
          for (int q = 0; q < QB; ++q)
            if (q < nq) dacc[(q * 64 + tap) * ds + c] = bf16_bits(d[q]);
        }
      } else {
        const uint16_t* src =
            dacc_rows + static_cast<long>(b0 - row_lo) * klen;
        if (cin % 8 == 0) {
          const int c8 = cin / 8;
          for (int i = tid; i < nq * n_taps * c8; i += nthreads) {
            const int r = i / c8, k = i - r * c8;  // r = q * n_taps + tap
            const int q = r / n_taps, tap = r - q * n_taps;
            nf::cp_async16(
                reinterpret_cast<float*>(dacc + (q * 64 + tap) * ds + 8 * k),
                reinterpret_cast<const float*>(src + r * cin + 8 * k));
          }
        } else {
          for (int i = tid; i < nq * klen; i += nthreads) {
            const int r = i / cin, c = i - r * cin;
            const int q = r / n_taps, tap = r - q * n_taps;
            dacc[(q * 64 + tap) * ds + c] = src[i];
          }
        }
      }
      tile_rows(0, total, s_start, s_len, s_rows[0]);
      tile_rows(1, total, s_start, s_len, s_rows[1]);
      __syncthreads();

      if (n_tiles > 0)
        fetch_tile_bf16(fe, cp, fbf, fw, cpos, s_rows[0], min(kTile, total),
                        cin16 / 8, ds);
      nf::cp_async_commit();
      for (int t = 0; t < n_tiles; ++t) {
        const int buf = t & 1;
        nf::cp_async_wait<0>();  // tile t (and d_acc) has landed
        __syncthreads();  // ... for every thread; tile t - 1 is consumed
        tile_rows(t + 2, total, s_start, s_len, s_rows[(t + 2) % 3]);
        if (t + 1 < n_tiles)
          fetch_tile_bf16(fe + (buf ^ 1) * kTile * ds,
                          cp + (buf ^ 1) * kTile * 3, fbf, fw, cpos,
                          s_rows[(t + 1) % 3],
                          min(kTile, total - (t + 1) * kTile), cin16 / 8, ds);
        nf::cp_async_commit();
        const int nc = min(kTile, total - t * kTile);
        const float* tcp = cp + buf * kTile * 3;
        const uint16_t* tfe = fe + buf * kTile * ds;
        const int* rows = s_rows[t % 3];

        // phase 1: warp q is the 32 candidates of query q; its pairs
        // packed in candidate order, plist[rank] = j
        if (warp < QB) {
          const bool within = pair_geometry_bf16(
              tcp, qp, warp, lane, warp < nq && lane < nc, inv_r,
              exclude_self, kz, ky, kx, warp * kTile + lane, pc, w8);
          const unsigned hits = __ballot_sync(kFull, within);
          if (within)
            plist[warp * kTile + __popc(hits & ((1u << lane) - 1u))] =
                static_cast<uint8_t>(lane);
          if (lane == 0) {
            qmask[warp] = hits;
            qn[warp] = __popc(hits);
          }
        }
        __syncthreads();

        int n_in = 0;
#pragma unroll
        for (int q = 0; q < QB; ++q) n_in += qn[q];

        if (need_pos) {
          // tap cotangents: G = d_acc F^T per query over n-tiles of 8 of
          // its pairs; the pair's 8 corner entries go to g8s in pair
          // order (query, then candidate)
          const int n = qn[wq];
          int base = 0;
          for (int q = 0; q < wq; ++q) base += qn[q];
          const uint8_t* pl = plist + wq * kTile;
          for (int n0 = 0; n0 < n; n0 += 8) {
            const int r = n0 + g;
            const uint16_t* fr = r < n ? tfe + pl[r] * ds : zrow;
            float c[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) c[mt][e] = 0.0f;
            for (int k0 = 0; k0 < cin16; k0 += 16) {
              const uint32_t b0 =
                  *reinterpret_cast<const uint32_t*>(fr + k0 + 2 * t4);
              const uint32_t b1 =
                  *reinterpret_cast<const uint32_t*>(fr + k0 + 2 * t4 + 8);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                const uint16_t* dr =
                    dacc + (wq * 64 + 16 * (mt0 + mt) + g) * ds + k0 + 2 * t4;
                const uint32_t a[4] = {
                    *reinterpret_cast<const uint32_t*>(dr),
                    *reinterpret_cast<const uint32_t*>(dr + 8 * ds),
                    *reinterpret_cast<const uint32_t*>(dr + 8),
                    *reinterpret_cast<const uint32_t*>(dr + 8 * ds + 8)};
                mma_bf16(c[mt], a, b0, b1);
              }
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int rank = n0 + 2 * t4 + (e & 1);
                if (rank >= n) continue;
                const int corner =
                    corner_of(tcode[mt][e >> 1], pc[wq * kTile + pl[rank]]);
                if (corner >= 0) g8s[(base + rank) * 8 + corner] = c[mt][e];
              }
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
        // the block has in radius, bf(w_t) bf(d_acc[t]) summed over those
        // queries in f32
        if (need_f) {
          unsigned some = 0;
          for (int q = 0; q < nq; ++q) some |= qmask[q];
          const int n_some = __popc(some);
          const bool vec = cin % 4 == 0 && nf::aligned16(df);
          const int cw = vec ? 4 : 1, cn = cin / cw;
          for (int item2 = tid; item2 < n_some * cn; item2 += nthreads) {
            const int a = item2 / cn, c = (item2 - a * cn) * cw;
            const int j = __fns(some, 0, a + 1);
            float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int q = 0; q < nq; ++q) {
              if (!((qmask[q] >> j) & 1u)) continue;
              const int p = q * kTile + j;
              const uint16_t* dr =
                  dacc + (q * 64 + tap_of(pc[p], ky, kx)) * ds + c;
              const uint4 wv = *reinterpret_cast<const uint4*>(w8 + 8 * p);
              const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                const float wk = bf16_value((ww[k >> 1] >> (16 * (k & 1))) &
                                            0xffffu);
                const uint16_t* dk = dr + coff[k] * ds;
                if (vec) {
                  const uint2 dv = *reinterpret_cast<const uint2*>(dk);
                  v[0] += wk * bf16_value(dv.x & 0xffffu);
                  v[1] += wk * bf16_value(dv.x >> 16);
                  v[2] += wk * bf16_value(dv.y & 0xffffu);
                  v[3] += wk * bf16_value(dv.y >> 16);
                } else {
                  v[0] += wk * bf16_value(dk[0]);
                }
              }
            }
            float* dst = df + static_cast<long>(rows[j]) * cin + c;
            if (vec)
              atomicAdd(reinterpret_cast<float4*>(dst),
                        make_float4(v[0], v[1], v[2], v[3]));
            else
              atomicAdd(dst, v[0]);
          }
        }

        if (need_pos) {
          __syncthreads();
          // dq per query and dc per candidate, each summed in pair order
          if (tid < QB * 3) {
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
            for (int q = 0; q < QB; ++q) {
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

// dst (rows, ld) = src (rows, cols) rounded to bf16, zero past cols
__global__ void to_bf16_kernel(const float* __restrict__ src,
                               uint16_t* __restrict__ dst, long rows,
                               int cols, int ld) {
  const long n = rows * ld;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long>(gridDim.x) * blockDim.x) {
    const long r = i / ld;
    const int c = static_cast<int>(i - r * ld);
    dst[i] = c < cols ? bf16_bits(src[r * cols + c]) : 0;
  }
}

int to_bf16(const float* src, void* dst, long rows, int cols, int ld,
            cudaStream_t st) {
  const long n = rows * ld;
  if (n <= 0) return 0;
  const long blocks = (n + 255) / 256;
  const int grid = static_cast<int>(blocks < 2048 ? blocks : 2048);
  to_bf16_kernel<<<grid, 256, 0, st>>>(src, static_cast<uint16_t*>(dst),
                                       rows, cols, ld);
  return static_cast<int>(cudaGetLastError());
}

struct WalkBf16 {
  const int *gcol, *gzlo, *gzhi, *gstart, *pstarts;
  const float *qpos, *cpos;
  const uint16_t* fbf;
  int fw, n_groups, group_size, d0, d1, d2, kz, ky, kx, cin, cout;
  float inv_r;
  int exclude_self;
  cudaStream_t stream;
};

template <int QB, int NT, bool FOLD>
int launch_walk_fwd_bf16(const WalkBf16& a, const float* w, float* out,
                         uint16_t* rows, float* cnt, int row_lo, int row_hi) {
  const Bf16FwdSmem L =
      bf16_fwd_smem(QB, NT, a.kz * a.ky * a.kx * a.cin, a.cout, FOLD);
  const size_t smem = static_cast<size_t>(L.bytes);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = walk_fwd_bf16_kernel<QB, NT, FOLD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ysplit = (a.group_size + QB - 1) / QB;
  const int n_items = a.n_groups * ysplit;
  const int grid = FOLD ? staged_grid(kernel, kBf16Threads, smem, n_items,
                                      row_hi - row_lo)
                        : n_items;
  kernel<<<grid, kBf16Threads, smem, a.stream>>>(
      a.gcol, a.gzlo, a.gzhi, a.gstart, a.pstarts, a.qpos, a.cpos, a.fbf,
      a.fw, w, out, rows, cnt, n_items, ysplit, row_lo, row_hi, a.d0, a.d1,
      a.d2, a.kz, a.ky, a.kx, a.cin, a.cout, a.inv_r, a.exclude_self);
  return static_cast<int>(cudaGetLastError());
}

template <int QB, bool LOCAL>
int launch_walk_bwd_bf16(const WalkBf16& a, const float* wt, const float* ct,
                         const uint16_t* dacc_rows, float* dq, float* dc,
                         float* df, int row_lo, int row_hi) {
  const Bf16BwdSmem L = bf16_bwd_smem(QB, a.cin, a.cout,
                                      a.kz * a.ky * a.kx * a.cin, LOCAL);
  const size_t smem = static_cast<size_t>(L.bytes);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = walk_bwd_bf16_kernel<QB, LOCAL>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ysplit = (a.group_size + QB - 1) / QB;
  const int n_items = a.n_groups * ysplit;
  const int grid = LOCAL ? staged_grid(kernel, kBf16Threads, smem, n_items,
                                       row_hi - row_lo)
                         : n_items;
  kernel<<<grid, kBf16Threads, smem, a.stream>>>(
      a.gcol, a.gzlo, a.gzhi, a.gstart, a.pstarts, a.qpos, a.cpos, a.fbf,
      a.fw, wt, ct, dacc_rows, dq, dc, df, n_items, ysplit, row_lo, row_hi,
      a.d0, a.d1, a.d2, a.kz, a.ky, a.kx, a.cin, a.cout, a.inv_r,
      a.exclude_self);
  return static_cast<int>(cudaGetLastError());
}

// the forward bf16 walk of the layer's channels: its n-tiles (a template
// constant) fix the queries a block takes (`bf16_fwd_qb`), which the
// caller's plan must name
int walk_fwd_bf16(const WalkBf16& a, bool fold, int qb, const float* w,
                  float* out, uint16_t* rows, float* cnt, int row_lo,
                  int row_hi) {
  const int nt = bf16_ntiles(a.cin);
  if (nt < 0 || qb != bf16_fwd_qb(nt, fold))
    return static_cast<int>(cudaErrorInvalidValue);
#define NF_CALL(NT)                                                      \
  return fold ? launch_walk_fwd_bf16<bf16_fwd_qb(NT, true), NT, true>(   \
                    a, w, out, rows, cnt, row_lo, row_hi)                \
              : launch_walk_fwd_bf16<bf16_fwd_qb(NT, false), NT, false>( \
                    a, w, out, rows, cnt, row_lo, row_hi)
  switch (nt) {
    case 1: NF_CALL(1);
    case 2: NF_CALL(2);
    case 4: NF_CALL(4);
    case 8: NF_CALL(8);
    case 12: NF_CALL(12);
    default: NF_CALL(16);
  }
#undef NF_CALL
}

int walk_bwd_bf16(const WalkBf16& a, bool local, int qb, const float* wt,
                  const float* ct, const uint16_t* dacc_rows, float* dq,
                  float* dc, float* df, int row_lo, int row_hi) {
#define NF_CALL(Q)                                                          \
  return local ? launch_walk_bwd_bf16<Q, true>(a, wt, ct, dacc_rows, dq, dc, \
                                               df, row_lo, row_hi)          \
               : launch_walk_bwd_bf16<Q, false>(a, wt, ct, dacc_rows, dq,   \
                                                dc, df, row_lo, row_hi)
  switch (qb) {
    case 2: NF_CALL(2);
    case 4: NF_CALL(4);
    case 8: NF_CALL(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NF_CALL
}

}  // namespace

// K1d, K1 at precision 'default'. feats (n_feat, cin) is rounded once into
// fbf, its bf16 copy (n_feat, bf16_feat_width(cin)) that the caller
// allocates; then as nf_fused_cconv_fwd with the bf16 walk: rows ==
// null, W fits shared memory and the walk folds it; otherwise rows
// (chunk_rows, 64 * cin) in bf16 and the bf16 product (bt its bf16 B
// scratch). qb queries per block: `bf16_fwd_qb` of the channels' n-tiles
// (ops/fused_cconv.py `walk_config_bf16`); threads must be 256.
extern "C" int nf_fused_cconv_fwd_bf16(
    const int* gcol, const int* gzlo, const int* gzhi, const int* gstart,
    const int* pstarts, const float* qpos, const float* cpos,
    const float* feats, void* fbf, const float* w, float* out, float* cnt,
    void* rows, float* bt, float* part, int n_feat, int n_groups,
    int group_size, int n_q, int chunk_rows, int k_splits, int k_per_split,
    int qb, int threads, int d0, int d1, int d2, int kz, int ky, int kx,
    int cin, int cout, float inv_r, int exclude_self, void* stream) {
  const bool fold = rows == nullptr;
  if (cout < 1 || cout > 256 || n_q < 1 || n_feat < 1 || fbf == nullptr ||
      threads != kBf16Threads || bf16_ntiles(cin) < 0 ||
      (!fold && (chunk_rows < 1 || bt == nullptr || k_splits < 1 ||
                 (k_splits > 1 && part == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fw = bf16_feat_width(cin);
  int err = to_bf16(feats, fbf, n_feat, cin, fw, st);
  if (err != 0) return err;
  const WalkBf16 a{gcol, gzlo, gzhi, gstart, pstarts, qpos, cpos,
                   static_cast<const uint16_t*>(fbf), fw, n_groups,
                   group_size, d0, d1, d2, kz, ky, kx, cin, cout, inv_r,
                   exclude_self, st};
  if (fold) return walk_fwd_bf16(a, true, qb, w, out, nullptr, cnt, 0, n_q);
  uint16_t* r16 = static_cast<uint16_t*>(rows);
  const int klen = kz * ky * kx * cin;
  for (int lo = 0; lo < n_q; lo += chunk_rows) {
    const int hi = min(n_q, lo + chunk_rows);
    err = walk_fwd_bf16(a, false, qb, w, out, r16, cnt, lo, hi);
    if (err != 0) return err;
    float* out_lo = out + static_cast<long>(lo) * cout;
    err = nf::split_gemm<true>(r16, w, k_splits > 1 ? part : out_lo, bt,
                               hi - lo, cout, klen, false, k_splits,
                               k_per_split, st);
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

// K2d, K2 at precision 'default': as nf_fused_cconv_bwd, with fbf as in
// nf_fused_cconv_fwd_bf16 and the bf16 walks (256 threads; qb_fwd from
// `bf16_fwd_qb`, qb_bwd 2, 4 or 8: ops/fused_cconv.py `walk_config_bf16`).
// scratch (chunk_rows, 64 * cin) holds bf16: d_acc, which the bf16 product
// writes from ct16, the bf16 copy of ct (n_q, cout) (not read when
// `local`), then the accumulator rows of dW.
extern "C" int nf_fused_cconv_bwd_bf16(
    const int* gcol, const int* gzlo, const int* gzhi, const int* gstart,
    const int* pstarts, const float* qpos, const float* cpos,
    const float* feats, void* fbf, const float* wt, const float* ct,
    void* ct16, void* scratch, float* part, float* bt, float* dw, float* dq,
    float* dc, float* df, int n_feat, int n_groups, int group_size, int n_q,
    int chunk_rows, int splits_per_chunk, int rows_per_split, int local,
    int qb_fwd, int qb_bwd, int d0, int d1, int d2, int kz, int ky, int kx,
    int cin, int cout, float inv_r, int exclude_self, void* stream) {
  const bool need_w = dw != nullptr;
  const bool need_dacc = dq != nullptr || df != nullptr;
  if (cout < 1 || n_q < 1 || n_feat < 1 || chunk_rows < 1 ||
      fbf == nullptr || bf16_ntiles(cin) < 0 ||
      (dq == nullptr) != (dc == nullptr) ||
      ((need_w || (need_dacc && !local)) && bt == nullptr) ||
      (need_w && (part == nullptr || scratch == nullptr ||
                  splits_per_chunk < 1 || rows_per_split % 32 != 0 ||
                  static_cast<long>(splits_per_chunk) * rows_per_split <
                      min(chunk_rows, n_q))) ||
      (need_dacc && !local && (scratch == nullptr || ct16 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fw = bf16_feat_width(cin);
  int err = to_bf16(feats, fbf, n_feat, cin, fw, st);
  if (err != 0) return err;
  if (need_dacc && !local) {
    err = to_bf16(ct, ct16, n_q, cout, cout, st);
    if (err != 0) return err;
  }
  const WalkBf16 a{gcol, gzlo, gzhi, gstart, pstarts, qpos, cpos,
                   static_cast<const uint16_t*>(fbf), fw, n_groups,
                   group_size, d0, d1, d2, kz, ky, kx, cin, cout, inv_r,
                   exclude_self, st};
  uint16_t* s16 = static_cast<uint16_t*>(scratch);
  const int klen = kz * ky * kx * cin;
  const long len = static_cast<long>(klen) * cout;
  int n_chunks = 0;
  for (int lo = 0; lo < n_q; lo += chunk_rows, ++n_chunks) {
    const int hi = min(n_q, lo + chunk_rows);
    const float* ct_lo = ct + static_cast<long>(lo) * cout;
    if (need_dacc) {
      if (!local) {
        err = nf::split_gemm<true>(static_cast<const uint16_t*>(ct16) +
                                       static_cast<long>(lo) * cout,
                                   wt, s16, bt, hi - lo, klen, cout, false, 1,
                                   0, st, true);
        if (err != 0) return err;
      }
      err = walk_bwd_bf16(a, local != 0, qb_bwd, wt, ct, s16, dq, dc, df, lo,
                          hi);
      if (err != 0) return err;
    }
    if (need_w) {
      err = walk_fwd_bf16(a, false, qb_fwd, nullptr, nullptr, s16, nullptr,
                          lo, hi);
      if (err != 0) return err;
      err = nf::split_gemm<true>(s16, ct_lo,
                                 part + n_chunks * splits_per_chunk * len, bt,
                                 klen, cout, hi - lo, true, splits_per_chunk,
                                 rows_per_split, st);
      if (err != 0) return err;
    }
  }
  if (!need_w) return 0;
  nf::sum_splits_kernel<<<static_cast<int>((len + 255) / 256), 256, 0, st>>>(
      part, dw, n_chunks * splits_per_chunk, static_cast<int>(len));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 product on its own: c (m, n) f32 = a b with a (m, k), or (k, m)
// when trans_a, in bf16 (as the walk writes its rows), b (k, n) f32,
// rounded to bf16 by its prep into bt (ops/fused_cconv.py
// `gemm_b_floats(k, n, True)`); splits as in nf_split_gemm.
extern "C" int nf_split_gemm_bf16(const void* a, const float* b, float* c,
                                  float* part, float* bt, int m, int n, int k,
                                  int trans_a, int n_split, int k_per_split,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 0 || n_split < 1 ||
      (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_split == 1)
    return nf::split_gemm<true>(a, b, c, bt, m, n, k, trans_a != 0, 1, 0, st);
  const int err = nf::split_gemm<true>(a, b, part, bt, m, n, k, trans_a != 0,
                                       n_split, k_per_split, st);
  if (err != 0) return err;
  const int len = m * n;
  nf::sum_splits_kernel<<<(len + 255) / 256, 256, 0, st>>>(part, c, n_split,
                                                          len);
  return static_cast<int>(cudaGetLastError());
}

// Tensor-core products launched so far in this process by this library
// (in K1d, K2d and nf_split_gemm_bf16), counted where each launch is
// accepted: bf16 != 0 the bf16 mode's, else the TF32 mode's (none here).
extern "C" long long nf_product_launches(int bf16) {
  return nf::product_launches()[bf16 != 0 ? 1 : 0];
}
