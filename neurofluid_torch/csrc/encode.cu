// K10: the render's feature encoding, each sample's NeRF input row written
// once from its local geometry (ops/encode.py; models/render_net.py encodes
// every render pass here on the card):
//
//   row = [PE(xyz, Fx) | PE(density, Fd) | PE(smoothed, Fx) | PE(var, Fx)
//          | PE(ray dir, Fr) | PE(smoothed dir, Fr)]
//   PE(v, F) = [v, sin(2^0 v), cos(2^0 v), ..., sin(2^(F-1) v), cos(...)],
//              each term over the block's channels (models/embedding.py)
//
// density, smoothed, var and the smoothed direction each by a flag; the two
// direction blocks only without sigma_only. The smoothed direction is
// (smoothed - ro) / (|smoothed - ro| + 1e-12), the ray direction the ray's
// row 3..5, read by row / samples (no repeat of it per sample).
//
// It replaces no TPU kernel: the JAX package leaves its encoding to XLA, and
// the port composed it from PyTorch operators: a mul, a sin and a cos per
// frequency, a concatenation per encoding, one of the encodings into the
// row, and the fine pass's concatenation of the coarse rows and its new
// ones (about 140 launches a pass, each row written and read three times).
//
// Arithmetic as the plain composition's on the card: each 2^k v an exact
// product, sinf and cosf of it (no __sinf, whose error grows with |2^k v|;
// no double-angle recurrence, which rounds differently), the smoothed
// direction's norm summed in the order torch's reduction takes (`norm3`;
// another torch may take another, so the tests hold that block to 2^-20).
//
// Bound on the card (H100 SXM): bytes. A row of 252 columns is 1,008 bytes
// written from 40 read (rays and the camera origin are cached), and 117
// sin/cos pairs: at the eval chunk's 393,216 fine rows 0.40 GB, 0.12 ms at
// 3.35 TB/s, against about 46 M pairs of about 80 SIMT instructions each.
// So:
//
// * A block takes a tile of rows, at most kMaxTileRows (32), in shared
//   memory: the tile's inputs (16 channels a row), then the tile's output
//   rows, contiguous as in device memory. One work item is one (row,
//   channel, frequency): its thread computes sinf and cosf of one product,
//   so no warp runs both paths of a sin / cos branch. The items' columns
//   come from a plan the host builds once a call (`make_plan`), copied to
//   shared memory.
// * The tile's rows are contiguous in device memory, so the block stores
//   them with 16-byte stores of consecutive threads (tiles of a multiple
//   of 4 rows start on 16 bytes), never one thread a row.
// * The fine pass reads two sources, the coarse rows and the new ones, by
//   the per-ray layout: output row r (s0 + s1) + s is source 0's row
//   r s0 + s for s < s0, else source 1's row r s1 + s - s0. The fine NeRF's
//   input is written once, with no concatenation; the coarse rows are
//   encoded again from their 10 floats instead of copied as 252.
//
// The backward (`encode_bwd_kernel`) reads a tile of the cotangent into
// shared memory with 16-byte loads, and one thread a (row, channel) sums
// g[v] + sum_k 2^k (cos(2^k v) g[sin_k] - sin(2^k v) g[cos_k]) in order of
// k; the smoothed direction's cotangent goes through the normalisation's
// VJP into the smoothed position's. Each source row's cotangent is written
// once: a fixed order, no atomics. The ray direction and the camera origin
// get none (ops/encode.py refuses them when they ask for one).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// a row's staged inputs: xyz 3, density 1, smoothed position 3, variance 3,
// ray direction 3, smoothed direction 3
constexpr int kChannels = 16;
constexpr int kInStride = kChannels + 1;
constexpr int kChDensity = 3, kChSmoothed = 4, kChVar = 7, kChDir = 10,
              kChSmoothedDir = 13;
constexpr int kFlagDensity = 1, kFlagSmoothedPos = 2, kFlagVar = 4,
              kFlagSmoothedDir = 8, kFlagSigmaOnly = 16;
constexpr int kMaxFreqs = 24;
constexpr int kMaxWidth = 1024;
constexpr int kMaxPairs = 512;
constexpr int kMaxTileRows = 32;
constexpr int kSmemBudget = 48 * 1024;
// int64 entries of a call's table (ops/encode.py `_launch`)
constexpr int kArgs = 36;

// one source of rows: xyz, density, smoothed position, variance (row
// strides ld; variance null where unused), `samples` rows a ray; in the
// backward the cotangent of each (rows of 3, 1, 3, 3), or null
struct Source {
  const float* in[4];
  long long ld[4];
  float* grad[4];
  int samples;
};

struct Plan {
  Source src[2];
  const float* rays;  // (n_rays, ld_rays): the direction at columns 3..5
  long long ld_rays;
  const float* ro;  // the camera origin, stride ro_stride
  long long ro_stride;
  float* feats;  // the rows (n_rows, width): out, or the backward's cotangent
  int n_rays, samples, n_rows, width, tile_rows;
  bool smoothed_dir;  // the smoothed direction is encoded
  unsigned channels;  // mask of the staged channels
  // forward: a (channel, frequency) pair each, col | ch << 16 | k << 20 |
  // C << 25 (its sin column; cos at col + C, C the block's channels), and
  // the identity columns, col | ch << 16
  int n_pairs, n_ident;
  unsigned pairs[kMaxPairs];
  unsigned ident[kChannels];
  // backward: a channel of a block each, col | ch << 16 | C << 20 |
  // freqs << 24 (col: its identity column)
  int n_grads;
  unsigned grads[kChannels];
};

__device__ __forceinline__ float pow2(int k) {
  return __int_as_float((127 + k) << 23);  // 2^k, exact
}

// |(u0, u1, u2)| as torch.linalg.norm(dim=-1) sums a row of 3 on the card
// (two threads along the row: the rounded squares (u0^2 + u2^2) + u1^2; on
// an H100 with torch 2.11 it gave its bits for each of 4 M seeded vectors)
__device__ __forceinline__ float norm3(float u0, float u1, float u2) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(u0, u0), __fmul_rn(u2, u2)),
                         __fmul_rn(u1, u1)));
}

// (source, row in it) of output row `row`
__device__ __forceinline__ int source_row(const Plan& p, int row, int& s) {
  const int s0 = p.src[0].samples;
  if (s0 == p.samples) {
    s = 0;
    return row;
  }
  const int ray = row / p.samples, j = row - ray * p.samples;
  if (j < s0) {
    s = 0;
    return ray * s0 + j;
  }
  s = 1;
  return ray * p.src[1].samples + (j - s0);
}

// the tile's inputs into in_s (tile_rows x kInStride), unstaged channels 0,
// and the smoothed direction from the smoothed position; ends synced
__device__ void stage_inputs(const Plan& p, int row0, int rows, float* in_s) {
  for (int i = threadIdx.x; i < rows * kChannels; i += blockDim.x) {
    const int r = i / kChannels, ch = i - r * kChannels;
    const int row = row0 + r;
    float v = 0.0f;
    if ((p.channels >> ch & 1u) && ch < kChDir) {
      int s;
      const long long sr = source_row(p, row, s);
      const int which = ch < kChDensity ? 0 : ch < kChSmoothed ? 1
                        : ch < kChVar ? 2 : 3;
      const int c = ch - (which == 0 ? 0 : which == 1 ? kChDensity
                          : which == 2 ? kChSmoothed : kChVar);
      v = p.src[s].in[which][sr * p.src[s].ld[which] + c];
    } else if ((p.channels >> ch & 1u) && ch < kChSmoothedDir) {
      v = p.rays[static_cast<long long>(row / p.samples) * p.ld_rays + 3 +
                 (ch - kChDir)];
    }
    in_s[r * kInStride + ch] = v;
  }
  __syncthreads();
  if (p.smoothed_dir) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float* q = in_s + r * kInStride;
      const float u0 = q[kChSmoothed] - p.ro[0];
      const float u1 = q[kChSmoothed + 1] - p.ro[p.ro_stride];
      const float u2 = q[kChSmoothed + 2] - p.ro[2 * p.ro_stride];
      const float n = norm3(u0, u1, u2) + 1e-12f;
      q[kChSmoothedDir] = u0 / n;
      q[kChSmoothedDir + 1] = u1 / n;
      q[kChSmoothedDir + 2] = u2 / n;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    encode_fwd_kernel(const __grid_constant__ Plan p) {
  extern __shared__ float4 smem4[];
  float* out_s = reinterpret_cast<float*>(smem4);  // tile_rows x width
  float* in_s = out_s + p.tile_rows * p.width;
  unsigned* pairs_s = reinterpret_cast<unsigned*>(in_s + p.tile_rows * kInStride);
  const int row0 = blockIdx.x * p.tile_rows;
  const int rows = min(p.tile_rows, p.n_rows - row0);
  for (int i = threadIdx.x; i < p.n_pairs; i += blockDim.x)
    pairs_s[i] = p.pairs[i];
  stage_inputs(p, row0, rows, in_s);
  for (int i = threadIdx.x; i < rows * p.n_ident; i += blockDim.x) {
    const int r = i / p.n_ident;
    const unsigned e = p.ident[i - r * p.n_ident];
    out_s[r * p.width + (e & 0xffffu)] = in_s[r * kInStride + (e >> 16)];
  }
  for (int i = threadIdx.x; i < rows * p.n_pairs; i += blockDim.x) {
    const int r = i / p.n_pairs;
    const unsigned e = pairs_s[i - r * p.n_pairs];
    const float x = in_s[r * kInStride + (e >> 16 & 15u)] * pow2(e >> 20 & 31u);
    float* o = out_s + r * p.width + (e & 0xffffu);
    o[0] = sinf(x);
    o[e >> 25] = cosf(x);
  }
  __syncthreads();
  float* dst = p.feats + static_cast<long long>(row0) * p.width;
  const int n = rows * p.width;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x) dst4[q] = smem4[q];
    done = n / 4 * 4;
  }
  for (int e = done + threadIdx.x; e < n; e += blockDim.x) dst[e] = out_s[e];
}

__global__ void __launch_bounds__(kThreads)
    encode_bwd_kernel(const __grid_constant__ Plan p) {
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);  // tile_rows x width
  float* in_s = g_s + p.tile_rows * p.width;
  float* d_s = in_s + p.tile_rows * kInStride;
  const int row0 = blockIdx.x * p.tile_rows;
  const int rows = min(p.tile_rows, p.n_rows - row0);
  const float* src = p.feats + static_cast<long long>(row0) * p.width;
  const int n = rows * p.width;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x) smem4[q] = src4[q];
    done = n / 4 * 4;
  }
  for (int e = done + threadIdx.x; e < n; e += blockDim.x) g_s[e] = src[e];
  for (int i = threadIdx.x; i < rows * kInStride; i += blockDim.x) d_s[i] = 0.0f;
  stage_inputs(p, row0, rows, in_s);  // syncs g_s and d_s too
  for (int i = threadIdx.x; i < rows * p.n_grads; i += blockDim.x) {
    const int r = i / p.n_grads;
    const unsigned e = p.grads[i - r * p.n_grads];
    const int col = e & 0xffffu, ch = e >> 16 & 15u, c = e >> 20 & 15u,
              freqs = e >> 24;
    const float v = in_s[r * kInStride + ch];
    const float* g = g_s + r * p.width + col;
    float acc = g[0];
    for (int k = 0; k < freqs; ++k) {
      const float x = v * pow2(k);
      const float* gk = g + c * (2 * k + 1);
      acc += pow2(k) * (cosf(x) * gk[0] - sinf(x) * gk[c]);
    }
    d_s[r * kInStride + ch] = acc;
  }
  __syncthreads();
  // the smoothed direction's cotangent through its normalisation into the
  // smoothed position's: with u = smoothed - ro, n = |u|, e = n + 1e-12,
  // d u = d sd / e - u (u . d sd) / (e^2 n)  (the second term 0 at n = 0)
  if (p.smoothed_dir) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* q = in_s + r * kInStride;
      float* d = d_s + r * kInStride;
      const float u[3] = {q[kChSmoothed] - p.ro[0],
                          q[kChSmoothed + 1] - p.ro[p.ro_stride],
                          q[kChSmoothed + 2] - p.ro[2 * p.ro_stride]};
      const float nrm = norm3(u[0], u[1], u[2]);
      const float e = nrm + 1e-12f;
      const float dot = u[0] * d[kChSmoothedDir] + u[1] * d[kChSmoothedDir + 1] +
                        u[2] * d[kChSmoothedDir + 2];
      const float coef = nrm > 0.0f ? dot / (e * e * nrm) : 0.0f;
      for (int j = 0; j < 3; ++j)
        d[kChSmoothed + j] += d[kChSmoothedDir + j] / e - u[j] * coef;
    }
    __syncthreads();
  }
  // each source row's cotangents: xyz 3, density 1, smoothed 3, var 3
  for (int i = threadIdx.x; i < rows * kChDir; i += blockDim.x) {
    const int r = i / kChDir, ch = i - r * kChDir;
    const int which = ch < kChDensity ? 0 : ch < kChSmoothed ? 1
                      : ch < kChVar ? 2 : 3;
    int s;
    const long long sr = source_row(p, row0 + r, s);
    float* out = p.src[s].grad[which];
    if (out == nullptr) continue;
    const int width = which == 1 ? 1 : 3;
    const int c = ch - (which == 0 ? 0 : which == 1 ? kChDensity
                        : which == 2 ? kChSmoothed : kChVar);
    out[sr * width + c] = d_s[r * kInStride + ch];
  }
}

// the plan of one call from its table (host memory, kArgs int64): for
// sources 0 and 1, xyz, ld, density, ld, smoothed, ld, var, ld, samples;
// then rays, ld_rays, ro, ro_stride, feats, n_rays, flags, xyz_freqs,
// density_freqs, dir_freqs; then the backward's cotangents, xyz, density,
// smoothed, var of source 0, then of source 1 (null: not asked for). The
// block's shared memory in `smem`. False where the call is malformed.
bool make_plan(const long long* t, bool bwd, Plan& p, int& smem) {
  p = Plan{};
  for (int s = 0; s < 2; ++s) {
    const long long* r = t + 9 * s;
    for (int j = 0; j < 4; ++j) {
      p.src[s].in[j] = reinterpret_cast<const float*>(r[2 * j]);
      p.src[s].ld[j] = r[2 * j + 1];
      p.src[s].grad[j] = reinterpret_cast<float*>(t[28 + 4 * s + j]);
    }
    p.src[s].samples = static_cast<int>(r[8]);
  }
  p.rays = reinterpret_cast<const float*>(t[18]);
  p.ld_rays = t[19];
  p.ro = reinterpret_cast<const float*>(t[20]);
  p.ro_stride = t[21];
  p.feats = reinterpret_cast<float*>(t[22]);
  const long long n_rays = t[23];
  const int flags = static_cast<int>(t[24]);
  const long long freqs[3] = {t[25], t[26], t[27]};
  for (long long f : freqs)
    if (f < 0 || f > kMaxFreqs) return false;
  const long long samples = static_cast<long long>(p.src[0].samples) +
                            p.src[1].samples;
  if (n_rays < 1 || p.src[0].samples < 1 || p.src[1].samples < 0 ||
      n_rays * samples >= (1ll << 31) || p.feats == nullptr)
    return false;
  p.n_rays = static_cast<int>(n_rays);
  p.samples = static_cast<int>(samples);
  p.n_rows = static_cast<int>(n_rays * samples);
  const bool sigma_only = flags & kFlagSigmaOnly;
  p.smoothed_dir = !sigma_only && (flags & kFlagSmoothedDir);
  // the encoded blocks in row order: first channel, channels, frequencies
  struct Block { int ch, c, freqs; bool on; };
  const Block blocks[6] = {
      {0, 3, static_cast<int>(freqs[0]), true},
      {kChDensity, 1, static_cast<int>(freqs[1]), (flags & kFlagDensity) != 0},
      {kChSmoothed, 3, static_cast<int>(freqs[0]),
       (flags & kFlagSmoothedPos) != 0},
      {kChVar, 3, static_cast<int>(freqs[0]), (flags & kFlagVar) != 0},
      {kChDir, 3, static_cast<int>(freqs[2]), !sigma_only},
      {kChSmoothedDir, 3, static_cast<int>(freqs[2]), p.smoothed_dir}};
  int col = 0;
  for (const Block& b : blocks) {
    if (!b.on) continue;
    for (int c = 0; c < b.c; ++c) {
      p.channels |= 1u << (b.ch + c);
      p.ident[p.n_ident++] = (col + c) | (b.ch + c) << 16;
      if (b.ch != kChDir)
        p.grads[p.n_grads++] = (col + c) | (b.ch + c) << 16 | b.c << 20 |
                               b.freqs << 24;
    }
    for (int k = 0; k < b.freqs; ++k)
      for (int c = 0; c < b.c; ++c) {
        if (p.n_pairs == kMaxPairs) return false;
        p.pairs[p.n_pairs++] = (col + b.c * (2 * k + 1) + c) |
                               (b.ch + c) << 16 | k << 20 | b.c << 25;
      }
    col += b.c * (2 * b.freqs + 1);
  }
  if (p.smoothed_dir) p.channels |= 7u << kChSmoothed;  // its source
  const int first[4] = {0, kChDensity, kChSmoothed, kChVar};
  for (int s = 0; s < (p.src[1].samples ? 2 : 1); ++s)
    for (int j = 0; j < 4; ++j)
      if ((p.channels >> first[j] & 1u) && p.src[s].in[j] == nullptr)
        return false;
  if (col > kMaxWidth || p.rays == nullptr || p.ro == nullptr) return false;
  p.width = col;
  // tiles of a multiple of 4 rows (so each starts on 16 bytes), as many as
  // the shared memory budget takes, at most kMaxTileRows
  const int per_row = (p.width + kInStride * (bwd ? 2 : 1)) * 4;
  const int fixed = bwd ? 0 : p.n_pairs * 4;
  p.tile_rows = (kSmemBudget - fixed) / per_row / 4 * 4;
  if (p.tile_rows > kMaxTileRows) p.tile_rows = kMaxTileRows;
  if (p.tile_rows < 4) return false;
  smem = p.tile_rows * per_row + fixed;
  return true;
}

}  // namespace

// ---- entry points (ops/encode.py)

// The rows of one render pass (or of the fine pass's two sources) into
// table[22]: one launch.
extern "C" int nf_encode_fwd(const long long* table, int n_args,
                             void* stream) {
  Plan p;
  int smem;
  if (n_args != kArgs || !make_plan(table, false, p, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.n_rows + p.tile_rows - 1) / p.tile_rows;
  encode_fwd_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The cotangents of the sources' inputs from that of the rows (table[22]):
// one launch.
extern "C" int nf_encode_bwd(const long long* table, int n_args,
                             void* stream) {
  Plan p;
  int smem;
  if (n_args != kArgs || !make_plan(table, true, p, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.n_rows + p.tile_rows - 1) / p.tile_rows;
  encode_bwd_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
