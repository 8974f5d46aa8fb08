// K5: volume-rendering weights for a batch of rays; K6: their backward.
//
// Replaces neurofluid_tpu/ops/pallas_kernels.py `_composite_kernel` (reached
// via `composite_weights` from ray_ops.composite). The TPU kernel turns the
// exclusive running product into a log-space triangular matmul on the MXU;
// here a ray is one warp and the product is a shuffle scan, so the
// transmittance stays a plain product (no log/exp round trip).
//
//   s_i = exp(-(z_{i+1} - z_i) * ||d|| * relu(sigma_i)), last delta = 1e10
//   w_i = (1 - s_i) * prod_{j<i} (s_j + 1e-10)
//
// Bound on the card: bytes. Each sample reads z and sigma and writes w
// (12 B) for about ten operations, far below the H100's ratio of operations
// to bytes. At the render's sizes (1,024 rays of 64 or 192 samples) the
// bytes take a fraction of a microsecond, so what is left to win is latency:
// the launch, and the memory round trips of each ray.
//
// K5 (`composite_weights_kernel`) holds a ray in one warp's registers: each
// lane owns a contiguous run of P samples (P = 1, 2, 4, 6 or 8, the fewest
// that cover the ray, `samples_per_lane`), read with 16- or 8-byte loads
// where the run is whole and aligned (`load_run`); every load of the run (z,
// sigma, and the z after the tile for the last lane) is issued before any
// arithmetic, so a ray of up to 256 samples costs one round trip to memory.
// Each lane forms its run's product of (s + 1e-10); one warp product scan
// gives the transmittance at the run's start; the lane writes w for its run
// with vector stores (`store_run`). Longer rays take tiles of 256 with the
// transmittance carried in a register, so K5 takes rays of any length.
//
// K6 (nf_composite_weights_bwd) replaces pallas_kernels.py
// `_composite_bwd_kernel` (the custom VJP of `composite_weights`). With g the
// cotangent of w and T_i the exclusive product:
//   d sigma_i = delta_i ||d|| s_i 1[sigma_i > 0]
//               (g_i T_i - sum_{k>i} g_k w_k / (s_i + 1e-10))
// The TPU kernel takes the suffix sum as a second triangular matmul. Here
// `composite_weights_bwd_kernel` holds a ray as K5 does, with the same runs,
// loads and stores, and g beside z and sigma. Each lane forms its run's
// product and, after one warp product scan for the transmittance at its
// start, its run's weighted sum; one reverse warp sum scan gives the suffix
// after the run; d sigma leaves with vector stores. Rays of up to 256
// samples are one such pass; longer ones (up to 2,048) take tiles of 256, a
// first pass over the tiles for the transmittance at each tile's start
// (kept in registers), then the tiles from the last, as above. Bound:
// bytes, as K5 (z, sigma, g read, d sigma written: 16 B per sample for ~30
// operations); what remains above it is the launch and one memory round
// trip per ray.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// K5's and K6's blocks (one warp per ray), K6's longest ray, and the tile
// of both kernels: 32 lanes of the most samples a lane holds
constexpr int kWarpsPerBlock = 8;
constexpr int kBwdWarps = 4;
constexpr int kMaxBwdSamples = 2048;
constexpr int kMaxPerLane = 8;
constexpr int kTile = 32 * kMaxPerLane;

// Samples each lane of K5 and K6 holds for rays of n samples: the fewest of
// 1, 2, 4, 6 and 8 whose warp covers the ray, else 8 (tiles of 256).
// Mirrored by ops/composite.samples_per_lane.
int samples_per_lane(int n) {
  if (n <= 32) return 1;
  if (n <= 64) return 2;
  if (n <= 128) return 4;
  if (n <= 192) return 6;
  return kMaxPerLane;
}

// v = src[i0, i0 + P), zero past n: 16- or 8-byte loads where the run lies
// whole in the row and is aligned for them, else one word at a time.
template <int P>
__device__ __forceinline__ void load_run(const float* __restrict__ src,
                                         int i0, int n, float (&v)[P]) {
  constexpr int kVec = P % 4 == 0 ? 4 : (P % 2 == 0 ? 2 : 1);
  const float* p = src + i0;
  const bool whole = i0 + P <= n &&
      (reinterpret_cast<uintptr_t>(p) & (4 * kVec - 1)) == 0;
  if constexpr (kVec == 4) {
    if (whole) {
#pragma unroll
      for (int j = 0; j < P; j += 4) {
        const float4 f = *reinterpret_cast<const float4*>(p + j);
        v[j] = f.x, v[j + 1] = f.y, v[j + 2] = f.z, v[j + 3] = f.w;
      }
      return;
    }
  } else if constexpr (kVec == 2) {
    if (whole) {
#pragma unroll
      for (int j = 0; j < P; j += 2) {
        const float2 f = *reinterpret_cast<const float2*>(p + j);
        v[j] = f.x, v[j + 1] = f.y;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = i0 + j < n ? p[j] : 0.0f;
}

// dst[i0, i0 + P) = v, as load_run reads (nothing past n).
template <int P>
__device__ __forceinline__ void store_run(float* __restrict__ dst, int i0,
                                          int n, const float (&v)[P]) {
  constexpr int kVec = P % 4 == 0 ? 4 : (P % 2 == 0 ? 2 : 1);
  float* p = dst + i0;
  const bool whole = i0 + P <= n &&
      (reinterpret_cast<uintptr_t>(p) & (4 * kVec - 1)) == 0;
  if constexpr (kVec == 4) {
    if (whole) {
#pragma unroll
      for (int j = 0; j < P; j += 4)
        *reinterpret_cast<float4*>(p + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      return;
    }
  } else if constexpr (kVec == 2) {
    if (whole) {
#pragma unroll
      for (int j = 0; j < P; j += 2)
        *reinterpret_cast<float2*>(p + j) = make_float2(v[j], v[j + 1]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (i0 + j < n) p[j] = v[j];
}

// The run of P samples from i0 = base + lane * P of a ray of n samples (a
// tile of 32 P from `base`): loads z and sigma, takes the z after the run
// from the next lane (the last lane loads the first z after the tile),
// and gives per sample sigma, delta ||d|| and the survival s; returns the
// product of (s + 1e-10) over the run's samples in the ray.
template <int P>
__device__ __forceinline__ float survival_run(const float* __restrict__ zr,
                                              const float* __restrict__ sr,
                                              int base, int n, float dn,
                                              int lane, float (&sig)[P],
                                              float (&d)[P], float (&s)[P]) {
  const int i0 = base + lane * P;
  const int after_tile = base + 32 * P;
  float zv[P];
  load_run<P>(zr, i0, n, zv);
  load_run<P>(sr, i0, n, sig);
  const float z_tile = lane == 31 && after_tile < n ? zr[after_tile] : 0.0f;
  float z_after = __shfl_down_sync(kFull, zv[0], 1);
  if (lane == 31) z_after = z_tile;
  float prod = 1.0f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = i0 + j;
    const float zn = j + 1 < P ? zv[j + 1] : z_after;
    d[j] = (i + 1 < n ? zn - zv[j] : 1e10f) * dn;
    s[j] = expf(-(d[j] * fmaxf(sig[j], 0.0f)));
    if (i < n) prod *= s[j] + 1e-10f;
  }
  return prod;
}

// K5: one warp per ray, P samples per lane, tiles of 32 P from the ray's
// start with the transmittance before the tile carried in a register.
template <int P>
__global__ void composite_weights_kernel(const float* __restrict__ sigma,
                                         const float* __restrict__ z,
                                         const float* __restrict__ dnorm,
                                         float* __restrict__ w,
                                         int n_rays, int n) {
  const int ray = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ray >= n_rays) return;  // whole warp leaves together
  const long row = static_cast<long>(ray) * n;
  const float* zr = z + row;
  const float* sr = sigma + row;
  const float dn = dnorm[ray];
  float carry = 1.0f;  // transmittance before this tile
  for (int base = 0; base < n; base += 32 * P) {
    float sig[P], d[P], s[P];
    const float prod = survival_run<P>(zr, sr, base, n, dn, lane, sig, d, s);
    // exclusive product scan over the lanes: T at the start of the run
    float incl = prod;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl *= y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    const int i0 = base + lane * P;
    float t = carry * excl;
    float out[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      out[j] = (1.0f - s[j]) * t;
      if (i0 + j < n) t *= s[j] + 1e-10f;
    }
    store_run<P>(w + row, i0, n, out);
    carry *= __shfl_sync(kFull, incl, 31);
  }
}

// K6: one warp per ray, P samples per lane; kTiles 1 for rays of up to
// 32 P samples, else tiles of kTile (P = kMaxPerLane).
template <int P, int kTiles>
__global__ void composite_weights_bwd_kernel(const float* __restrict__ sigma,
                                             const float* __restrict__ z,
                                             const float* __restrict__ dnorm,
                                             const float* __restrict__ g,
                                             float* __restrict__ d_sigma,
                                             int n_rays, int n) {
  const int ray = blockIdx.x * kBwdWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ray >= n_rays) return;  // whole warp leaves together
  const long row = static_cast<long>(ray) * n;
  const float* zr = z + row;
  const float* sr = sigma + row;
  const float dn = dnorm[ray];
  const int n_tiles = kTiles == 1 ? 1 : (n + 32 * P - 1) / (32 * P);

  // the transmittance at the start of each tile (registers: the loop is
  // unrolled, so every index is known)
  float carry[kTiles];
  carry[0] = 1.0f;
#pragma unroll
  for (int c = 1; c < kTiles; ++c) {
    carry[c] = carry[c - 1];
    if (c < n_tiles) {
      float sig[P], d[P], s[P];
      float prod = survival_run<P>(zr, sr, (c - 1) * 32 * P, n, dn, lane,
                                   sig, d, s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        prod *= __shfl_xor_sync(kFull, prod, o);
      carry[c] *= prod;
    }
  }

  float later = 0.0f;  // sum of g_k w_k over the tiles after this one
  for (int c = n_tiles - 1; c >= 0; --c) {
    float t_tile = carry[0];
#pragma unroll
    for (int j = 1; j < kTiles; ++j)
      if (j == c) t_tile = carry[j];
    const int i0 = c * 32 * P + lane * P;
    float gv[P], sig[P], d[P], s[P];
    load_run<P>(g + row, i0, n, gv);
    const float prod = survival_run<P>(zr, sr, c * 32 * P, n, dn, lane, sig,
                                       d, s);
    // exclusive product scan over the lanes: T at the start of the run
    float incl = prod;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl *= y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    float t = t_tile * excl;
    float tr[P], gw[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const bool in = i0 + j < n;
      tr[j] = t;
      gw[j] = in ? gv[j] * ((1.0f - s[j]) * t) : 0.0f;
      if (in) t *= s[j] + 1e-10f;
    }
    // sum of g w after each sample within the run, and over the run
    float within[P];
    float run_sum = 0.0f;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      within[j] = run_sum;
      run_sum += gw[j];
    }
    // inclusive reverse sum scan over the lanes: rs = sum over lanes >= mine
    float rs = run_sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(kFull, rs, o);
      if (lane + o < 32) rs += y;
    }
    float after = __shfl_down_sync(kFull, rs, 1);  // the lanes after mine
    if (lane == 31) after = 0.0f;
    after += later;
    float out[P];
#pragma unroll
    for (int j = 0; j < P; ++j)
      out[j] = sig[j] > 0.0f
                   ? d[j] * s[j] *
                         (gv[j] * tr[j] - (after + within[j]) /
                                              (s[j] + 1e-10f))
                   : 0.0f;
    store_run<P>(d_sigma + row, i0, n, out);
    later += __shfl_sync(kFull, rs, 0);
  }
}

}  // namespace

// K5. per_lane: samples each lane holds, as ops/composite.samples_per_lane
// chooses them; another per_lane is refused with cudaErrorInvalidValue.
extern "C" int nf_composite_weights(const float* sigma, const float* z,
                                    const float* dnorm, float* w, int n_rays,
                                    int n_samples, int per_lane,
                                    void* stream) {
  if (per_lane != samples_per_lane(n_samples))
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = void (*)(const float*, const float*, const float*, float*,
                         int, int);
  Launch kernel = composite_weights_kernel<kMaxPerLane>;
  switch (per_lane) {
    case 1: kernel = composite_weights_kernel<1>; break;
    case 2: kernel = composite_weights_kernel<2>; break;
    case 4: kernel = composite_weights_kernel<4>; break;
    case 6: kernel = composite_weights_kernel<6>; break;
  }
  const int blocks = (n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<blocks, kWarpsPerBlock * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(sigma, z, dnorm, w, n_rays,
                                                n_samples);
  return static_cast<int>(cudaGetLastError());
}

// K6. per_lane: as for K5; rays of more than kMaxBwdSamples samples, or
// another per_lane, are refused with cudaErrorInvalidValue.
extern "C" int nf_composite_weights_bwd(const float* sigma, const float* z,
                                        const float* dnorm, const float* g,
                                        float* d_sigma, int n_rays,
                                        int n_samples, int per_lane,
                                        void* stream) {
  if (n_samples > kMaxBwdSamples ||
      per_lane != samples_per_lane(n_samples))
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = void (*)(const float*, const float*, const float*,
                         const float*, float*, int, int);
  Launch kernel = composite_weights_bwd_kernel<kMaxPerLane, 1>;
  switch (per_lane) {
    case 1: kernel = composite_weights_bwd_kernel<1, 1>; break;
    case 2: kernel = composite_weights_bwd_kernel<2, 1>; break;
    case 4: kernel = composite_weights_bwd_kernel<4, 1>; break;
    case 6: kernel = composite_weights_bwd_kernel<6, 1>; break;
    default:
      if (n_samples > kTile)
        kernel = composite_weights_bwd_kernel<kMaxPerLane,
                                              kMaxBwdSamples / kTile>;
  }
  const int blocks = (n_rays + kBwdWarps - 1) / kBwdWarps;
  kernel<<<blocks, kBwdWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      sigma, z, dnorm, g, d_sigma, n_rays, n_samples);
  return static_cast<int>(cudaGetLastError());
}
