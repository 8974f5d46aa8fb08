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
// to bytes. The design keeps the accesses coalesced (lane i of a warp owns
// sample base + i of its ray) and touches each byte once; the carry between
// 32-sample chunks lives in a register.
//
// K6 (nf_composite_weights_bwd) replaces pallas_kernels.py
// `_composite_bwd_kernel` (the custom VJP of `composite_weights`). With g the
// cotangent of w and T_i the exclusive product:
//   d sigma_i = delta_i ||d|| s_i 1[sigma_i > 0]
//               (g_i T_i - sum_{k>i} g_k w_k / (s_i + 1e-10))
// The TPU kernel takes the suffix sum as a second triangular matmul. Here
// a ray is again one warp: a forward pass of shuffle product scans keeps
// the transmittance at the start of each 32-sample chunk in shared memory,
// then the chunks are walked from the last to the first, each with a
// reverse (shfl_down) sum scan and a running suffix carry. Bound: bytes, as
// K5 (z, sigma, g read, d sigma written: 16 B per sample for ~30
// operations).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__global__ void composite_weights_kernel(const float* __restrict__ sigma,
                                         const float* __restrict__ z,
                                         const float* __restrict__ dnorm,
                                         float* __restrict__ w,
                                         int n_rays, int n_samples) {
  const int ray = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ray >= n_rays) return;  // whole warp leaves together
  const long row = static_cast<long>(ray) * n_samples;
  const float dn = dnorm[ray];
  float carry = 1.0f;  // transmittance before this chunk
  for (int base = 0; base < n_samples; base += 32) {
    const int i = base + lane;
    float surv = 1.0f;
    float factor = 1.0f;
    if (i < n_samples) {
      const float zi = z[row + i];
      const float delta =
          (i + 1 < n_samples) ? (z[row + i + 1] - zi) : 1e10f;
      surv = expf(-(delta * dn * fmaxf(sigma[row + i], 0.0f)));
      factor = surv + 1e-10f;
    }
    // inclusive product scan over the 32 lanes
    float incl = factor;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl *= y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    if (i < n_samples) w[row + i] = (1.0f - surv) * (carry * excl);
    carry *= __shfl_sync(kFull, incl, 31);
  }
}

// carries per ray kept in shared memory: samples per ray <= 32 * kMaxChunks
constexpr int kMaxChunks = 64;

__global__ void composite_weights_bwd_kernel(const float* __restrict__ sigma,
                                             const float* __restrict__ z,
                                             const float* __restrict__ dnorm,
                                             const float* __restrict__ g,
                                             float* __restrict__ d_sigma,
                                             int n_rays, int n_samples) {
  __shared__ float carries[kWarpsPerBlock][kMaxChunks];
  const int warp = threadIdx.x / 32;
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  const int lane = threadIdx.x % 32;
  if (ray >= n_rays) return;  // whole warp leaves together
  const long row = static_cast<long>(ray) * n_samples;
  const float dn = dnorm[ray];
  const int n_chunks = (n_samples + 31) / 32;
  float* carry_of = carries[warp];

  // forward: the transmittance at the start of every chunk
  float carry = 1.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int i = c * 32 + lane;
    float factor = 1.0f;
    if (i < n_samples) {
      const float zi = z[row + i];
      const float delta = (i + 1 < n_samples) ? (z[row + i + 1] - zi) : 1e10f;
      factor = expf(-(delta * dn * fmaxf(sigma[row + i], 0.0f))) + 1e-10f;
    }
    float incl = factor;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl *= y;
    }
    if (lane == 0) carry_of[c] = carry;
    carry *= __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();

  // backward, last chunk first: suffix_i = sum_{k>i} g_k w_k
  float suffix_carry = 0.0f;  // sum over the chunks after this one
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int i = c * 32 + lane;
    float surv = 1.0f, factor = 1.0f, d = 0.0f, gi = 0.0f, si = 0.0f;
    if (i < n_samples) {
      const float zi = z[row + i];
      const float delta = (i + 1 < n_samples) ? (z[row + i + 1] - zi) : 1e10f;
      d = delta * dn;
      si = sigma[row + i];
      surv = expf(-(d * fmaxf(si, 0.0f)));
      factor = surv + 1e-10f;
      gi = g[row + i];
    }
    float incl = factor;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl *= y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    const float t = carry_of[c] * excl;
    const float gw = gi * ((1.0f - surv) * t);
    // inclusive reverse scan: rs = sum_{l >= lane} gw_l within the chunk
    float rs = gw;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(kFull, rs, o);
      if (lane + o < 32) rs += y;
    }
    float suffix = __shfl_down_sync(kFull, rs, 1);  // exclusive
    if (lane == 31) suffix = 0.0f;
    suffix += suffix_carry;
    if (i < n_samples)
      d_sigma[row + i] =
          si > 0.0f ? d * surv * (gi * t - suffix / (surv + 1e-10f)) : 0.0f;
    suffix_carry += __shfl_sync(kFull, rs, 0);
  }
}

}  // namespace

extern "C" int nf_composite_weights(const float* sigma, const float* z,
                                    const float* dnorm, float* w, int n_rays,
                                    int n_samples, void* stream) {
  const int blocks = (n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_weights_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      sigma, z, dnorm, w, n_rays, n_samples);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_composite_weights_bwd(const float* sigma, const float* z,
                                        const float* dnorm, const float* g,
                                        float* d_sigma, int n_rays,
                                        int n_samples, void* stream) {
  if (n_samples > 32 * kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_weights_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      sigma, z, dnorm, g, d_sigma, n_rays, n_samples);
  return static_cast<int>(cudaGetLastError());
}
