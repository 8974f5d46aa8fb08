// K1: fused continuous convolution, forward; K2: its backward.
//
// Replaces neurofluid_tpu/ops/fused_cconv.py `_fwd_kernel` (reached via
// `_run_fwd` from `fused_cconv`, called by every ContinuousConvLayer of a
// ParticleNet step). For each sorted query row:
//
//   out[q] = sum_{t, c} A[q, t, c] * W[t * Cin + c, :]
//   A[q, t, :] = sum over candidates p of the query's 9 column slabs with
//                d^2/r^2 <= 1 (and d > 0 when exclude_self) of
//                poly6(min(d^2/r^2, 2)) * tap_t(ball_to_cube(dp / r)) * f_p
//   cnt[q] = number of such candidates
//
// where tap_t is the trilinear weight of filter tap t (8 non-zero corners).
//
// Design. The TPU kernel builds a (64 * T_g, Cin) tap-feature block for a
// whole 16-query group in VMEM (393 KB at Cin = 96) and walks candidates in
// 128-lane chunks. A Hopper block has at most 227 KB of shared memory, so a
// block here owns `qb` queries of one group (qb = 16, 8 or 4 as Cin grows,
// so that qb * 64 * Cin floats stay under 132 KB) and keeps one (64, Cin)
// accumulator per query in shared memory. All blocks of a group walk the
// group's 9 slabs in tiles of 32 candidates:
//   phase 1, one thread per (query, candidate): the in-radius test, the
//     window, the ball-to-cube map and the trilinear corners in corner /
//     fraction form, so a pair costs 8 taps, not 64;
//   phase 2, one thread per (query, channel): add the 8 weighted features
//     of every in-radius pair of the tile into its own accumulator column,
//     so no two threads ever write the same word and no atomics are needed;
//     the walk visits only the in-radius pairs (the phase-1 ballot mask,
//     about one candidate in eight at the bench point);
//   fold, once per query block: contract the accumulators with W; thread
//     (o, ks) sums a contiguous k range for all qb queries, reading the
//     accumulators as float4 and W coalesced across o, and the ks partial
//     sums are reduced in a fixed order. qb is a template constant, so the
//     per-query loops carry no predicated-off work.
// Groups own disjoint ranges of sorted rows (gstart), so every output row is
// written exactly once, by the block that owns its query: no zero-fill and
// no cross-block ordering are needed (the TPU kernel zero-initialised its
// outputs from program 0, valid only on a sequential grid).
//
// Bound on the card: operations. At the bench point the pair geometry
// (about 70 operations per in-radius pair) and the tap accumulation
// (16 * Cin per in-radius pair) dominate for small Cin, and the fold
// (2 * 64 * Cin * Cout per query) for the wide layers; every input is read
// once from device memory, with W re-read from L2 by each query block.
// The squared distance is computed without contraction
// (__fmul_rn/__fadd_rn), in the order of the plain version, so the two agree
// exactly on which pairs are in radius.
//
// K2 (nf_fused_cconv_bwd, below) replaces fused_cconv.py `_bwd_kernel`
// (reached via `_run_bwd` from the custom VJP of `fused_cconv`). With ct the
// (Nq, Cout) cotangent of `out`, d_acc[q, t, :] = ct[q] W_t^T, and per
// in-radius pair (q, p) the windowed tap weights w_t:
//   dfeats[p] += sum_t w_t d_acc[q, t, :]
//   g_t        = <d_acc[q, t, :], f_p>, pushed through the geometry adjoint
//                (window, ball -> cube map, taps) into g_off; then
//                dc[p] += g_off / r and dq[q] -= g_off / r
//   dW[t]      = sum_q A[q, t, :]^T ct[q]
// Design. K2 walks the candidates exactly as K1 does (same query blocks,
// same 32-candidate tiles, same in-radius test), with d_acc for the block's
// queries in shared memory beside the recomputed accumulators A:
//   phase 1, thread per (query, candidate): the pair geometry as K1; for
//     the position gradient also the 8 tap-weight cotangents (a Cin-long
//     dot each) and the hand-derived adjoint of the geometry. dq is summed
//     over the warp (one warp is one query) into shared memory and stored
//     once per query by the block that owns it; dc goes through shared
//     atomics into a per-tile sum, then one global f32 atomic per candidate
//     and axis;
//   phase 2, thread per (query, channel): A as in K1;
//   phase 3, thread per (candidate, channel): dfeats summed over the
//     block's queries in registers, then one global f32 atomic.
// Blocks of other groups add into the same dc and dfeats rows, so their
// summation order varies from run to run. The walk writes A's rows (Nq, 64
// Cin) to device memory, and two more kernels reduce them against ct: f32
// (64 x 32)-tiles of A^T ct over fixed splits of the rows, then the splits
// summed in order, so dW is deterministic. The TPU kernel accumulated all
// four by read-modify-write on its sequential grid.
// Bound on the card: operations, as K1 (the pair geometry and the 8 * Cin
// products per pair for A and for dfeats), plus the dW reduction,
// 2 * Nq * 64 * Cin * Cout. The A rows are scratch of this design, not
// bytes the function has to move, so the bound leaves them out.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // candidates per pass; one warp per query in phase 1
// W loads in flight per fold thread: the fold streams W from L2 and is
// bound by the bytes in flight per SM (8 loads reached ~2.3 TB/s)
constexpr int kFoldBatch = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-8f;
constexpr float kFourOverPi = 1.27323954473516f;

__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

// arctan on [-1, 1]: the odd minimax polynomial of the TPU kernel (_atan01)
__device__ __forceinline__ float atan01(float t) {
  const float u = t * t;
  float acc = 3.049968069371e-03f;
  acc = acc * u - 1.682744852802e-02f;
  acc = acc * u + 4.385559905435e-02f;
  acc = acc * u - 7.596809867133e-02f;
  acc = acc * u + 1.068142103287e-01f;
  acc = acc * u - 1.421319619692e-01f;
  acc = acc * u + 1.999371614268e-01f;
  acc = acc * u - 3.333312078100e-01f;
  acc = acc * u + 9.999999880828e-01f;
  return acc * t;
}

// volume-preserving unit ball -> unit cube (ball -> cylinder -> cube)
__device__ __forceinline__ void ball_to_cube(float x, float y, float z,
                                             float sq_norm, float& ux,
                                             float& uy, float& uz) {
  const bool degenerate = sq_norm < kEps * kEps;
  const float norm = sqrtf(degenerate ? 1.0f : sq_norm);
  const float rho2 = x * x + y * y;
  float cx, cy, cz;
  if (1.25f * z * z > rho2) {  // cap region -> end discs
    const float s = sqrtf(3.0f * norm / (norm + fabsf(z) + kEps));
    cx = x * s;
    cy = y * s;
    cz = sgn(z) * norm;
  } else {  // side band -> lateral surface
    const float s = norm / sqrtf(fmaxf(rho2, kEps * kEps));
    cx = x * s;
    cy = y * s;
    cz = 1.5f * z;
  }
  if (degenerate) cx = cy = cz = 0.0f;
  uz = cz;
  const float crho2 = cx * cx + cy * cy;
  if (crho2 < kEps * kEps) {
    ux = uy = 0.0f;
    return;
  }
  const float crho = sqrtf(crho2);
  if (fabsf(cx) >= fabsf(cy)) {  // inverse Shirley-Chiu, |x| >= |y| wedge
    const float safe_x = fabsf(cx) < kEps ? 1.0f : cx;
    ux = sgn(cx) * crho;
    uy = kFourOverPi * ux * atan01(fminf(fmaxf(cy / safe_x, -1.0f), 1.0f));
  } else {
    const float safe_y = fabsf(cy) < kEps ? 1.0f : cy;
    uy = sgn(cy) * crho;
    ux = kFourOverPi * uy * atan01(fminf(fmaxf(cx / safe_y, -1.0f), 1.0f));
  }
}

// trilinear corner (i0) and fraction on a k-tap axis, align_corners=True
__device__ __forceinline__ void axis_tap(float u, int k, int& i0, float& f) {
  const float km1 = static_cast<float>(k - 1);
  const float t = fminf(fmaxf((u * 0.5f + 0.5f) * km1, 0.0f), km1);
  i0 = min(max(static_cast<int>(floorf(t)), 0), k - 2);
  f = t - static_cast<float>(i0);
}

template <int QB>
__global__ void __launch_bounds__(kThreads) fused_cconv_fwd_kernel(
    const int* __restrict__ gcol, const int* __restrict__ gzlo,
    const int* __restrict__ gzhi, const int* __restrict__ gstart,
    const int* __restrict__ pstarts, const float* __restrict__ qpos,
    const float* __restrict__ cpos, const float* __restrict__ feats,
    const float* __restrict__ w, float* __restrict__ out,
    float* __restrict__ cnt, int d0, int d1, int d2, int kz, int ky, int kx,
    int cin, int cout, float inv_r, int exclude_self) {
  constexpr int qb = QB;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_start[9], s_len[9];
  const int g = blockIdx.x;
  const int col = gcol[g];
  if (col >= d0 * d1) return;  // empty tail group: owns no rows
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int n_taps = kz * ky * kx;
  const int tap_len = n_taps * cin;
  const int pairs = qb * kTile;
  float* acc = smem;                                    // qb * tap_len
  float* fe = acc + qb * tap_len;                       // kTile * cin
  float* cp = fe + kTile * cin;                         // kTile * 3
  float* pw = cp + kTile * 3;                           // 8 * pairs
  int* pt = reinterpret_cast<int*>(pw + 8 * pairs);     // pairs
  float* qp = reinterpret_cast<float*>(pt + pairs);     // qb * 3
  int* qcnt = reinterpret_cast<int*>(qp + qb * 3);      // qb
  unsigned* qmask = reinterpret_cast<unsigned*>(qcnt + qb);  // qb
  float* red = reinterpret_cast<float*>(qmask + qb);    // kThreads * qb

  const int q0 = gstart[g];
  const int gcount = gstart[g + 1] - q0;
  if (tid < 9) {
    const int nx = col / d1 + tid / 3 - 1, ny = col % d1 + tid % 3 - 1;
    const bool ok = nx >= 0 && nx < d0 && ny >= 0 && ny < d1;
    const int base = (nx * d1 + ny) * d2;
    const int z0 = max(gzlo[g] - 1, 0), z1 = min(gzhi[g] + 1, d2 - 1);
    s_start[tid] = ok ? pstarts[base + z0] : 0;
    s_len[tid] = ok ? pstarts[base + z1 + 1] - pstarts[base + z0] : 0;
  }
  const int ks_count = kThreads / cout;  // fold: k split across threads
  const int fo = tid % cout, fks = tid / cout;

  // A group longer than group_size (only if the plan's overflow flag is
  // set) is still covered: the blocks of the group stride over its rows.
  for (int b0 = blockIdx.y * qb; b0 < gcount; b0 += gridDim.y * qb) {
    const int nq = min(qb, gcount - b0);
    for (int i = tid; i < qb * tap_len; i += kThreads) acc[i] = 0.0f;
    if (tid < qb * 3)
      qp[tid] = tid / 3 < nq ? qpos[static_cast<long>(q0 + b0) * 3 + tid]
                             : 0.0f;
    if (tid < qb) qcnt[tid] = 0;
    __syncthreads();

    for (int sl = 0; sl < 9; ++sl) {
      const int start = s_start[sl], len = s_len[sl];
      for (int c0 = 0; c0 < len; c0 += kTile) {
        const int nc = min(kTile, len - c0);
        const long crow = static_cast<long>(start) + c0;
        for (int i = tid; i < nc * 3; i += kThreads) cp[i] = cpos[crow * 3 + i];
        for (int i = tid; i < nc * cin; i += kThreads)
          fe[i] = feats[crow * cin + i];
        __syncthreads();

        // phase 1: pair geometry; a warp is the 32 candidates of one query
        for (int p = tid; p < pairs; p += kThreads) {
          const int q = p / kTile, j = p % kTile;
          bool within = false;
          if (q < nq && j < nc) {
            const float ox = __fmul_rn(__fsub_rn(cp[3 * j], qp[3 * q]), inv_r);
            const float oy =
                __fmul_rn(__fsub_rn(cp[3 * j + 1], qp[3 * q + 1]), inv_r);
            const float oz =
                __fmul_rn(__fsub_rn(cp[3 * j + 2], qp[3 * q + 2]), inv_r);
            const float d2n = __fadd_rn(
                __fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)),
                __fmul_rn(oz, oz));
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
              pt[p] = (iz * ky + iy) * kx + ix;
              const float wz[2] = {(1.0f - fz) * win, fz * win};
              const float wy[2] = {1.0f - fy, fy};
              const float wx[2] = {1.0f - fx, fx};
#pragma unroll
              for (int c = 0; c < 8; ++c)
                pw[c * pairs + p] = wz[c >> 2] * wy[(c >> 1) & 1] * wx[c & 1];
            }
          }
          const unsigned hits = __ballot_sync(kFull, within);
          if (lane == 0) {  // one warp per q
            qcnt[q] += __popc(hits);
            qmask[q] = hits;
          }
        }
        __syncthreads();

        // phase 2: thread (q, c) owns accumulator column acc[q, :, c]
        const int sy = kx, sz = ky * kx;
        for (int item = tid; item < qb * cin; item += kThreads) {
          const int q = item / cin, c = item % cin;
          float* a = acc + q * tap_len + c;
          for (unsigned m = qmask[q]; m != 0; m &= m - 1) {
            const int p = q * kTile + __ffs(m) - 1;
            const int tap = pt[p];
            const float f = fe[(p - q * kTile) * cin + c];
            float* at = a + tap * cin;
            at[0] += pw[p] * f;
            at[cin] += pw[pairs + p] * f;
            at[sy * cin] += pw[2 * pairs + p] * f;
            at[(sy + 1) * cin] += pw[3 * pairs + p] * f;
            at[sz * cin] += pw[4 * pairs + p] * f;
            at[(sz + 1) * cin] += pw[5 * pairs + p] * f;
            at[(sz + sy) * cin] += pw[6 * pairs + p] * f;
            at[(sz + sy + 1) * cin] += pw[7 * pairs + p] * f;
          }
        }
        __syncthreads();
      }
    }

    // fold: out[q, o] = sum_k acc[q, k] * W[k, o]; thread (o, ks) sums a
    // contiguous k range (a multiple of 4 long, so float4 reads stay aligned)
    if (fks < ks_count) {
      float part[QB];
#pragma unroll
      for (int q = 0; q < QB; ++q) part[q] = 0.0f;
      const int chunk = ((tap_len + ks_count - 1) / ks_count + 3) & ~3;
      const int k_end = min(tap_len, (fks + 1) * chunk);
      int k = fks * chunk;
      if ((tap_len & 3) == 0) {
        for (; k + kFoldBatch <= k_end; k += kFoldBatch) {
          float wv[kFoldBatch];
#pragma unroll
          for (int u = 0; u < kFoldBatch; ++u)
            wv[u] = __ldg(w + static_cast<long>(k + u) * cout + fo);
#pragma unroll
          for (int u = 0; u < kFoldBatch; u += 4) {
#pragma unroll
            for (int q = 0; q < QB; ++q) {
              const float4 a =
                  *reinterpret_cast<const float4*>(acc + q * tap_len + k + u);
              part[q] += a.x * wv[u];
              part[q] += a.y * wv[u + 1];
              part[q] += a.z * wv[u + 2];
              part[q] += a.w * wv[u + 3];
            }
          }
        }
        for (; k + 4 <= k_end; k += 4) {
          float wv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            wv[u] = __ldg(w + static_cast<long>(k + u) * cout + fo);
#pragma unroll
          for (int q = 0; q < QB; ++q) {
            const float4 a =
                *reinterpret_cast<const float4*>(acc + q * tap_len + k);
            part[q] += a.x * wv[0];
            part[q] += a.y * wv[1];
            part[q] += a.z * wv[2];
            part[q] += a.w * wv[3];
          }
        }
      }
      for (; k < k_end; ++k) {
        const float wv = __ldg(w + static_cast<long>(k) * cout + fo);
#pragma unroll
        for (int q = 0; q < QB; ++q) part[q] += acc[q * tap_len + k] * wv;
      }
#pragma unroll
      for (int q = 0; q < QB; ++q) red[(fks * QB + q) * cout + fo] = part[q];
    }
    __syncthreads();
    for (int item = tid; item < nq * cout; item += kThreads) {
      const int q = item / cout, o = item % cout;
      float v = 0.0f;
      for (int ks = 0; ks < ks_count; ++ks) v += red[(ks * qb + q) * cout + o];
      out[static_cast<long>(q0 + b0 + q) * cout + o] = v;
    }
    if (tid < nq) cnt[q0 + b0 + tid] = static_cast<float>(qcnt[tid]);
    __syncthreads();
  }
}

template <int QB>
int launch(const int* gcol, const int* gzlo, const int* gzhi,
           const int* gstart, const int* pstarts, const float* qpos,
           const float* cpos, const float* feats, const float* w, float* out,
           float* cnt, int n_groups, int group_size, int d0, int d1, int d2,
           int kz, int ky, int kx, int cin, int cout, float inv_r,
           int exclude_self, cudaStream_t stream) {
  const int tap_len = kz * ky * kx * cin;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(QB) * tap_len + kTile * cin +
                       kTile * 3 + 8 * QB * kTile + QB * kTile + QB * 3 +
                       2 * QB + static_cast<size_t>(kThreads) * QB);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_cconv_fwd_kernel<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_groups, (group_size + QB - 1) / QB);
  fused_cconv_fwd_kernel<QB><<<grid, kThreads, smem, stream>>>(
      gcol, gzlo, gzhi, gstart, pstarts, qpos, cpos, feats, w, out, cnt, d0,
      d1, d2, kz, ky, kx, cin, cout, inv_r, exclude_self);
  return static_cast<int>(cudaGetLastError());
}


// d atan01 / dt
__device__ __forceinline__ float atan01_grad(float t) {
  const float u = t * t;
  float acc = 17.0f * 3.049968069371e-03f;
  acc = acc * u - 15.0f * 1.682744852802e-02f;
  acc = acc * u + 13.0f * 4.385559905435e-02f;
  acc = acc * u - 11.0f * 7.596809867133e-02f;
  acc = acc * u + 9.0f * 1.068142103287e-01f;
  acc = acc * u - 7.0f * 1.421319619692e-01f;
  acc = acc * u + 5.0f * 1.999371614268e-01f;
  acc = acc * u - 3.0f * 3.333312078100e-01f;
  acc = acc * u + 9.999999880828e-01f;
  return acc;
}

// Adjoint of one pair's windowed tap weights: g8 (cotangent of the 8
// corner weights times the window, corners z outer, x inner) -> cotangent
// of the normalized offset (x, y, z). The forward is recomputed; the
// selected branch of every choice is differentiated, sign' = 0, a clamp
// passes the gradient inside its closed range, and a degenerate offset gets
// zero (ops/cconv.py `tap_weights_vjp`, the plain twin).
__device__ void pair_vjp(float x, float y, float z, float d2n, int kz, int ky,
                         int kx, const float* g8, float& gx, float& gy,
                         float& gz) {
  gx = gy = gz = 0.0f;
  if (d2n < kEps * kEps) return;
  // window on min(d2n, 2)
  const float tw = 1.0f - fminf(d2n, 2.0f);
  const float tw3 = tw * tw * tw;
  const float win = fminf(fmaxf(tw3, 0.0f), 1.0f);
  const float dwin =
      (tw3 >= 0.0f && tw3 <= 1.0f && d2n <= 2.0f) ? -3.0f * tw * tw : 0.0f;
  // ball -> cylinder
  const float norm = sqrtf(d2n);
  const float rho2 = x * x + y * y;
  const bool cap = 1.25f * z * z > rho2;
  const float den = norm + fabsf(z) + kEps;
  const float s_cap = sqrtf(3.0f * norm / den);
  const float m = sqrtf(fmaxf(rho2, kEps * kEps));
  const float s = cap ? s_cap : norm / m;
  const float cx = x * s, cy = y * s;
  const float cz = cap ? sgn(z) * norm : 1.5f * z;
  // cylinder -> cube; `lead` is the wedge's major-axis output
  const float crho2 = cx * cx + cy * cy;
  const bool cdeg = crho2 < kEps * kEps;
  const float crho = sqrtf(cdeg ? 1.0f : crho2);
  const bool x_ge = fabsf(cx) >= fabsf(cy);
  const float num = x_ge ? cy : cx, dnm = x_ge ? cx : cy;
  const bool small = fabsf(dnm) < kEps;
  const float safe = small ? 1.0f : dnm;
  const float ratio_raw = num / safe;
  const float ratio = fminf(fmaxf(ratio_raw, -1.0f), 1.0f);
  const float at = atan01(ratio);
  const float lead = sgn(dnm) * crho;
  const float other = kFourOverPi * lead * at;
  const float ux = cdeg ? 0.0f : (x_ge ? lead : other);
  const float uy = cdeg ? 0.0f : (x_ge ? other : lead);
  // trilinear taps
  int i0[3];
  float f[3], scale[3];
  bool inside[3];
  const float u3[3] = {ux, uy, cz};
  const int k3[3] = {kx, ky, kz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float km1 = static_cast<float>(k3[a] - 1);
    const float traw = (u3[a] * 0.5f + 0.5f) * km1;
    axis_tap(u3[a], k3[a], i0[a], f[a]);
    inside[a] = traw >= 0.0f && traw <= km1;
    scale[a] = 0.5f * km1;
  }
  // taps backward
  const float wz[2] = {1.0f - f[2], f[2]};
  const float wy[2] = {1.0f - f[1], f[1]};
  const float wx[2] = {1.0f - f[0], f[0]};
  float g_win = 0.0f, gfx = 0.0f, gfy = 0.0f, gfz = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dz = c >> 2, dy = (c >> 1) & 1, dx = c & 1;
    const float g = g8[c];
    g_win += g * wz[dz] * wy[dy] * wx[dx];
    const float gw = g * win;
    gfx += gw * wz[dz] * wy[dy] * (dx ? 1.0f : -1.0f);
    gfy += gw * wz[dz] * wx[dx] * (dy ? 1.0f : -1.0f);
    gfz += gw * wy[dy] * wx[dx] * (dz ? 1.0f : -1.0f);
  }
  const float gux = inside[0] ? gfx * scale[0] : 0.0f;
  const float guy = inside[1] ? gfy * scale[1] : 0.0f;
  const float gcz = inside[2] ? gfz * scale[2] : 0.0f;
  // cylinder -> cube backward
  float gcx = 0.0f, gcy = 0.0f;
  if (!cdeg) {
    const float g_lead_out = x_ge ? gux : guy;
    const float g_other = x_ge ? guy : gux;
    const float g_crho = (g_lead_out + g_other * kFourOverPi * at) * sgn(dnm);
    float g_ratio = g_other * kFourOverPi * lead * atan01_grad(ratio);
    if (!(ratio_raw >= -1.0f && ratio_raw <= 1.0f)) g_ratio = 0.0f;
    const float g_num = g_ratio / safe;
    const float g_dnm = small ? 0.0f : -g_ratio * ratio_raw / safe;
    gcx = (x_ge ? g_dnm : g_num) + g_crho * cx / crho;
    gcy = (x_ge ? g_num : g_dnm) + g_crho * cy / crho;
  }
  // ball -> cylinder backward
  const float g_s = gcx * x + gcy * y;
  gx = gcx * s;
  gy = gcy * s;
  float g_norm;
  if (cap) {
    const float g_v = g_s / (2.0f * s_cap);
    g_norm = gcz * sgn(z) + g_v * 3.0f / den * (1.0f - norm / den);
    gz = -g_v * 3.0f * norm / (den * den) * sgn(z);
  } else {
    const float g_m = rho2 >= kEps * kEps ? -g_s * norm / (m * m * m) : 0.0f;
    g_norm = g_s / m;
    gx += g_m * x;
    gy += g_m * y;
    gz = 1.5f * gcz;
  }
  const float g_r = g_norm / norm + 2.0f * g_win * dwin;
  gx += g_r * x;
  gy += g_r * y;
  gz += g_r * z;
}

template <int QB>
__global__ void __launch_bounds__(kThreads) fused_cconv_bwd_kernel(
    const int* __restrict__ gcol, const int* __restrict__ gzlo,
    const int* __restrict__ gzhi, const int* __restrict__ gstart,
    const int* __restrict__ pstarts, const float* __restrict__ qpos,
    const float* __restrict__ cpos, const float* __restrict__ feats,
    const float* __restrict__ wt, const float* __restrict__ ct,
    float* __restrict__ acc_out, float* __restrict__ dq,
    float* __restrict__ dc, float* __restrict__ df, int d0, int d1, int d2,
    int kz, int ky, int kx, int cin, int cout, float inv_r,
    int exclude_self) {
  constexpr int qb = QB;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_start[9], s_len[9];
  const int g = blockIdx.x;
  const int col = gcol[g];
  if (col >= d0 * d1) return;  // empty tail group: owns no rows
  const bool need_acc = acc_out != nullptr;
  const bool need_pos = dq != nullptr;
  const bool need_f = df != nullptr;
  const bool need_dacc = need_pos || need_f;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int n_taps = kz * ky * kx;
  const int tap_len = n_taps * cin;
  const int cs = cin | 1;  // odd row stride: no bank conflicts across taps
  const int dlen = n_taps * cs;
  const int pairs = qb * kTile;
  float* acc = smem;                                        // qb * tap_len
  float* dacc = acc + (need_acc ? qb * tap_len : 0);        // qb * dlen
  float* fe = dacc + (need_dacc ? qb * dlen : 0);           // kTile * cs
  float* cp = fe + kTile * cs;                              // kTile * 3
  float* pw = cp + kTile * 3;                               // 8 * pairs
  int* pt = reinterpret_cast<int*>(pw + 8 * pairs);         // pairs
  float* qp = reinterpret_cast<float*>(pt + pairs);         // qb * 3
  float* sct = qp + qb * 3;                                 // qb * cout
  unsigned* qmask = reinterpret_cast<unsigned*>(sct + qb * cout);  // qb
  float* sdq = reinterpret_cast<float*>(qmask + qb);        // qb * 3
  float* sdc = sdq + qb * 3;                                // kTile * 3

  const int q0 = gstart[g];
  const int gcount = gstart[g + 1] - q0;
  if (tid < 9) {
    const int nx = col / d1 + tid / 3 - 1, ny = col % d1 + tid % 3 - 1;
    const bool ok = nx >= 0 && nx < d0 && ny >= 0 && ny < d1;
    const int base = (nx * d1 + ny) * d2;
    const int z0 = max(gzlo[g] - 1, 0), z1 = min(gzhi[g] + 1, d2 - 1);
    s_start[tid] = ok ? pstarts[base + z0] : 0;
    s_len[tid] = ok ? pstarts[base + z1 + 1] - pstarts[base + z0] : 0;
  }
  const int sy = kx, sz = ky * kx;
  const int coff[8] = {0, 1, sy, sy + 1, sz, sz + 1, sz + sy, sz + sy + 1};

  for (int b0 = blockIdx.y * qb; b0 < gcount; b0 += gridDim.y * qb) {
    const int nq = min(qb, gcount - b0);
    const long row0 = static_cast<long>(q0 + b0);
    if (need_acc)
      for (int i = tid; i < qb * tap_len; i += kThreads) acc[i] = 0.0f;
    if (tid < qb * 3) {
      qp[tid] = tid / 3 < nq ? qpos[row0 * 3 + tid] : 0.0f;
      sdq[tid] = 0.0f;
    }
    for (int i = tid; i < qb * cout; i += kThreads)
      sct[i] = i / cout < nq ? ct[row0 * cout + i] : 0.0f;
    __syncthreads();
    // d_acc[q, t, c] = sum_o ct[q, o] W[t * cin + c, o] (wt is W^T)
    if (need_dacc) {
      for (int k = tid; k < tap_len; k += kThreads) {
        float part[QB];
#pragma unroll
        for (int q = 0; q < QB; ++q) part[q] = 0.0f;
        for (int o = 0; o < cout; ++o) {
          const float wv = __ldg(wt + static_cast<long>(o) * tap_len + k);
#pragma unroll
          for (int q = 0; q < QB; ++q) part[q] += sct[q * cout + o] * wv;
        }
        const int t = k / cin, c = k % cin;
#pragma unroll
        for (int q = 0; q < QB; ++q) dacc[q * dlen + t * cs + c] = part[q];
      }
    }
    __syncthreads();

    for (int sl = 0; sl < 9; ++sl) {
      const int start = s_start[sl], len = s_len[sl];
      for (int c0 = 0; c0 < len; c0 += kTile) {
        const int nc = min(kTile, len - c0);
        const long crow = static_cast<long>(start) + c0;
        for (int i = tid; i < nc * 3; i += kThreads) cp[i] = cpos[crow * 3 + i];
        for (int i = tid; i < nc * cin; i += kThreads)
          fe[(i / cin) * cs + i % cin] = feats[crow * cin + i];
        if (tid < kTile * 3) sdc[tid] = 0.0f;
        __syncthreads();

        // phase 1: pair geometry (as K1) and the position adjoint
        for (int p = tid; p < pairs; p += kThreads) {
          const int q = p / kTile, j = p % kTile;
          bool within = false;
          float gox = 0.0f, goy = 0.0f, goz = 0.0f;
          if (q < nq && j < nc) {
            const float ox = __fmul_rn(__fsub_rn(cp[3 * j], qp[3 * q]), inv_r);
            const float oy =
                __fmul_rn(__fsub_rn(cp[3 * j + 1], qp[3 * q + 1]), inv_r);
            const float oz =
                __fmul_rn(__fsub_rn(cp[3 * j + 2], qp[3 * q + 2]), inv_r);
            const float d2n = __fadd_rn(
                __fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)),
                __fmul_rn(oz, oz));
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
              const int tap = (iz * ky + iy) * kx + ix;
              pt[p] = tap;
              const float wz[2] = {(1.0f - fz) * win, fz * win};
              const float wy[2] = {1.0f - fy, fy};
              const float wx[2] = {1.0f - fx, fx};
#pragma unroll
              for (int c = 0; c < 8; ++c)
                pw[c * pairs + p] = wz[c >> 2] * wy[(c >> 1) & 1] * wx[c & 1];
              if (need_pos) {
                float g8[8];
                const float* fr = fe + j * cs;
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                  const float* dr = dacc + q * dlen + (tap + coff[c]) * cs;
                  float v = 0.0f;
                  for (int ch = 0; ch < cin; ++ch) v += dr[ch] * fr[ch];
                  g8[c] = v;
                }
                pair_vjp(ox, oy, oz, d2n, kz, ky, kx, g8, gox, goy, goz);
                gox *= inv_r;
                goy *= inv_r;
                goz *= inv_r;
                atomicAdd(&sdc[3 * j], gox);
                atomicAdd(&sdc[3 * j + 1], goy);
                atomicAdd(&sdc[3 * j + 2], goz);
              }
            }
          }
          const unsigned hits = __ballot_sync(kFull, within);
          if (need_pos) {  // one warp is one query: sum its dq over lanes
#pragma unroll
            for (int m = 16; m > 0; m >>= 1) {
              gox += __shfl_xor_sync(kFull, gox, m);
              goy += __shfl_xor_sync(kFull, goy, m);
              goz += __shfl_xor_sync(kFull, goz, m);
            }
          }
          if (lane == 0) {
            qmask[q] = hits;
            if (need_pos) {
              sdq[3 * q] -= gox;
              sdq[3 * q + 1] -= goy;
              sdq[3 * q + 2] -= goz;
            }
          }
        }
        __syncthreads();

        // phase 2: thread (q, c) owns accumulator column acc[q, :, c]
        if (need_acc) {
          for (int item = tid; item < qb * cin; item += kThreads) {
            const int q = item / cin, c = item % cin;
            float* a = acc + q * tap_len + c;
            for (unsigned m = qmask[q]; m != 0; m &= m - 1) {
              const int p = q * kTile + __ffs(m) - 1;
              const float f = fe[(p - q * kTile) * cs + c];
              float* at = a + pt[p] * cin;
#pragma unroll
              for (int k = 0; k < 8; ++k) at[coff[k] * cin] += pw[k * pairs + p] * f;
            }
          }
        }
        // phase 3: thread (candidate, c) sums dfeats over the block's queries
        if (need_f) {
          for (int item = tid; item < nc * cin; item += kThreads) {
            const int j = item / cin, c = item % cin;
            float v = 0.0f;
            bool any = false;
            for (int q = 0; q < nq; ++q) {
              if (!((qmask[q] >> j) & 1u)) continue;
              any = true;
              const int p = q * kTile + j;
              const float* dr = dacc + q * dlen + pt[p] * cs + c;
#pragma unroll
              for (int k = 0; k < 8; ++k) v += pw[k * pairs + p] * dr[coff[k] * cs];
            }
            if (any) atomicAdd(&df[(crow + j) * cin + c], v);
          }
        }
        if (need_pos && tid < nc * 3) {
          const float v = sdc[tid];
          if (v != 0.0f) atomicAdd(&dc[crow * 3 + tid], v);
        }
        __syncthreads();
      }
    }

    if (need_acc)
      for (int i = tid; i < nq * tap_len; i += kThreads)
        acc_out[row0 * tap_len + i] = acc[i];
    if (need_pos && tid < nq * 3) dq[row0 * 3 + tid] = sdq[tid];
    __syncthreads();
  }
}

// dW partials: part[s, k, o] = sum over rows n of split s of A[n, k] ct[n, o]
constexpr int kDwK = 64, kDwO = 32, kDwN = 32;

__global__ void __launch_bounds__(256) dw_partial_kernel(
    const float* __restrict__ a, const float* __restrict__ ct,
    float* __restrict__ part, int n, int klen, int cout, int rows_per_split) {
  __shared__ __align__(16) float sa[kDwN][kDwK];
  __shared__ float sb[kDwN][kDwO];
  const int k0 = blockIdx.x * kDwK, o0 = blockIdx.y * kDwO;
  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(n, n_begin + rows_per_split);
  const int tid = threadIdx.x, tk = tid % 16, to = tid / 16;
  float r[4][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int nb = n_begin; nb < n_end; nb += kDwN) {
    for (int i = tid; i < kDwN * kDwK; i += 256) {
      const int rr = i / kDwK, kk = i % kDwK;
      const int row = nb + rr, k = k0 + kk;
      sa[rr][kk] = (row < n_end && k < klen)
                       ? a[static_cast<long>(row) * klen + k] : 0.0f;
    }
    for (int i = tid; i < kDwN * kDwO; i += 256) {
      const int rr = i / kDwO, oo = i % kDwO;
      const int row = nb + rr, o = o0 + oo;
      sb[rr][oo] = (row < n_end && o < cout)
                       ? ct[static_cast<long>(row) * cout + o] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kDwN; ++rr) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[rr][tk * 4]);
      const float b0 = sb[rr][to * 2], b1 = sb[rr][to * 2 + 1];
      r[0][0] += av.x * b0;
      r[0][1] += av.x * b1;
      r[1][0] += av.y * b0;
      r[1][1] += av.y * b1;
      r[2][0] += av.z * b0;
      r[2][1] += av.z * b1;
      r[3][0] += av.w * b0;
      r[3][1] += av.w * b1;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + tk * 4 + i, o = o0 + to * 2 + j;
      if (k < klen && o < cout)
        part[(static_cast<long>(blockIdx.z) * klen + k) * cout + o] = r[i][j];
    }
  }
}

// dW = the splits summed in order
__global__ void dw_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ dw, int n_split, int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float v = 0.0f;
  for (int s = 0; s < n_split; ++s) v += part[static_cast<long>(s) * len + i];
  dw[i] = v;
}

// shared memory a K2 block may take (the card allows 227 KB per block)
constexpr size_t kBwdSmemBudget = 220 * 1024;

// dynamic shared memory of one K2 block: the layout at the top of
// fused_cconv_bwd_kernel
size_t bwd_smem_bytes(int qb, int n_taps, int cin, int cout, bool need_acc,
                      bool need_dacc) {
  const size_t q = qb, cs = cin | 1;
  return sizeof(float) *
         (q * n_taps * cin * need_acc + q * n_taps * cs * need_dacc +
          kTile * cs + kTile * 3 + 8 * q * kTile + q * kTile + q * 3 +
          q * cout + q + q * 3 + kTile * 3);
}

template <int QB>
int launch_bwd(const int* gcol, const int* gzlo, const int* gzhi,
               const int* gstart, const int* pstarts, const float* qpos,
               const float* cpos, const float* feats, const float* wt,
               const float* ct, float* acc, float* dq, float* dc, float* df,
               int n_groups, int group_size, int d0, int d1, int d2, int kz,
               int ky, int kx, int cin, int cout, float inv_r,
               int exclude_self, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(QB, kz * ky * kx, cin, cout,
                                     acc != nullptr,
                                     dq != nullptr || df != nullptr);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_cconv_bwd_kernel<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_groups, (group_size + QB - 1) / QB);
  fused_cconv_bwd_kernel<QB><<<grid, kThreads, smem, stream>>>(
      gcol, gzlo, gzhi, gstart, pstarts, qpos, cpos, feats, wt, ct, acc, dq,
      dc, df, d0, d1, d2, kz, ky, kx, cin, cout, inv_r, exclude_self);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qb: queries per block, one of 1, 2, 4, 8, 16 (see _queries_per_block in
// ops/fused_cconv.py).
extern "C" int nf_fused_cconv_fwd(
    const int* gcol, const int* gzlo, const int* gzhi, const int* gstart,
    const int* pstarts, const float* qpos, const float* cpos,
    const float* feats, const float* w, float* out, float* cnt, int n_groups,
    int group_size, int qb, int d0, int d1, int d2, int kz, int ky, int kx,
    int cin, int cout, float inv_r, int exclude_self, void* stream) {
  if (cout < 1 || cout > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_LAUNCH(Q)                                                        \
  case Q:                                                                   \
    return launch<Q>(gcol, gzlo, gzhi, gstart, pstarts, qpos, cpos, feats, \
                     w, out, cnt, n_groups, group_size, d0, d1, d2, kz, ky, \
                     kx, cin, cout, inv_r, exclude_self, st);
  switch (qb) {
    NF_LAUNCH(1)
    NF_LAUNCH(2)
    NF_LAUNCH(4)
    NF_LAUNCH(8)
    NF_LAUNCH(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NF_LAUNCH
}

// K2. Null outputs are not computed: acc/part/dw (the filter gradient and
// its scratch: acc (n_q, 64 * cin), part (n_split, 64 * cin, cout)), dq/dc
// (positions; both or neither, each zeroed by the caller), df (features,
// zeroed by the caller). wt is W^T, (cout, 64 * cin). Queries per block: the
// largest of 16, 8, 4, 2, 1 whose block fits the shared-memory budget.
extern "C" int nf_fused_cconv_bwd(
    const int* gcol, const int* gzlo, const int* gzhi, const int* gstart,
    const int* pstarts, const float* qpos, const float* cpos,
    const float* feats, const float* wt, const float* ct, float* acc,
    float* part, float* dw, float* dq, float* dc, float* df, int n_groups,
    int group_size, int n_q, int n_split, int rows_per_split, int d0, int d1,
    int d2, int kz, int ky, int kx, int cin, int cout, float inv_r,
    int exclude_self, void* stream) {
  if (cout < 1 || (dq == nullptr) != (dc == nullptr) ||
      (dw != nullptr) != (acc != nullptr) ||
      (dw != nullptr && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int qb = 16;
  while (qb > 1 && bwd_smem_bytes(qb, kz * ky * kx, cin, cout, acc != nullptr,
                                  dq != nullptr || df != nullptr) >
                       kBwdSmemBudget)
    qb /= 2;
  int err = 0;
#define NF_LAUNCH_BWD(Q)                                                     \
  case Q:                                                                    \
    err = launch_bwd<Q>(gcol, gzlo, gzhi, gstart, pstarts, qpos, cpos,       \
                        feats, wt, ct, acc, dq, dc, df, n_groups,            \
                        group_size, d0, d1, d2, kz, ky, kx, cin, cout,       \
                        inv_r, exclude_self, st);                            \
    break;
  switch (qb) {
    NF_LAUNCH_BWD(1)
    NF_LAUNCH_BWD(2)
    NF_LAUNCH_BWD(4)
    NF_LAUNCH_BWD(8)
    NF_LAUNCH_BWD(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NF_LAUNCH_BWD
  if (err != 0 || dw == nullptr) return err;
  const int klen = kz * ky * kx * cin;
  const dim3 grid((klen + kDwK - 1) / kDwK, (cout + kDwO - 1) / kDwO,
                  n_split);
  dw_partial_kernel<<<grid, 256, 0, st>>>(acc, ct, part, n_q, klen, cout,
                                          rows_per_split);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int len = klen * cout;
  dw_sum_kernel<<<(len + 255) / 256, 256, 0, st>>>(part, dw, n_split, len);
  return static_cast<int>(cudaGetLastError());
}
