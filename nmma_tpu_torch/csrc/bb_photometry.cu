// K5: the banded blackbody photometry on Hopper (sm_90a), IEEE f32.
//
// From a photosphere to band AB magnitudes [B, F, T] in one launch. The
// plain chain is `_me2017_photometry_plain` (nmma_tpu_torch/models/
// kilonova.py: ~100 eager kernels for the temperature and its fill over the
// grid) and `blackbody_ab_mag_banded_plain` (nmma_tpu_torch/ops/
// photometry.py: ~46 eager kernels, each writing a [B, F, K, T] tensor); the
// JAX package leaves both to XLA's fusion and has no Pallas kernel here.
// Per row b:
//
//   prologue (Me2017's entry, given L / 1e40 and R [B, T] and the grid t [T]):
//     q     = |L| 1e20 / (4 pi sigma) / (R' 1e-10)^2,  R' = R if R > 0 else 1
//     T_obs = q^(1/4) where R > 0 and q > 0, else undefined
//     T_obs filled over the grid as masked_interp_linear_sorted(t, t, T_obs)
//           (ops/interp.py): interior gaps from the nearest valid neighbours,
//           beyond the valid range the line through the two edge samples,
//           +inf on a row with fewer than 2 valid samples
//     1/T   = 1 / T_obs where T_obs is finite and > 0, else +inf
//   (other callers pass 1/T and R [B, T] themselves: no prologue)
//
//   body, per (filter f, time t), over the K quadrature nodes nu [B, F, K]:
//     x     = h nu (1/T) / k_B;  a node is valid if x is finite, x > 0, R > 0
//     ln F  = ln(2h/c^2) + 3 ln nu - log_expm1(x) + 2 ln R' - ln D^2
//     m     = -2.5/ln10 logsumexp_k(ln F_k + ln w_k) + ZP, or +inf unless
//             every node is valid
//
// log_expm1 takes the plain chain's two branches, ln(expm1 x) below x = 20
// and x + log1p(-e^-min(x, 80)) from 20 on, and the log-sum-exp its order:
// the maximum, the sum of exp(v - max), the log plus the maximum. Every
// expression follows the plain chain operation by operation with PyTorch's
// rounding on the card (torch 2.11): a Python float is rounded to f32
// before it meets a tensor, `tensor / float` is a product with the
// reciprocal taken in double and rounded to f32, `x ** 2` a product,
// `x ** 0.25` powf, `1.0 / x` a correctly rounded reciprocal. The file is built with
// -fmad=false (nmma_tpu_torch/_kernels.py), so no product and sum are fused
// where the eager chain rounds twice, and with the accurate expm1f, log1pf,
// logf, expf and powf (no --use_fast_math). The one difference left is the
// order of the sum over the nodes (sequential here, a reduction tree in
// torch.sum).
//
// Design: one block per row. The prologue (a template switch) puts the
// row's grid, T_obs, 1/T and 2 ln R' in shared memory; each thread fills its
// times by scanning left and right for the nearest valid samples, which is
// cheap at T = 150 since most samples are valid. Without the prologue 1/T
// and 2 ln R' are read and staged the same way. A time whose R <= 0 carries
// 1/T = NaN in shared memory, which fails every node's test as R <= 0 does.
// The row's h nu, ln(2h/c^2) + 3 ln nu and ln w (F K values each) are staged
// too. Then threads run over (f, t), t fastest, so the [B, F, T] stores of a
// warp coalesce; each walks the K nodes with their log fluxes in registers
// and writes the magnitude. Nothing but the output reaches device memory.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_K = 16;                   // nodes held in registers
constexpr int MAX_T = 1024;
constexpr int MAX_FK = 1024;

// the Python floats of the plain chain, rounded to f32 as PyTorch rounds a
// scalar operand; a `/ float` becomes the product with f32(1 / float)
constexpr double PI = 3.141592653589793;
constexpr double H_CGS = 6.62607015e-34 * 1e7;
constexpr double KB_CGS = 1.380649e-23 * 1e7;
constexpr double SIGMA_SB = 5.670374419e-8 * 1e3;
constexpr float K_H = static_cast<float>(H_CGS);
constexpr float K_INV_KB = static_cast<float>(1.0 / KB_CGS);
constexpr float K_L_SCALE = static_cast<float>(1e40 * 1e-20);
constexpr float K_INV_4PI_SIGMA = static_cast<float>(1.0 / (4.0 * PI * SIGMA_SB));
constexpr float K_R_SCALE = static_cast<float>(1e-10);
constexpr float K_X_MIN = static_cast<float>(1e-30);
constexpr float K_W_MIN = static_cast<float>(1e-30);
// ln(2) + ln(h) - 2 ln(c) and -2.5 / ln(10), as Python evaluates them
// (ops/photometry.py _LOG_BB_FACTOR, ab_mag_from_log_flux)
constexpr float K_LOG_BB = static_cast<float>(-107.83318078444293);
constexpr float K_MAG = static_cast<float>(-1.0857362047581294);
constexpr float K_AB_ZP = static_cast<float>(-48.6);

// log(e^x - 1) for x > 0 as ops/photometry.py log_expm1 computes it: the
// branch that its torch.where keeps
__device__ __forceinline__ float log_expm1(float x) {
  x = fmaxf(x, K_X_MIN);
  if (x < 20.0f) return logf(expm1f(x));
  return x + log1pf(-expf(-fminf(x, 80.0f)));
}

// the first valid sample at or after j (n where there is none), the last
// at or before j (-1 where there is none)
__device__ __forceinline__ int next_valid(const float* y, int j, int n) {
  while (j < n && !isfinite(y[j])) ++j;
  return j;
}

__device__ __forceinline__ int prev_valid(const float* y, int j) {
  while (j >= 0 && !isfinite(y[j])) --j;
  return j;
}

// masked_interp_linear_sorted(x, x, y) at x[t] on an ascending grid x [n],
// with y's non-finite samples ignored (ops/interp.py), in its order of
// operations
__device__ float fill_at(const float* x, const float* y, int t, int n) {
  const float xq = x[t];
  // (xq >= x).sum() - 1: on an ascending grid the last index with x <= xq
  int pos = t;
  while (pos + 1 < n && x[pos + 1] <= xq) ++pos;
  const int first = next_valid(y, 0, n);
  if (first >= n || next_valid(y, first + 1, n) >= n) return CUDART_INF_F;
  const int l_idx = prev_valid(y, pos);
  const int r_idx = next_valid(y, min(pos + 1, n - 1), n);
  const int i0 = first;
  const int i1 = min(next_valid(y, min(i0 + 1, n - 1), n), n - 1);
  const int i_last = max(prev_valid(y, n - 1), 0);
  const int i_m = max(prev_valid(y, max(i_last - 1, 0)), 0);
  // the plain chain's two where()s: an invalid tail cell, then an invalid
  // head cell, then the interpolation
  float res;
  if (r_idx > n - 1) {
    res = y[i_last];
  } else if (l_idx < 0) {
    res = y[i0];
  } else {
    const float x_l = x[l_idx], x_r = x[r_idx];
    const float y_l = y[l_idx], y_r = y[r_idx];
    const float span = x_r > x_l ? x_r - x_l : 1.0f;
    const float w = fminf(fmaxf((xq - x_l) / span, 0.0f), 1.0f);
    res = y_l + w * (y_r - y_l);
  }
  if (xq < x[i0]) {
    const float slope = (y[i1] - y[i0]) / (x[i1] != x[i0] ? x[i1] - x[i0] : 1.0f);
    res = y[i0] + slope * (xq - x[i0]);
  }
  if (xq > x[i_last]) {
    const float slope = (y[i_last] - y[i_m])
        / (x[i_last] != x[i_m] ? x[i_last] - x[i_m] : 1.0f);
    res = y[i_last] + slope * (xq - x[i_last]);
  }
  return res;
}

// first: L / 1e40 [B, T] with the prologue, else 1/T [B, T]; radius [B, T];
// t_days [T] (prologue only); nodes [B, F, K]; weights [F, K]; mags [B, F, T]
template <bool PROLOGUE>
__global__ void __launch_bounds__(THREADS)
bb_photometry_kernel(const float* __restrict__ first,
                     const float* __restrict__ radius,
                     const float* __restrict__ t_days,
                     const float* __restrict__ nodes,
                     const float* __restrict__ weights,
                     float* __restrict__ mags, int F, int K, int T,
                     float log_dist2) {
  extern __shared__ float smem[];
  const int FK = F * K;
  float* s_inv_t = smem;                 // [T] 1/T, NaN where R <= 0
  float* s_log_r2 = s_inv_t + T;         // [T] 2 ln R'
  float* s_hnu = s_log_r2 + T;           // [FK] h nu
  float* s_lnu3 = s_hnu + FK;            // [FK] ln(2h/c^2) + 3 ln nu
  float* s_logw = s_lnu3 + FK;           // [FK] ln max(w, 1e-30)
  const long long b = blockIdx.x;
  const float* row_first = first + b * T;
  const float* row_r = radius + b * T;
  const float* row_nu = nodes + b * FK;

  for (int i = threadIdx.x; i < FK; i += THREADS) {
    const float nu = row_nu[i];
    s_hnu[i] = K_H * nu;
    s_lnu3[i] = K_LOG_BB + 3.0f * logf(nu);
    s_logw[i] = logf(fmaxf(weights[i], K_W_MIN));
  }
  if (PROLOGUE) {
    float* s_x = s_logw + FK;            // [T] the grid
    float* s_y = s_x + T;                // [T] T_obs, NaN where undefined
    for (int t = threadIdx.x; t < T; t += THREADS) {
      const float r = row_r[t];
      const bool r_ok = r > 0.0f;
      const float r_safe = r_ok ? r : 1.0f;
      const float scaled = r_safe * K_R_SCALE;
      const float q = (fabsf(row_first[t]) * K_L_SCALE) * K_INV_4PI_SIGMA
          / (scaled * scaled);
      s_y[t] = (r_ok && q > 0.0f) ? powf(q, 0.25f) : CUDART_NAN_F;
      s_x[t] = t_days[t];
      s_log_r2[t] = 2.0f * logf(r_safe);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += THREADS) {
      const float t_obs = fill_at(s_x, s_y, t, T);
      const float inv_t = (isfinite(t_obs) && t_obs > 0.0f) ? 1.0f / t_obs
                                                            : CUDART_INF_F;
      s_inv_t[t] = row_r[t] > 0.0f ? inv_t : CUDART_NAN_F;
    }
  } else {
    for (int t = threadIdx.x; t < T; t += THREADS) {
      const float r = row_r[t];
      const bool r_ok = r > 0.0f;
      s_inv_t[t] = r_ok ? row_first[t] : CUDART_NAN_F;
      s_log_r2[t] = 2.0f * logf(r_ok ? r : 1.0f);
    }
  }
  __syncthreads();

  float* row_out = mags + b * F * T;
  for (int o = threadIdx.x; o < F * T; o += THREADS) {
    const int f = o / T, t = o - f * T;
    const float inv_t = s_inv_t[t];
    const float log_r2 = s_log_r2[t];
    const int base = f * K;
    float v[MAX_K];
    float vmax = -CUDART_INF_F;
    bool good = true;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k < K && good) {
        const float x = (s_hnu[base + k] * inv_t) * K_INV_KB;
        good = isfinite(x) && x > 0.0f;
        if (good) {
          const float log_flux = ((s_lnu3[base + k] - log_expm1(x)) + log_r2)
              - log_dist2;
          v[k] = log_flux + s_logw[base + k];
          vmax = fmaxf(vmax, v[k]);
        }
      }
    }
    float mag = CUDART_INF_F;
    if (good) {
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {
        if (k < K) sum = sum + expf(v[k] - vmax);
      }
      mag = K_MAG * (logf(sum) + vmax) + K_AB_ZP;
    }
    row_out[o] = mag;
  }
}

size_t smem_bytes(int F, int K, int T, bool prologue) {
  return sizeof(float) * (static_cast<size_t>(prologue ? 4 : 2) * T
                          + 3 * static_cast<size_t>(F) * K);
}

}  // namespace

// The shapes K5 is built for: 1 <= K <= 16 nodes a filter, F K <= 1024,
// 1 <= T <= 1024, B < 2^31 rows.
extern "C" int nmma_bb_photometry_supported(long long B, int F, int K, int T) {
  return B >= 0 && B <= 0x7fffffffLL && F >= 1 && K >= 1 && K <= MAX_K &&
         static_cast<long long>(F) * K <= MAX_FK && T >= 1 && T <= MAX_T;
}

// Plain C entry point for ctypes. Device pointers to contiguous f32 arrays
// on CUDA device `device`: first [B, T] (L / 1e40 with the prologue, else
// 1/T), radius [B, T] (cm), t_days [T] (the grid, ascending; read only with
// the prologue), nodes [B, F, K] (Hz), weights [F, K], mags [B, F, T]; the
// launch goes to `stream`. log_dist2 is ln D^2 of the absolute-magnitude
// distance. Shapes nmma_bb_photometry_supported refuses return
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int nmma_bb_photometry(const void* first, const void* radius,
                                  const void* t_days, const void* nodes,
                                  const void* weights, void* mags, long long B,
                                  int F, int K, int T, int prologue,
                                  float log_dist2, int device, void* stream) {
  if (!nmma_bb_photometry_supported(B, F, K, T))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(F, K, T, prologue != 0);
  const dim3 grid(static_cast<unsigned>(B));
  if (prologue) {
    bb_photometry_kernel<true><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(first), static_cast<const float*>(radius),
        static_cast<const float*>(t_days), static_cast<const float*>(nodes),
        static_cast<const float*>(weights), static_cast<float*>(mags), F, K, T,
        log_dist2);
  } else {
    bb_photometry_kernel<false><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(first), static_cast<const float*>(radius),
        nullptr, static_cast<const float*>(nodes),
        static_cast<const float*>(weights), static_cast<float*>(mags), F, K, T,
        log_dist2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nmma_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
