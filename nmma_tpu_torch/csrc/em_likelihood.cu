// K6: the EM likelihood on Hopper (sm_90a), IEEE f32.
//
// From the source's magnitudes to logL [B] in one launch. The plain chain is
// `DetectorLightCurveModel.observe` (nmma_tpu_torch/models/base.py: the band
// extinction, the distance modulus and redshift correction, the "fewer than
// 2 finite samples" rule and the observer times) followed by
// `EMLikelihood.expected_mags` and the terms of `EMLikelihood.log_likelihood`
// (nmma_tpu_torch/likelihood/em.py): about 245 eager kernels a call, several
// of them writing [B, F, K, T] tensors. The JAX package leaves the chain to
// XLA's fusion and has no Pallas kernel here. Per row b:
//
//   prologue:
//     x[t]    = t_grid[t] (1 + z) + timeshift            observer times [T]
//     ext[f]  = -2.5 log10(max(sum_k w[f,k] fac(nu[f,k]), 1e-30))
//               fac = 10^(-0.4 A(nu)/A_V A_V): Pei (1992) SMC at the host
//               frame nu (1 + z), or the CCM89 R_V = 3.1 foreground (LAW)
//     y[f,t]  = ((m[f,t] + ext[f]) + dm) + rc,  rc = -2.5 log10(1 + z)
//               (no dm for a source that samples an apparent amplitude)
//     per source row f: the count of finite y, the first and last finite t;
//     a row with fewer than 2 is all-inf (no epoch can read it)
//
//   body, per observation (f_obs, n) that is valid, at the epoch xq:
//     j       = searchsorted(x, xq, right) - 1 clamped to [0, T-2]
//     w_j     = hat weights of nodes j and j+1, one-sided at the grid's ends
//     est_k   = w_j y'[r_k, j] + w_j+1 y'[r_k, j+1]  (y' = y, or 0 where not
//               finite) where x[first] <= xq <= x[last] of row r_k, else inf
//     est     = sum_k (est_k w_k where w_k > 0, else 0)  composite filters
//     det.:   log N(m; est, sqrt(s^2 + s_sys^2)) - log Phi((lim - est) / .)
//     limit:  log_ndtr(-(m - est) / max(s_sys, 1e-10))
//     (a non-finite est enters both as 1e30)
//   logL = sum of the detections' terms + sum of the limits' terms; -1e30
//   where a used band has no finite est, where logL is NaN, and as its floor.
//
// log_ndtr takes torch.special.log_ndtr's two branches (log(erfcx(-t) / 2) -
// t^2 below x = -1, log1p(-erfc(t) / 2) from -1 on, t = x / sqrt 2), with
// CUDA's erfcxf and erfcf. Every expression follows the plain chain
// operation by operation with PyTorch's rounding on the card: a Python float
// is rounded to f32 before it meets a tensor, `tensor / float` is a product
// with f32(1 / float) and `float / tensor` a reciprocal times the float,
// `x ** 2` and `x ** 3` are products and `x ** -2` is 1 / x^2 taken in
// double, other powers are powf; minima and clamps propagate NaN. The file is
// built with -fmad=false (nmma_tpu_torch/_kernels.py), so no product and sum
// are fused where the eager chain rounds twice, and with the accurate logf,
// log10f, powf, erfcf and erfcxf (no --use_fast_math). What is left to differ
// is the order of the sums: over the quadrature nodes, over the
// observations (a block reduction here) and, in erfcx, CUDA's erfcxf
// against PyTorch's own.
//
// Design: one block per row. The prologue puts the row's observer times and
// the weighted extinction factors of every (filter, node) in shared memory;
// a warp per source row then takes the band extinction (its first lane, the
// nodes in order) and reads the row's magnitudes once, coalesced, for the
// count and the first and last finite sample, which go to shared memory
// with x[first] and x[last]. The body runs a thread per observation: a
// binary search of the shared x, the two hat weights, and the two
// neighbours of each helper row read back from the magnitudes (the row was
// just read, so L1 and L2 serve them). Each thread keeps its sums in
// registers; warps reduce them by shuffles and the first thread of the block
// finishes the row. Nothing but logL reaches device memory.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_T = 4096;
constexpr int MAX_FK = 2048;
constexpr int MAX_F = 512;
constexpr int MAX_FO = 512;
constexpr int MAX_KH = 16;

enum Law { P92_SMC_HOST = 0, CCM89_MW = 1 };

// the reciprocal of a Python float, taken in double and rounded to f32, as
// PyTorch 2.11's `tensor / float` takes it on the card
constexpr float inv(double c) { return static_cast<float>(1.0 / c); }

constexpr double C_CGS = 299792458.0 * 100.0;
constexpr float K_C = static_cast<float>(C_CGS);
constexpr float K_1E4 = static_cast<float>(1e4);
constexpr float K_1EM4 = static_cast<float>(1e-4);
constexpr float K_EFF_MIN = static_cast<float>(1e-30);
constexpr float K_M2_5 = static_cast<float>(-2.5);
constexpr float K_M0_4 = static_cast<float>(-0.4);

// Pei (1992) SMC: the band of the dust_extinction P92 validity range, and
// per term (amplitude x A_B/A_V, 1 / lambda_i, b_i, n_i) (ops/extinction.py)
constexpr double P92_ABAV = 1.3219866307098898;
constexpr float K_NU_LO = static_cast<float>(1e-3 * 1e4 * C_CGS);
constexpr float K_NU_HI = static_cast<float>(2e16 < 1e3 * 1e4 * C_CGS
                                             ? 2e16 : 1e3 * 1e4 * C_CGS);
constexpr float K_RV_SMC = static_cast<float>(2.93);
__constant__ float P92_A[6] = {
    static_cast<float>(185.0 * P92_ABAV), static_cast<float>(27.0 * P92_ABAV),
    static_cast<float>(0.005 * P92_ABAV), static_cast<float>(0.010 * P92_ABAV),
    static_cast<float>(0.012 * P92_ABAV), static_cast<float>(0.030 * P92_ABAV)};
__constant__ float P92_INV_L[6] = {inv(0.042), inv(0.08), inv(0.22),
                                   inv(9.7),   inv(18.0), inv(25.0)};
__constant__ float P92_B[6] = {90.0f, 5.5f, -1.95f, -1.95f, -1.80f, 0.0f};
__constant__ int P92_N[6] = {2, 4, 2, 2, 2, 2};

// CCM89 with R_V = 3.1
constexpr float K_RV_MW = static_cast<float>(3.1);
constexpr float K_INV_RV_MW = inv(3.1);

constexpr float K_HALF_LOG_2PI = static_cast<float>(0.91893853320467267);
constexpr float K_FRAC_SQRT_2 = 0.707106781186547524400844362104849039f;
constexpr float K_SIGMA_MIN = static_cast<float>(1e-10);
constexpr float K_BIG = static_cast<float>(1e30);
constexpr float K_NEG = static_cast<float>(-1e30);

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fminf(a, b);
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// x ** -2 as PyTorch takes it on the card: 1.0 / (x * x) in double
__device__ __forceinline__ float pow_m2(float x) {
  return static_cast<float>(1.0 / static_cast<double>(x * x));
}

// torch.special.log_ndtr
__device__ __forceinline__ float log_ndtr(float x) {
  const float t = x * K_FRAC_SQRT_2;
  if (x < -1.0f) return logf(erfcxf(-t) / 2.0f) - t * t;
  return log1pf(-erfcf(t) / 2.0f);
}

// 10^(-0.4 A_lambda) of the Pei (1992) SMC curve at observer-frame nu
// (extinction_factor_p92_smc)
__device__ float factor_p92(float nu, float one_pz, float ebv) {
  const float nu_host = nu * one_pz;
  const bool in_range = nu_host >= K_NU_LO && nu_host <= K_NU_HI;
  const float lam = ((1.0f / (in_range ? nu_host : K_NU_LO)) * K_C) * K_1E4;
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float ratio = lam * P92_INV_L[i];
    const float up = P92_N[i] == 2 ? ratio * ratio : powf(ratio, 4.0f);
    const float dn = P92_N[i] == 2 ? pow_m2(ratio) : powf(ratio, -4.0f);
    const float term = (1.0f / ((up + dn) + P92_B[i])) * P92_A[i];
    total = i == 0 ? term : total + term;
  }
  const float fac = powf(10.0f, (total * K_M0_4) * (ebv * K_RV_SMC));
  return in_range ? fac : 1.0f;
}

// 10^(-0.4 A_lambda) of the CCM89 R_V = 3.1 curve at nu (extinction_factor_mw
// and _ccm89_a_b)
__device__ float factor_mw(float nu, float ebv) {
  const float x0 = (1.0f / ((1.0f / nu) * K_C)) * K_1EM4;
  const bool in_range = x0 >= 0.3f && x0 <= 8.0f;
  const float x = in_range ? x0 : 1.0f;
  const float p161 = powf(fabsf(x), 1.61f);
  const float a_ir = p161 * 0.574f;
  const float b_ir = p161 * -0.527f;
  const float y = x - 1.82f;
  const float y2 = y * y, y3 = y * y * y;
  const float y4 = powf(y, 4.0f), y5 = powf(y, 5.0f), y6 = powf(y, 6.0f),
              y7 = powf(y, 7.0f);
  float a_opt = y * 0.17699f + 1.0f;
  a_opt = a_opt - y2 * 0.50447f;
  a_opt = a_opt - y3 * 0.02427f;
  a_opt = a_opt + y4 * 0.72085f;
  a_opt = a_opt + y5 * 0.01979f;
  a_opt = a_opt - y6 * 0.77530f;
  a_opt = a_opt + y7 * 0.32999f;
  float b_opt = y * 1.41338f + y2 * 2.28305f;
  b_opt = b_opt + y3 * 1.07233f;
  b_opt = b_opt - y4 * 5.38434f;
  b_opt = b_opt - y5 * 0.62251f;
  b_opt = b_opt + y6 * 5.30260f;
  b_opt = b_opt - y7 * 2.09002f;
  const float u = x - 5.9f;
  const float u2 = u * u, u3 = u * u * u;
  const bool far_uv = x >= 5.9f;
  const float fa = far_uv ? u2 * -0.04473f - u3 * 0.009779f : 0.0f;
  const float fb = far_uv ? u2 * 0.2130f + u3 * 0.1207f : 0.0f;
  const float da = x - 4.67f, db = x - 4.62f;
  const float a_uv = ((1.752f - x * 0.316f)
                      - (1.0f / (da * da + 0.341f)) * 0.104f) + fa;
  const float b_uv = ((x * 1.825f + -3.090f)
                      + (1.0f / (db * db + 0.263f)) * 1.206f) + fb;
  const float a = x < 1.1f ? a_ir : (x < 3.3f ? a_opt : a_uv);
  const float b = x < 1.1f ? b_ir : (x < 3.3f ? b_opt : b_uv);
  const float fac = powf(10.0f, ((a + b * K_INV_RV_MW) * K_M0_4)
                                    * (ebv * K_RV_MW));
  return in_range ? fac : 1.0f;
}

// the hat weight of grid node t at the query xq (EMLikelihood.expected_mags)
__device__ __forceinline__ float hat(const float* x, int t, int T, float xq) {
  const float xt = x[t];
  const float xl = x[t > 0 ? t - 1 : 0];
  const float xr = x[t < T - 1 ? t + 1 : T - 1];
  float up = (xq - xl) / clamp_min(xt - xl, 1e-30f);
  float dn = (xr - xq) / clamp_min(xr - xt, 1e-30f);
  if (t == 0) up = 1.0f;
  if (t == T - 1) dn = 1.0f;
  return clamp01(nan_min(up, dn));
}

struct RowScalars {
  float dm, rc;
  bool has_dm;
};

__device__ __forceinline__ float apparent(float m, float ext,
                                          const RowScalars& r) {
  const float v = m + ext;
  return (r.has_dm ? v + r.dm : v) + r.rc;
}

// mags [B, F, T]; t_grid [T]; z, ts, dm (or null), ebv [B]; nu, nu_w [F, K];
// h_rows (int32), h_w [Fo, Kh]; d_t, d_m, d_s [Fo, N], d_valid (bool)
// [Fo, N]; lim [Fo]; s_sys [B, Fo, N]; logl [B]
template <int LAW>
__global__ void __launch_bounds__(THREADS)
em_likelihood_kernel(const float* __restrict__ mags,
                     const float* __restrict__ t_grid,
                     const float* __restrict__ z,
                     const float* __restrict__ ts,
                     const float* __restrict__ dm,
                     const float* __restrict__ ebv,
                     const float* __restrict__ nu,
                     const float* __restrict__ nu_w,
                     const int* __restrict__ h_rows,
                     const float* __restrict__ h_w,
                     const float* __restrict__ d_t,
                     const float* __restrict__ d_m,
                     const float* __restrict__ d_s,
                     const unsigned char* __restrict__ d_valid,
                     const float* __restrict__ lim,
                     const float* __restrict__ s_sys,
                     float* __restrict__ logl, long long row0, int F, int K,
                     int T, int Fo, int Kh, int N) {
  extern __shared__ float smem[];
  float* s_x = smem;                     // [T] observer times
  float* s_wfac = s_x + T;               // [F K] w fac
  float* s_ext = s_wfac + F * K;         // [F] band extinction
  float* s_xfirst = s_ext + F;           // [F] x at the first finite y
  float* s_xlast = s_xfirst + F;         // [F] x at the last finite y
  int* s_count = reinterpret_cast<int*>(s_xlast + F);   // [F] finite y
  int* s_used = s_count + F;             // [Fo] a valid observation
  int* s_found = s_used + Fo;            // [Fo] a valid one with finite est
  float* s_red = reinterpret_cast<float*>(s_found + Fo);  // [2 WARPS]

  const long long b = row0 + blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float zb = z[b];
  const float one_pz = 1.0f + zb;
  RowScalars rs;
  rs.has_dm = dm != nullptr;
  rs.dm = rs.has_dm ? dm[b] : 0.0f;
  rs.rc = log10f(one_pz) * K_M2_5;
  const float* row_m = mags + b * F * T;

  const float ts_b = ts[b], ebv_b = ebv[b];
  for (int t = threadIdx.x; t < T; t += THREADS)
    s_x[t] = t_grid[t] * one_pz + ts_b;
  for (int i = threadIdx.x; i < F * K; i += THREADS) {
    const float fac = LAW == CCM89_MW ? factor_mw(nu[i], ebv_b)
                                      : factor_p92(nu[i], one_pz, ebv_b);
    s_wfac[i] = nu_w[i] * fac;
  }
  for (int f = threadIdx.x; f < Fo; f += THREADS) {
    s_used[f] = 0;
    s_found[f] = 0;
  }
  __syncthreads();

  // a warp per source row: its extinction, then its finite samples
  for (int f = warp; f < F; f += WARPS) {
    float ext = 0.0f;
    if (lane == 0) {
      float eff = 0.0f;
      for (int k = 0; k < K; ++k)
        eff = k == 0 ? s_wfac[f * K] : eff + s_wfac[f * K + k];
      ext = log10f(eff < K_EFF_MIN ? K_EFF_MIN : eff) * K_M2_5;
    }
    ext = __shfl_sync(0xffffffffu, ext, 0);
    int count = 0, first = T, last = -1;
    for (int t = lane; t < T; t += 32) {
      if (isfinite(apparent(row_m[f * T + t], ext, rs))) {
        ++count;
        first = min(first, t);
        last = t;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_xor_sync(0xffffffffu, count, off);
      first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
      last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    }
    if (lane == 0) {
      // argmax of an all-false row is 0: x[0] and x[T-1], never read
      s_ext[f] = ext;
      s_count[f] = count;
      s_xfirst[f] = s_x[count ? first : 0];
      s_xlast[f] = s_x[count ? last : T - 1];
    }
  }
  __syncthreads();

  float chi = 0.0f, sf = 0.0f;
  const float* row_sys = s_sys + b * Fo * N;
  for (int o = threadIdx.x; o < Fo * N; o += THREADS) {
    if (!d_valid[o]) continue;
    const int fo = o / N;
    s_used[fo] = 1;
    const float xq = d_t[o];
    // searchsorted(x, xq, right=True) - 1, clamped to [0, T - 2]
    int lo = 0, hi = T;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!(s_x[mid] > xq)) lo = mid + 1;
      else hi = mid;
    }
    const int j = min(max(lo - 1, 0), T - 2);
    const float w_lo = hat(s_x, j, T, xq);
    const float w_hi = hat(s_x, j + 1, T, xq);
    float est = 0.0f;
    for (int k = 0; k < Kh; ++k) {
      const float w = h_w[fo * Kh + k];
      float term = 0.0f;
      if (w > 0.0f) {
        const int r = h_rows[fo * Kh + k];
        float e = CUDART_INF_F;
        if (s_count[r] >= 2 && xq >= s_xfirst[r] && xq <= s_xlast[r]) {
          const float y0 = apparent(row_m[r * T + j], s_ext[r], rs);
          const float y1 = apparent(row_m[r * T + j + 1], s_ext[r], rs);
          e = w_lo * (isfinite(y0) ? y0 : 0.0f)
              + w_hi * (isfinite(y1) ? y1 : 0.0f);
        }
        term = e * w;
      }
      est = k == 0 ? term : est + term;
    }
    const bool finite_est = isfinite(est);
    if (finite_est) s_found[fo] = 1;
    const float loc = finite_est ? est : K_BIG;
    const float m = d_m[o], s = d_s[o], s_row = row_sys[o];
    if (isfinite(s)) {
      const float scale = sqrtf(s * s + s_row * s_row);
      const float u = (m - loc) / scale;
      const float log_phi = ((-0.5f * u) * u - K_HALF_LOG_2PI) - logf(scale);
      const float bound = (lim[fo] - loc) / scale;
      const float log_cdf = isinf(bound) && bound > 0.0f ? 0.0f
                                                         : log_ndtr(bound);
      chi += log_phi - log_cdf;
    } else {
      sf += log_ndtr(-(m - loc) / clamp_min(s_row, K_SIGMA_MIN));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    chi += __shfl_down_sync(0xffffffffu, chi, off);
    sf += __shfl_down_sync(0xffffffffu, sf, off);
  }
  if (lane == 0) {
    s_red[warp] = chi;
    s_red[WARPS + warp] = sf;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = s_red[0], l = s_red[WARPS];
    for (int w = 1; w < WARPS; ++w) {
      c = c + s_red[w];
      l = l + s_red[WARPS + w];
    }
    float v = c + l;
    bool ok = true;
    for (int f = 0; f < Fo; ++f) ok = ok && (s_found[f] || !s_used[f]);
    if (!ok) v = K_NEG;
    logl[b] = isnan(v) ? K_NEG : clamp_min(v, K_NEG);
  }
}

size_t smem_bytes(int F, int K, int T, int Fo) {
  return sizeof(float) * (static_cast<size_t>(T) + static_cast<size_t>(F) * K
                          + 4 * static_cast<size_t>(F)
                          + 2 * static_cast<size_t>(Fo) + 2 * WARPS);
}

}  // namespace

// The shapes K6 is built for: 2 <= T <= 4096 grid times, F <= 512 source
// rows of 1 <= K nodes with F K <= 2048, Fo <= 512 observed filters of
// 1 <= Kh <= 16 helper rows, N >= 1 observations a filter with Fo N < 2^24,
// B < 2^31 rows.
extern "C" int nmma_em_likelihood_supported(long long B, int F, int K, int T,
                                            int Fo, int Kh, int N) {
  return B >= 0 && B <= 0x7fffffffLL && T >= 2 && T <= MAX_T && F >= 1 &&
         F <= MAX_F && K >= 1 && static_cast<long long>(F) * K <= MAX_FK &&
         Fo >= 1 && Fo <= MAX_FO && Kh >= 1 && Kh <= MAX_KH && N >= 1 &&
         static_cast<long long>(Fo) * N < (1LL << 24);
}

// Plain C entry point for ctypes. Device pointers to contiguous arrays on
// CUDA device `device`, f32 unless named: mags [B, F, T] (the source's
// magnitudes in the detector's filter order), t_grid [T] (ascending days),
// z, ts, dm, ebv [B] (dm null for a source that samples an apparent
// amplitude), nu, nu_w [F, K] (the detector's quadrature, observer frame),
// h_rows (int32) and h_w [Fo, Kh] (the helper rows of each observed filter
// and their weights, 0 on padding), d_t, d_m, d_s [Fo, N] (epochs in days,
// magnitudes, errors, inf for an upper limit), d_valid [Fo, N] (bool), lim
// [Fo] (detection limits), s_sys [B, Fo, N], logl [B]. Rows row0 to
// row0 + rows - 1 are computed; the launch goes to `stream`. law 0 is the
// Pei (1992) SMC curve at the host frame, 1 the CCM89 foreground. Shapes
// nmma_em_likelihood_supported refuses return cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nmma_em_likelihood(
    const void* mags, const void* t_grid, const void* z, const void* ts,
    const void* dm, const void* ebv, const void* nu, const void* nu_w,
    const void* h_rows, const void* h_w, const void* d_t, const void* d_m,
    const void* d_s, const void* d_valid, const void* lim, const void* s_sys,
    void* logl, long long row0, long long rows, int F, int K, int T, int Fo,
    int Kh, int N, int law, int device, void* stream) {
  if (!nmma_em_likelihood_supported(row0 + rows, F, K, T, Fo, Kh, N) ||
      row0 < 0 || rows < 0 || (law != P92_SMC_HOST && law != CCM89_MW))
    return cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(F, K, T, Fo);
  const dim3 grid(static_cast<unsigned>(rows));
#define NMMA_K6_ARGS                                                          \
  static_cast<const float*>(mags), static_cast<const float*>(t_grid),         \
      static_cast<const float*>(z), static_cast<const float*>(ts),            \
      static_cast<const float*>(dm), static_cast<const float*>(ebv),          \
      static_cast<const float*>(nu), static_cast<const float*>(nu_w),         \
      static_cast<const int*>(h_rows), static_cast<const float*>(h_w),        \
      static_cast<const float*>(d_t), static_cast<const float*>(d_m),         \
      static_cast<const float*>(d_s),                                         \
      static_cast<const unsigned char*>(d_valid),                             \
      static_cast<const float*>(lim), static_cast<const float*>(s_sys),       \
      static_cast<float*>(logl), row0, F, K, T, Fo, Kh, N
  if (law == CCM89_MW) {
    em_likelihood_kernel<CCM89_MW><<<grid, THREADS, smem, st>>>(NMMA_K6_ARGS);
  } else {
    em_likelihood_kernel<P92_SMC_HOST><<<grid, THREADS, smem, st>>>(
        NMMA_K6_ARGS);
  }
#undef NMMA_K6_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nmma_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
