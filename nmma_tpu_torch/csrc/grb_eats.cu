// K3: the GRB equal-arrival-time-surface (EATS) stage on Hopper (sm_90a),
// IEEE f32.
//
// Replaces the Pallas TPU kernel `_eats_kernel` (nmma_tpu/ops/pallas_grb.py:47,
// called through `eats_flux_pallas` :178) and its XLA twin `_eats_stage2_xla`
// in "fused" mode (nmma_tpu/models/grb.py:510). For every live point b and
// theta ring i, with the ring's dynamics tabulated on R radii:
//
//   theta_r  = exp(log_tracks[b, 4, i, r])            (the moving ring angle)
//   log_t    = min(cummax_r log max((1+z)(t_delay + (1 - mu(theta_r, phi)) R/c),
//                                   1e-10), 60)       per phi: [Ph, R]
//   hat      = clip(min((lq - x_l)/dl, (x_r - lq)/dr), 0, 1)   per (phi, t, r)
//   raw_k    = sum_r hat * track_k,  k = 0..4,  raw_5 = sum_r hat
//   vals_k   = exp(raw_k / max(raw_5, 1))         (gamma, nu_m', nu_c', em, theta)
//   em       = 0 unless log_t[0] <= lq <= log_t[R-1]   (the test of grb.py:606)
//   out[b, i, f, t] = sum_phi w_phi (1+z) delta^2 em S(nu_f (1+z)/delta) / (1 - mu beta_sh)
//
// with S the slow/fast-cooling SPN98 broken power law, evaluated in log space
// (l_num and l_nuc are raw_1/denom and raw_2/denom themselves).
//
// Bound: after the cummax each phi row of log_t is monotone, and the 1e-12
// width clamp gives plateau nodes no weight, so at most the two nodes that
// bracket a query are nonzero. The function needs the map (11 f32
// operations per (live point, ring, phi, r), an FMA counted as two), an
// in-range test per query, and for a query in range a 7-step search, two
// hat nodes and the epilogue: ~7.4e10 operations at B = 8192, Th = 48,
// Ph = 16, T = 64, R = 128, F = 5, ~1.1 ms at the H100 SXM's 67 TFLOP/s of
// f32 outside the tensor cores, against ~1.7 GB of operands and output
// (~0.5 ms at 3.35 TB/s): bound by arithmetic (chip_smoke.py computes it
// from each run's data). This kernel sweeps the dense hat instead, 18
// operations per (live point, ring, phi, t, r), ~9.8e11 in all: it took
// 36.9 ms on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py), ~3% of the bound. A search for the two live nodes is
// the redesign that follows.
//
// Design: one block per (live point, ring). The TPU wrapper built the
// [B, Th, Ph, R] arrival-time map in device memory (~150 MB per chunk of 128
// live points); here the map, its cummax along R and the cap at 60 are built
// in shared memory by the block itself. Each phi row gets 16 threads; a
// thread owns up to 4 observer times of one phi row, so the row's hat
// coefficients {x_l, x_r, 1/dl, 1/dr} (one 16-byte shared load) and the five
// tracks (one 16-byte and one 4-byte broadcast load) serve 4 queries per
// radius, and the 24 sums live in registers. Each thread then applies the
// Doppler and synchrotron math and writes its [F] partials to shared memory;
// the phi sum runs in a fixed order, without atomics, so the result does not
// change from run to run. No --use_fast_math: the tracks are logs up to 88 in
// magnitude, so an error in exp's argument is amplified.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MAX_R = 256;
constexpr int MAX_T = 64;
constexpr int MAX_F = 8;
constexpr int MAX_PHI = 64;
constexpr int TPP = 16;                     // threads per phi row
constexpr int KT = MAX_T / TPP;             // observer times per thread
constexpr int SMEM_LIMIT = 227 * 1024;      // bytes a block can use on sm_90
constexpr float C_CGS = 2.99792458e10f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int threads_for(int n_phi) {
  return ((n_phi * TPP + 31) / 32) * 32;
}

// shared memory layout, in floats: a union region (geometry [4, R] while
// the map is built, hat coefficients [Ph, R+1] float4 in the loop, partials
// [Ph, F, T] after it), rounded up to whole float4s; then tracks 0-3 [R]
// float4, track 4 [R], log_t [Ph, R+1] and ln(nu (1+z)) [F]
__host__ __device__ inline size_t union_floats(int R, int T, int Ph, int F) {
  size_t coef = static_cast<size_t>(4) * Ph * (R + 1);
  size_t part = static_cast<size_t>(Ph) * F * T;
  size_t geo = static_cast<size_t>(4) * R;
  size_t m = coef > part ? coef : part;
  m = m > geo ? m : geo;
  return (m + 3) / 4 * 4;
}

__host__ __device__ inline size_t smem_floats(int R, int T, int Ph, int F) {
  return union_floats(R, T, Ph, F) + static_cast<size_t>(5) * R
         + static_cast<size_t>(Ph) * (R + 1) + F;
}

__global__ void grb_eats_kernel(const float* __restrict__ t_delay,
                                const float* __restrict__ tracks,
                                const float* __restrict__ r_grid,
                                const float* __restrict__ scal,
                                const float* __restrict__ log_q,
                                const float* __restrict__ cphi,
                                const float* __restrict__ wphi,
                                const float* __restrict__ nu_obs,
                                float* __restrict__ out,
                                int Th, int R, int T, int Ph, int F) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int RS = R + 1;                                   // padded row stride
  float4* coef = smem4;                                   // [Ph][RS]
  float* geo = smem;                                      // [4][R], aliases coef
  float* part = smem;                                     // [Ph][F][T], aliases coef
  float4* trk = smem4 + union_floats(R, T, Ph, F) / 4;    // [R] tracks 0-3
  float* trk4 = reinterpret_cast<float*>(trk + R);        // [R] track 4
  float* lt = trk4 + R;                                   // [Ph][RS]
  float* lnu = lt + Ph * RS;                              // [F]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int bt = blockIdx.x;                              // b * Th + ring
  const int b = bt / Th;
  const int ring = bt - b * Th;
  const float* sc = scal + static_cast<size_t>(b) * 8;
  const float z = sc[0], sin_tv = sc[2], p = sc[3], theta_v = sc[4];
  const float opz = 1.f + z;

  // 1. the ring's tracks, and the geometry of its arrival-time map
  for (int r = tid; r < R; r += nthreads) {
    float v[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      v[k] = tracks[(static_cast<size_t>(b * 5 + k) * Th + ring) * R + r];
    trk[r] = make_float4(v[0], v[1], v[2], v[3]);
    trk4[r] = v[4];
    const float th_r = expf(v[4]);
    const float s = sinf(0.5f * (theta_v - th_r));
    geo[r] = 2.f * (s * s);                               // 2 sin^2((tv - th)/2)
    geo[R + r] = sin_tv * sinf(th_r);
    geo[2 * R + r] = t_delay[static_cast<size_t>(bt) * R + r];
    geo[3 * R + r] = r_grid[static_cast<size_t>(b) * R + r];
  }
  for (int f = tid; f < F; f += nthreads)
    lnu[f] = logf(nu_obs[static_cast<size_t>(b) * F + f] * opz);
  __syncthreads();

  // 2. log arrival times per (phi, r)
  for (int i = tid; i < Ph * R; i += nthreads) {
    const int ph = i / R, r = i - (i / R) * R;
    const float omm = geo[r] + geo[R + r] * (1.f - cphi[ph]);
    const float t_obs = opz * (geo[2 * R + r] + omm * geo[3 * R + r] / C_CGS);
    lt[ph * RS + r] = logf(fmaxf(t_obs, 1e-10f));
  }
  __syncthreads();

  // 3. cummax along R (arrival times of material moving toward the observer
  //    can decrease), capped at 60: one warp per phi row, a lane scans a
  //    run of consecutive radii and the lanes' maxima are combined by shuffles
  {
    const int warp = tid / 32, lane = tid % 32, nwarps = nthreads / 32;
    const int run_len = (R + 31) / 32;
    for (int ph = warp; ph < Ph; ph += nwarps) {
      float* row = lt + ph * RS;
      const int r0 = lane * run_len;
      float m = -CUDART_INF_F;
      for (int e = 0; e < run_len; ++e)
        if (r0 + e < R) m = fmaxf(m, row[r0 + e]);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(FULL, m, o);
        if (lane >= o) m = fmaxf(m, y);
      }
      float run = __shfl_up_sync(FULL, m, 1);
      if (lane == 0) run = -CUDART_INF_F;
      for (int e = 0; e < run_len; ++e) {
        if (r0 + e < R) {
          run = fmaxf(run, row[r0 + e]);
          row[r0 + e] = fminf(run, 60.f);
        }
      }
    }
  }
  __syncthreads();

  // 4. hat coefficients per (phi, r): neighbours and inverse widths, the
  //    widths clamped at 1e-12, so a node takes no weight from a flat side
  for (int i = tid; i < Ph * R; i += nthreads) {
    const int ph = i / R, r = i - (i / R) * R;
    const float* row = lt + ph * RS;
    const float c = row[r];
    const float xl = row[r > 0 ? r - 1 : 0];
    const float xr = row[r < R - 1 ? r + 1 : R - 1];
    coef[ph * RS + r] = make_float4(xl, xr, 1.f / fmaxf(c - xl, 1e-12f),
                                    1.f / fmaxf(xr - c, 1e-12f));
  }
  __syncthreads();

  // 5. the dense hat contraction: 4 queries x 6 sums per thread
  const int ph = tid / TPP, tl = tid % TPP;
  const bool active = ph < Ph;
  float lq[KT];
  float acc[KT][6];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int t = tl + TPP * k;
    lq[k] = (active && t < T) ? log_q[t] : 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[k][j] = 0.f;
  }
  if (active) {
    const float4* crow = coef + ph * RS;
#pragma unroll 2
    for (int r = 0; r < R; ++r) {
      const float4 c = crow[r];
      const float4 tr = trk[r];
      const float t4 = trk4[r];
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const float up = (lq[k] - c.x) * c.z;
        const float dn = (c.y - lq[k]) * c.w;
        const float h = fminf(fmaxf(fminf(up, dn), 0.f), 1.f);
        acc[k][0] = fmaf(h, tr.x, acc[k][0]);
        acc[k][1] = fmaf(h, tr.y, acc[k][1]);
        acc[k][2] = fmaf(h, tr.z, acc[k][2]);
        acc[k][3] = fmaf(h, tr.w, acc[k][3]);
        acc[k][4] = fmaf(h, t4, acc[k][4]);
        acc[k][5] += h;
      }
    }
  }
  __syncthreads();                     // part (below) overwrites coef

  // 6. Doppler factor and synchrotron spectrum per (phi, t), partials per f
  if (active) {
    const float lo = lt[ph * RS], hi = lt[ph * RS + R - 1];
    const float cp = cphi[ph], w = wphi[ph];
    const float third = 1.f / 3.f, e_mid = -(p - 1.f) / 2.f, e_hi = -p / 2.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = tl + TPP * k;
      if (t >= T) continue;
      const float inv = 1.f / fmaxf(acc[k][5], 1.f);
      const float g = expf(acc[k][0] * inv);
      const float l_num = acc[k][1] * inv;
      const float l_nuc = acc[k][2] * inv;
      const bool in_range = (lq[k] >= lo) && (lq[k] <= hi);
      const float em = in_range ? expf(acc[k][3] * inv) : 0.f;
      const float th_t = expf(acc[k][4] * inv);
      const float s = sinf(0.5f * (theta_v - th_t));
      const float omm = 2.f * (s * s) + sin_tv * sinf(th_t) * (1.f - cp);
      const float u2 = fmaxf(g * g - 1.f, 1e-12f);
      const float be = sqrtf(u2) / g;
      const float one_m_be = 1.f / (g * g * (1.f + be));
      const float inv_gd = g * (one_m_be + be * omm);      // 1 / delta
      const float s_sh = sqrtf(1.f + 1.f / u2);
      const float one_m_bs = (3.f - 4.f / (s_sh + 1.f)) / (4.f * u2 + 3.f);
      const float ashock = one_m_bs + (1.f - one_m_bs) * omm;
      const float common = w * opz * em / (inv_gd * inv_gd * ashock);
      const float l_gd = logf(inv_gd);
      for (int f = 0; f < F; ++f) {
        const float l_nu = lnu[f] + l_gd;                   // ln nu'
        float e;
        if (l_num <= l_nuc) {                               // slow cooling
          e = l_nu < l_num ? third * (l_nu - l_num)
            : l_nu < l_nuc ? e_mid * (l_nu - l_num)
            : e_mid * (l_nuc - l_num) + e_hi * (l_nu - l_nuc);
        } else {                                            // fast cooling
          e = l_nu < l_nuc ? third * (l_nu - l_nuc)
            : l_nu < l_num ? -0.5f * (l_nu - l_nuc)
            : -0.5f * (l_num - l_nuc) + e_hi * (l_nu - l_num);
        }
        part[(ph * F + f) * T + t] = common * expf(e);
      }
    }
  }
  __syncthreads();

  // 7. the phi sum in a fixed order, written coalesced
  float* o = out + static_cast<size_t>(bt) * F * T;
  for (int i = tid; i < F * T; i += nthreads) {
    float acc_phi = 0.f;
    for (int q = 0; q < Ph; ++q) acc_phi += part[q * F * T + i];
    o[i] = acc_phi;
  }
}

}  // namespace

// 1 if the kernel is built for these shapes: 2 <= R <= 256, T <= 64,
// F <= 8, Ph <= 64, B * Th blocks in a 1-D grid and at most 227 KB of
// shared memory per block; else 0. The wrapper asks before a launch.
extern "C" int nmma_grb_eats_supported(long long B, int Th, int R, int T,
                                       int Ph, int F) {
  return B >= 0 && Th >= 1 && R >= 2 && R <= MAX_R && T >= 1 &&
         T <= MAX_T && F >= 1 && F <= MAX_F && Ph >= 1 && Ph <= MAX_PHI &&
         B * Th <= 0x7fffffffLL &&
         sizeof(float) * smem_floats(R, T, Ph, F) <=
             static_cast<size_t>(SMEM_LIMIT);
}

// Plain C entry point for ctypes. Device pointers to contiguous f32 arrays:
// t_delay [B, Th, R] (s), log_tracks [B, 5, Th, R], r_grid [B, R] (cm),
// scal [B, 8] (z, cos theta_v, sin theta_v, p, theta_v, 0, 0, 0),
// log_q [T] (ln s), cphi and wphi [Ph], nu_obs [B, F] (Hz), out [B, Th, F, T],
// all on CUDA device `device`; the launch goes to `stream`. Shapes that
// nmma_grb_eats_supported refuses return cudaErrorInvalidValue. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int nmma_grb_eats(const void* t_delay, const void* tracks,
                             const void* r_grid, const void* scal,
                             const void* log_q, const void* cphi,
                             const void* wphi, const void* nu_obs, void* out,
                             int B, int Th, int R, int T, int Ph, int F,
                             int device, void* stream) {
  if (!nmma_grb_eats_supported(B, Th, R, T, Ph, F))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long blocks = static_cast<long long>(B) * Th;
  const size_t smem = sizeof(float) * smem_floats(R, T, Ph, F);
  const cudaError_t attr = cudaFuncSetAttribute(
      grb_eats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  grb_eats_kernel<<<static_cast<unsigned>(blocks), threads_for(Ph), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t_delay), static_cast<const float*>(tracks),
      static_cast<const float*>(r_grid), static_cast<const float*>(scal),
      static_cast<const float*>(log_q), static_cast<const float*>(cphi),
      static_cast<const float*>(wphi), static_cast<const float*>(nu_obs),
      static_cast<float*>(out), Th, R, T, Ph, F);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nmma_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
