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
// Two live nodes. After the cummax a log_t row x is non-decreasing, and node
// r's hat is nonzero only where x_{r-1} < lq < x_{r+1} (x_{-1} = x_0, x_R =
// x_{R-1}). With j = max{r : x_r <= lq}, nodes r < j have x_{r+1} <= lq and
// nodes r > j+1 have x_{r-1} > lq: only j and j+1 carry weight, and the sums
// over them, from 0 in r order with the same fmaf, are the dense sums bit for
// bit (the dense loop adds exact zeros around them; the tracks are finite).
//
// Bound: the map (11 f32 operations per (live point, ring, phi, r), an FMA
// counted as two), an in-range test per query and, for a query in range, a
// ceil(log2 R)-step search, two hat nodes and the epilogue: ~7.3e10 operations
// at B = 8192, Th = 48, Ph = 16, T = 64, R = 128, F = 5, ~1.09 ms at the H100
// SXM's 67 TFLOP/s of f32 outside the tensor cores, against ~1.7 GB of
// operands and output (~0.5 ms at 3.35 TB/s): bound by arithmetic
// (chip_smoke.py computes it from each run's data). What holds the kernel back
// is the cost of IEEE f32 in instructions, not operations: per query the
// epilogue's three expf, two sinf, a logf, two sqrtf and seven IEEE divisions,
// and one expf per filter; per (phi, r) cell a logf and a division. The map,
// its cummax and the phi sum take ~40% of the time (chip_smoke.py times the
// same rows with every query out of range), the search, the nodes and the
// epilogue the rest. 48 registers, no spills (ptxas), so 5 blocks of 256
// threads share an SM.
//
// Design: one block of THREADS = 256 threads per (live point, ring). The TPU
// wrapper built the [B, Th, Ph, R] arrival-time map in device memory (~150 MB
// per chunk of 128 live points); here it is built in shared memory by the
// block itself, beside the ring's five tracks: one warp per phi row, a lane a
// run of consecutive radii with their running maximum in registers, the lanes'
// maxima combined by shuffles, the cap at 60, each value written once. Then
// each thread takes (phi, t) queries in turn, consecutive threads on
// consecutive t. A query outside [x_0, x_{R-1}] has em = 0, so its partials
// are exactly 0 and it skips the nodes and the epilogue; a query in range
// finds j by binary lifting over the shared row, evaluates the hats of nodes j
// and j+1 with the dense form's expressions (the width between them is
// inverted once), applies the Doppler and synchrotron math and writes its [F]
// partials to shared memory. The phi sum runs in a fixed order, without
// atomics, so the result does not change from run to run. No hat-coefficient
// table: ~31 KB of shared memory per block at the main path's shapes, and
// registers, not shared memory, cap the blocks per SM; 128 or 512 threads a
// block, or a register cap for 6 blocks (which spills), ran slower. No
// --use_fast_math: the tracks are logs up to 88 in magnitude, so an error in
// exp's argument is amplified. The dense sweep over all R radii that this
// replaces (18 operations per (point, ring, phi, t, r)) took 36.9-37.2 ms at
// B=8192 on an NVIDIA H100 80GB HBM3 at a 700 W power limit; this kernel takes
// 11.7 ms on the same card and limit (chip_smoke.py, PERF.md).
//
// Per-row queries (q_stride = 1, T = 1): the TrPi2018 energy ramp gives every
// observer-time node its own blast-wave energy, so its nodes are folded into
// the batch and each (live point, node) row asks for the flux at its own time
// log_q[b]. The block is the same; one thread per phi row has a query, the
// others only help build the map. The shared mode (q_stride = 0, log_q [T])
// computes what it did before.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MAX_R = 256;
constexpr int MAX_T = 64;
constexpr int MAX_F = 8;
constexpr int MAX_PHI = 64;
constexpr int THREADS = 256;                // threads per block
constexpr int RUN_MAX = MAX_R / 32;         // radii per lane in a row scan
constexpr int SMEM_LIMIT = 227 * 1024;      // bytes a block can use on sm_90
constexpr float C_CGS = 2.99792458e10f;
constexpr unsigned FULL = 0xffffffffu;

// a lane of the row scan owns ceil(R/32) consecutive radii; their geometry
// lies at an odd float4 stride per lane, so the lanes' 16-byte loads fall
// in distinct banks
__host__ __device__ inline int geo_stride(int R) { return ((R + 31) / 32) | 1; }

// shared memory layout, in floats: a union region (geometry [32, stride]
// float4 while the map is built, partials [Ph, F, T] after it), rounded up
// to whole float4s; then tracks 0-3 [R] float4, track 4 [R], log_t
// [Ph, R+1] and ln(nu (1+z)) [F]
__host__ __device__ inline size_t union_floats(int R, int T, int Ph, int F) {
  size_t part = static_cast<size_t>(Ph) * F * T;
  size_t geo = static_cast<size_t>(4) * 32 * geo_stride(R);
  size_t m = part > geo ? part : geo;
  return (m + 3) / 4 * 4;
}

__host__ __device__ inline size_t smem_floats(int R, int T, int Ph, int F) {
  return union_floats(R, T, Ph, F) + static_cast<size_t>(5) * R
         + static_cast<size_t>(Ph) * (R + 1) + F;
}

__global__ void __launch_bounds__(THREADS)
grb_eats_kernel(const float* __restrict__ t_delay,
                const float* __restrict__ tracks,
                const float* __restrict__ r_grid,
                const float* __restrict__ scal,
                const float* __restrict__ log_q,
                const float* __restrict__ cphi,
                const float* __restrict__ wphi,
                const float* __restrict__ nu_obs,
                float* __restrict__ out,
                int Th, int R, int T, int Ph, int F, int q_stride) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int RS = R + 1;                                   // padded row stride
  float4* geo = smem4;                                    // [32][stride]
  float* part = smem;                                     // [Ph][F][T], aliases geo
  float4* trk = smem4 + union_floats(R, T, Ph, F) / 4;    // [R] tracks 0-3
  float* trk4 = reinterpret_cast<float*>(trk + R);        // [R] track 4
  float* lt = trk4 + R;                                   // [Ph][RS]
  float* lnu = lt + Ph * RS;                              // [F]

  const int tid = threadIdx.x;
  const int bt = blockIdx.x;                              // b * Th + ring
  const int b = bt / Th;
  const int ring = bt - b * Th;
  const float* sc = scal + static_cast<size_t>(b) * 8;
  const float z = sc[0], sin_tv = sc[2], p = sc[3], theta_v = sc[4];
  const float opz = 1.f + z;
  const float* lq_row = log_q + static_cast<size_t>(b) * q_stride;

  // 1. the ring's tracks, and the geometry of its arrival-time map:
  //    {2 sin^2((tv - th)/2), sin tv sin th, t_delay, radius} per radius
  const int run_len = (R + 31) / 32, stride = geo_stride(R);
  for (int r = tid; r < R; r += THREADS) {
    float v[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      v[k] = tracks[(static_cast<size_t>(b * 5 + k) * Th + ring) * R + r];
    trk[r] = make_float4(v[0], v[1], v[2], v[3]);
    trk4[r] = v[4];
    const float th_r = expf(v[4]);
    const float s = sinf(0.5f * (theta_v - th_r));
    geo[(r / run_len) * stride + r % run_len] = make_float4(
        2.f * (s * s), sin_tv * sinf(th_r),
        t_delay[static_cast<size_t>(bt) * R + r],
        r_grid[static_cast<size_t>(b) * R + r]);
  }
  for (int f = tid; f < F; f += THREADS)
    lnu[f] = logf(nu_obs[static_cast<size_t>(b) * F + f] * opz);
  __syncthreads();

  // 2. log arrival times per (phi, r) and their cummax along R (arrival
  //    times of material moving toward the observer can decrease), capped
  //    at 60: one warp per phi row. A lane computes a run of consecutive
  //    radii and their running maximum in registers; the lanes' maxima are
  //    combined by shuffles, and each value is written once.
  {
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = lane * run_len;
    const float4* g = geo + lane * stride;
    for (int ph = warp; ph < Ph; ph += THREADS / 32) {
      const float one_m_cp = 1.f - cphi[ph];
      float v[RUN_MAX];
      float m = -CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < RUN_MAX; ++e) {
        const int r = r0 + e;
        if (e < run_len && r < R) {
          const float4 q = g[e];
          const float omm = q.x + q.y * one_m_cp;
          const float t_obs = opz * (q.z + omm * q.w / C_CGS);
          m = fmaxf(m, logf(fmaxf(t_obs, 1e-10f)));
        }
        v[e] = m;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(FULL, m, o);
        if (lane >= o) m = fmaxf(m, y);
      }
      float run = __shfl_up_sync(FULL, m, 1);
      if (lane == 0) run = -CUDART_INF_F;
      float* row = lt + ph * RS;
#pragma unroll
      for (int e = 0; e < RUN_MAX; ++e)
        if (e < run_len && r0 + e < R)
          row[r0 + e] = fminf(fmaxf(run, v[e]), 60.f);
    }
  }
  __syncthreads();             // part (below) overwrites geo

  // 3. per (phi, t) query: the search, the two live hat nodes, the Doppler
  //    factor and synchrotron spectrum, partials per f; a thread steps
  //    THREADS queries at a time through the row-major [Ph, T] grid
  int half = 1;                                           // ceil_pow2(R) / 2
  while (2 * half < R) half *= 2;
  const float third = 1.f / 3.f, e_mid = -(p - 1.f) / 2.f, e_hi = -p / 2.f;
  const int step_ph = THREADS / T, step_t = THREADS - step_ph * T;
  int ph = tid / T, t = tid - ph * T;
#pragma unroll 1
  for (; ph < Ph; ph += step_ph, t += step_t) {
    if (t >= T) { t -= T; ++ph; if (ph >= Ph) break; }
    const float* row = lt + ph * RS;
    float* pp = part + ph * F * T + t;
    const float lq = lq_row[t];
    if (!(lq >= row[0] && lq <= row[R - 1])) {           // em = 0: no flux
      for (int f = 0; f < F; ++f) pp[f * T] = 0.f;
      continue;
    }
    // j = max{r : row[r] <= lq}; row[0] <= lq, and the steps sum to
    // 2 half - 1 >= R - 1
    int j = 0;
    for (int s = half; s > 0; s >>= 1)
      if (j + s < R && row[j + s] <= lq) j += s;
    // nodes j and j+1, in r order, with the dense form's expressions: the
    // neighbours clamped at the row's ends, widths clamped at 1e-12. The
    // width x_{j+1} - x_j is node j's right side and node j+1's left side.
    const float xa = row[j > 0 ? j - 1 : 0], x0 = row[j];
    const float x1 = row[j < R - 1 ? j + 1 : R - 1];
    const float inv_mid = 1.f / fmaxf(x1 - x0, 1e-12f);
    float acc[6];
    {
      const float up = (lq - xa) * (1.f / fmaxf(x0 - xa, 1e-12f));
      const float dn = (x1 - lq) * inv_mid;
      const float h = fminf(fmaxf(fminf(up, dn), 0.f), 1.f);
      const float4 tr = trk[j];
      acc[0] = fmaf(h, tr.x, 0.f);
      acc[1] = fmaf(h, tr.y, 0.f);
      acc[2] = fmaf(h, tr.z, 0.f);
      acc[3] = fmaf(h, tr.w, 0.f);
      acc[4] = fmaf(h, trk4[j], 0.f);
      acc[5] = 0.f + h;
    }
    if (j + 1 < R) {
      const float x2 = row[j + 2 < R ? j + 2 : R - 1];
      const float up = (lq - x0) * inv_mid;
      const float dn = (x2 - lq) * (1.f / fmaxf(x2 - x1, 1e-12f));
      const float h = fminf(fmaxf(fminf(up, dn), 0.f), 1.f);
      const float4 tr = trk[j + 1];
      acc[0] = fmaf(h, tr.x, acc[0]);
      acc[1] = fmaf(h, tr.y, acc[1]);
      acc[2] = fmaf(h, tr.z, acc[2]);
      acc[3] = fmaf(h, tr.w, acc[3]);
      acc[4] = fmaf(h, trk4[j + 1], acc[4]);
      acc[5] += h;
    }
    const float cp = cphi[ph], w = wphi[ph];
    const float inv = 1.f / fmaxf(acc[5], 1.f);
    const float g = expf(acc[0] * inv);
    const float l_num = acc[1] * inv;
    const float l_nuc = acc[2] * inv;
    const float em = expf(acc[3] * inv);
    const float th_t = expf(acc[4] * inv);
    const float s = sinf(0.5f * (theta_v - th_t));
    const float omm = 2.f * (s * s) + sin_tv * sinf(th_t) * (1.f - cp);
    const float u2 = fmaxf(g * g - 1.f, 1e-12f);
    const float be = sqrtf(u2) / g;
    const float one_m_be = 1.f / (g * g * (1.f + be));
    const float inv_gd = g * (one_m_be + be * omm);         // 1 / delta
    const float s_sh = sqrtf(1.f + 1.f / u2);
    const float one_m_bs = (3.f - 4.f / (s_sh + 1.f)) / (4.f * u2 + 3.f);
    const float ashock = one_m_bs + (1.f - one_m_bs) * omm;
    const float common = w * opz * em / (inv_gd * inv_gd * ashock);
    const float l_gd = logf(inv_gd);
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) {
      if (f >= F) break;
      const float l_nu = lnu[f] + l_gd;                     // ln nu'
      float e;
      if (l_num <= l_nuc) {                                 // slow cooling
        e = l_nu < l_num ? third * (l_nu - l_num)
          : l_nu < l_nuc ? e_mid * (l_nu - l_num)
          : e_mid * (l_nuc - l_num) + e_hi * (l_nu - l_nuc);
      } else {                                              // fast cooling
        e = l_nu < l_nuc ? third * (l_nu - l_nuc)
          : l_nu < l_num ? -0.5f * (l_nu - l_nuc)
          : -0.5f * (l_num - l_nuc) + e_hi * (l_nu - l_num);
      }
      pp[f * T] = common * expf(e);
    }
  }
  __syncthreads();

  // 4. the phi sum in a fixed order, written coalesced
  float* o = out + static_cast<size_t>(bt) * F * T;
  for (int i = tid; i < F * T; i += THREADS) {
    float acc_phi = 0.f;
    for (int q = 0; q < Ph; ++q) acc_phi += part[q * F * T + i];
    o[i] = acc_phi;
  }
}

}  // namespace

// 1 if the kernel is built for these shapes: 2 <= R <= 256, T <= 64,
// F <= 8, Ph <= 64, B * Th blocks in a 1-D grid and at most 227 KB of
// shared memory per block, with log_q shared (q_stride 0) or one query a row
// (q_stride 1 and T = 1); else 0. The wrapper asks before a launch.
extern "C" int nmma_grb_eats_supported(long long B, int Th, int R, int T,
                                       int Ph, int F, int q_stride) {
  return B >= 0 && Th >= 1 && R >= 2 && R <= MAX_R && T >= 1 &&
         (q_stride == 0 || (q_stride == 1 && T == 1)) &&
         T <= MAX_T && F >= 1 && F <= MAX_F && Ph >= 1 && Ph <= MAX_PHI &&
         B * Th <= 0x7fffffffLL &&
         sizeof(float) * smem_floats(R, T, Ph, F) <=
             static_cast<size_t>(SMEM_LIMIT);
}

// Plain C entry point for ctypes. Device pointers to contiguous f32 arrays:
// t_delay [B, Th, R] (s), log_tracks [B, 5, Th, R], r_grid [B, R] (cm),
// scal [B, 8] (z, cos theta_v, sin theta_v, p, theta_v, 0, 0, 0),
// log_q [T] (ln s; q_stride 0) or [B] (one query a row; q_stride 1, T = 1),
// cphi and wphi [Ph], nu_obs [B, F] (Hz), out [B, Th, F, T], all on CUDA
// device `device`; the launch goes to `stream`. Shapes that
// nmma_grb_eats_supported refuses return cudaErrorInvalidValue. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int nmma_grb_eats(const void* t_delay, const void* tracks,
                             const void* r_grid, const void* scal,
                             const void* log_q, const void* cphi,
                             const void* wphi, const void* nu_obs, void* out,
                             int B, int Th, int R, int T, int Ph, int F,
                             int q_stride, int device, void* stream) {
  if (!nmma_grb_eats_supported(B, Th, R, T, Ph, F, q_stride))
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
  grb_eats_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t_delay), static_cast<const float*>(tracks),
      static_cast<const float*>(r_grid), static_cast<const float*>(scal),
      static_cast<const float*>(log_q), static_cast<const float*>(cphi),
      static_cast<const float*>(wphi), static_cast<const float*>(nu_obs),
      static_cast<float*>(out), Th, R, T, Ph, F, q_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nmma_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
