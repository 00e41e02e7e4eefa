// K4: TrPi2018's stage 1 on Hopper (sm_90a), IEEE f32.
//
// The blast-wave dynamics of every (live point, theta ring) up to K3's
// operands, in one pass: the plain version (`grb_stage1_plain`,
// nmma_tpu_torch/models/grb.py) is ~224 eager kernels over [B, Th, R]
// tensors, and the JAX package leaves the same chain to XLA's fusion
// (nmma_tpu/models/grb.py:102-497); no Pallas kernel replaces it. Per row b:
//
//   e0, n0, eps_e, eps_b  from their log10 parameters, clamped in log space
//   theta edges = edge_frac * theta_max, ring centres theta_i, d_cos_i
//   E_i       = E_iso(theta_i) / 1e50 (tophat, Gaussian or power law) >= 1e-12
//   e_ref     = max_i E_i             (the block's reduction over the row)
//   r_grid[r] = r_min (r_max / r_min)^frac[r], from R_dec(e_ref, n0) and the
//               on-axis reach at the last observer time
//
// and per ring i, in r order (every integral is causal in r):
//
//   u2_a      = min(E_i / M_sw c^2, 1e8)            (the swept mass alone)
//   t_b,a     = trapz of 1/(beta_a c)               (only with an L0 injection)
//   E_inj     = L0 ts int_1^{t_b,a/ts} x^-q dx      (only with an injection)
//   dtheta    = dlnR trapz of c_s/(Gamma beta) on Gamma theta_core < 1 (spread)
//   omega     = solid-angle factor of the spread ring; the trumpet's swept mass
//               M_eff(R) = int omega r^2 dr       (trumpet)
//   u2        = min((E_i + E_inj) / (M_sw c^2 omega_eff), 1e8)
//   1-beta_sh = (3 - 4/(s+1)) / (4 u2 + 3), s = sqrt(1 + 1/u2)
//   t_b, t_delay = trapz of 1/(beta_sh c) and (1-beta_sh)/(beta_sh c)
//
// and on the stage-2 subgrid (every `sub`-th radius) the field, gamma_m,
// gamma_c, nu_m', nu_c', the emissivity and the five clamped log tracks.
// Every expression follows the plain version operation by operation, with
// PyTorch's rounding: a Python float is rounded to f32 before it meets a
// tensor, `tensor / float` is a product with the f32 reciprocal and
// `float / tensor` a reciprocal times the float, `x ** 2` and `x ** 3` are
// products, clamps and maxima propagate NaN. The file is built with
// -fmad=false (nmma_tpu_torch/_kernels.py), so no product and sum are fused
// where the eager chain rounds twice. The one difference left is the order
// of the five running sums: sequential in r here, a parallel scan in
// torch.cumsum on the card (and a float64 accumulator on the CPU).
//
// Design: a block holds `rows` live points and one thread per (row, ring),
// rows x Th <= 128 (2 rows of 48 rings: 3 full warps; 4 rows in 6 warps ran
// 4% slower at B = 8192, and CHUNK = 4 or 16 slower still). The ring thread loads
// its row's parameters (the same addresses across the row, so L1 serves
// them), writes E_i to shared memory; after a barrier the row's first thread
// reduces e_ref and sets the grid's two numbers, and all threads of the block
// fill the rows' radius grids (one powf per (row, radius), not per ring) in
// shared memory and write r_grid's subgrid. Then each thread walks r = 0..R-1
// with its running integrals and previous-radius values in registers. The
// subgrid values of CHUNK consecutive subgrid radii are staged in shared
// memory ([6, threads, CHUNK + 1], an odd pitch so the ring threads' writes
// fall in distinct banks); after a barrier the block writes them out with
// consecutive threads on consecutive radii of one ring, so every warp store
// fills whole 32-byte sectors of t_delay [B, Th, R'] and log_tracks
// [B, 5, Th, R']. Nothing [B, Th, R]-sized but K3's operands reaches device
// memory. The injection, spreading and trumpet switches are template
// parameters; the jet type, the injection's form, the distance's units and
// the time grid's form are uniform branches outside the radius loop.
#include <cuda_runtime.h>

namespace {

// stage 1's parameters, in the order of SLOTS in
// nmma_tpu_torch/ops/grb_dynamics_kernel.py
enum Slot {
  S_THETA_CORE, S_LOG10_E0, S_THETA_WING, S_THETA_V, S_LOG10_N0, S_P,
  S_LOG10_EPS_E, S_LOG10_EPS_B, S_XI_N, S_DISTANCE, S_Z, S_B, S_L0, S_Q, S_TS,
  N_SLOTS
};

constexpr int JET_TOPHAT = -1;
constexpr int JET_GAUSSIAN = 0;
constexpr int JET_POWERLAW = 4;
// the injection's form: none; 10^(log10_L0 - 50) (a column); L0 1e-25
// 1e-25 (a column); a positive constant L0 / 1e50
constexpr int INJ_NONE = 0;
constexpr int INJ_LOG10 = 1;
constexpr int INJ_RAW = 2;
constexpr int INJ_CONST = 3;

constexpr int MAX_THREADS = 256;
constexpr int MAX_TH = MAX_THREADS;
constexpr int ROW_THREADS = 128;            // threads a block aims at
constexpr int MAX_R = 4096;
constexpr int CHUNK = 8;                    // subgrid radii staged per pass
constexpr int PITCH = CHUNK + 1;
constexpr int N_OUT = 6;                    // t_delay and the five tracks
constexpr int ROW_SCALARS = 4;              // t_max, r_min, r_max / r_min, pad
constexpr size_t SMEM_LIMIT = 227 * 1024;   // bytes a block can use on sm_90

// the Python floats of models/grb.py, in Python's order of evaluation, then
// rounded to f32 as PyTorch rounds a scalar operand
constexpr double PI = 3.141592653589793;
constexpr double C_CGS = 29979245800.0;
constexpr double QE = 4.80320425e-10;
constexpr double ME = 9.1093837015e-28;
constexpr double MP = 1.67262192369e-24;
constexpr double SIGMA_T = 6.6524587321e-25;
constexpr float K_C = static_cast<float>(C_CGS);
constexpr float K_RDEC = static_cast<float>(
    3.0 * 1e50 / (4.0 * PI * MP * (C_CGS * C_CGS) * 1e4 * 1e51));
constexpr float K_MSW = static_cast<float>(
    (4.0 * PI / 3.0) * MP * (C_CGS * C_CGS) * 1e51 / 1e50);
constexpr float K_THIRD = static_cast<float>(1.0 / 3.0);
constexpr float K_HALF_PI = static_cast<float>(PI / 2.0);
constexpr float K_32PI = static_cast<float>(32.0 * PI);
constexpr float K_MP = static_cast<float>(MP);
constexpr float K_MP_ME = static_cast<float>(MP / ME);
constexpr float K_6PI_ME_C = static_cast<float>(6.0 * PI * ME * C_CGS);
constexpr float K_SIGMA_T = static_cast<float>(SIGMA_T);
constexpr float K_3_4PI = static_cast<float>(3.0 / (4.0 * PI));
constexpr float K_QE = static_cast<float>(QE);
constexpr float K_INV_ME_C = 1.0f / static_cast<float>(ME * C_CGS);
constexpr float K_EM_C = static_cast<float>(
    1.7320508075688772 * (QE * QE * QE) / (2.0 * ME * (C_CGS * C_CGS)));
constexpr float K_EM_SCALE = static_cast<float>(1e51 / 3.0 / 1e50);
constexpr float K_EM_FLOOR = static_cast<float>(1e-38);   // subnormal
constexpr float SECONDS_A_DAY = 86400.0f;

// a parameter: a column of f32 on the device read at b * stride (stride 0:
// one value for the batch), or, where col is null, the constant val
struct Slots {
  const float* col[N_SLOTS];
  long long stride[N_SLOTS];
  float val[N_SLOTS];
};

struct Modes {
  int jet;              // JET_TOPHAT, JET_GAUSSIAN or JET_POWERLAW
  int inj;              // INJ_*
  int wing_from_core;   // thetaWing absent: 4 thetaCore
  int t_per_row;        // t_obs [B] (one time a row) or [T] (shared)
  int T;
  float dist_coef;      // inv_dl26 = (1 / distance) dist_coef
};

__device__ __forceinline__ float slot(const Slots& s, int k, long long b) {
  return s.col[k] ? s.col[k][b * s.stride[k]] : s.val[k];
}

// torch.clamp and torch.maximum: NaN in, NaN out
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return clamp_max(clamp_min(x, lo), hi);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
// torch.clamp(torch.nan_to_num(x, nan=-88, posinf=88, neginf=-88), -88, 88)
__device__ __forceinline__ float track(float x) {
  return x != x ? -88.0f : clamp2(x, -88.0f, 88.0f);
}

// E_iso(theta) / 1e50 erg (models/grb.py:_energy_profile)
__device__ __forceinline__ float energy_profile(int jet, float theta, float e0,
                                                float tc, float tw, float b) {
  if (jet == JET_TOPHAT) return theta <= tc ? e0 : 0.0f;
  const float x = theta / tc;
  if (jet == JET_GAUSSIAN) {
    const float prof = expf(-0.5f * clamp_max(x * x, 80.0f));
    return theta <= tw ? e0 * prof : 0.0f;
  }
  const float prof = powf((x * x) / b + 1.0f, -b * 0.5f);
  return theta <= tw ? e0 * prof : 0.0f;
}

__host__ __device__ inline int subgrid(int R, int sub) {
  return (R + sub - 1) / sub;
}

// shared memory of a block of `rows` rows and `threads` threads, in floats:
// E_i [rows, Th], the row scalars [rows, 4], the radius grids [rows, R] and
// the stage [6, threads, PITCH]
__host__ __device__ inline size_t smem_floats(int rows, int threads, int Th,
                                              int R) {
  return static_cast<size_t>(rows) * (Th + ROW_SCALARS + R) +
         static_cast<size_t>(N_OUT) * threads * PITCH;
}

template <bool INJ, bool SPREAD, bool TRUMPET>
__global__ void __launch_bounds__(MAX_THREADS)
grb_dynamics_kernel(Slots prm, Modes md, const float* __restrict__ t_obs,
                    const float* __restrict__ edge_frac,
                    const float* __restrict__ r_frac,
                    float* __restrict__ t_delay, float* __restrict__ tracks,
                    float* __restrict__ r_out, float* __restrict__ scal,
                    float* __restrict__ d_cos, float* __restrict__ inv_dl26,
                    float* __restrict__ log_q, long long B, int Th, int R,
                    int rows, int sub) {
  extern __shared__ float smem[];
  const int NT = blockDim.x;
  const int Rs = subgrid(R, sub);
  float* s_e = smem;                               // [rows, Th]
  float* s_row = s_e + rows * Th;                  // [rows, ROW_SCALARS]
  float* s_rg = s_row + rows * ROW_SCALARS;        // [rows, R]
  float* s_stage = s_rg + rows * R;                // [N_OUT, NT, PITCH]

  const int t = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * rows;
  const long long left = B - b0;
  const int rows_here = left < rows ? static_cast<int>(left) : rows;
  const int nv = rows_here * Th;                   // threads with a ring
  const bool active = t < nv;
  const int row = active ? t / Th : 0;
  const int ring = active ? t - row * Th : 0;
  const long long b = b0 + row;

  // 1. the row's parameters, the ring and its energy
  float tc = 0.f, n0 = 0.f, p = 0.f, eps_e = 0.f, eps_b = 0.f, xi = 0.f;
  float theta_max = 1.f, theta = 0.f, e_iso = 0.f;
  if (active) {
    tc = slot(prm, S_THETA_CORE, b);
    const float e0 =
        powf(10.0f, clamp2(slot(prm, S_LOG10_E0, b) - 50.0f, -20.0f, 20.0f));
    const float tw =
        md.wing_from_core ? tc * 4.0f : slot(prm, S_THETA_WING, b);
    n0 = powf(10.0f, clamp2(slot(prm, S_LOG10_N0, b), -20.0f, 20.0f));
    p = slot(prm, S_P, b);
    eps_e = powf(10.0f, clamp2(slot(prm, S_LOG10_EPS_E, b), -20.0f, 0.0f));
    eps_b = powf(10.0f, clamp2(slot(prm, S_LOG10_EPS_B, b), -20.0f, 0.0f));
    xi = slot(prm, S_XI_N, b);
    theta_max = md.jet == JET_TOPHAT ? tc : tw;
    const float lo = edge_frac[ring] * theta_max;
    const float hi = edge_frac[ring + 1] * theta_max;
    theta = (hi + lo) * 0.5f;
    d_cos[b * Th + ring] = -(cosf(hi) - cosf(lo));
    e_iso = clamp_min(
        energy_profile(md.jet, theta, e0, tc, tw, slot(prm, S_B, b)), 1e-12f);
    s_e[t] = e_iso;
    if (ring == 0) {
      inv_dl26[b] = (1.0f / slot(prm, S_DISTANCE, b)) * md.dist_coef;
      const float tv = slot(prm, S_THETA_V, b);
      float* sc = scal + b * 8;
      sc[0] = slot(prm, S_Z, b);
      sc[1] = cosf(tv);
      sc[2] = sinf(tv);
      sc[3] = p;
      sc[4] = tv;
      sc[5] = sc[6] = sc[7] = 0.0f;
      float t_max;
      if (md.t_per_row) {
        t_max = t_obs[b];
        log_q[b] = logf(t_max * SECONDS_A_DAY);
      } else {
        t_max = t_obs[0];
        for (int k = 1; k < md.T; ++k) t_max = max_nan(t_max, t_obs[k]);
      }
      s_row[row * ROW_SCALARS] = t_max * SECONDS_A_DAY;
    }
  }
  if (!md.t_per_row && blockIdx.x == 0)
    for (int k = t; k < md.T; k += NT)
      log_q[k] = logf(t_obs[k] * SECONDS_A_DAY);
  __syncthreads();

  // 2. the row's radius grid: from R_dec to past the on-axis reach
  if (active && ring == 0) {
    const float* e = s_e + row * Th;
    float e_ref = e[0];
    for (int k = 1; k < Th; ++k) e_ref = max_nan(e_ref, e[k]);
    const float t_max = s_row[row * ROW_SCALARS];
    const float r_dec = powf((e_ref * K_RDEC) / n0, K_THIRD) * 1e17f;
    const float r17_rel = powf(
        (((e_ref * 16.0f) * K_C) * t_max) / ((n0 * K_MSW) * 1e17f), 0.25f);
    const float r_max = max_nan(K_C * t_max, r17_rel * 1e17f) * 4.0f;
    const float r_min = r_dec * static_cast<float>(1e-3);
    s_row[row * ROW_SCALARS + 1] = r_min;
    s_row[row * ROW_SCALARS + 2] = r_max / r_min;
  }
  __syncthreads();
  for (int i = t; i < rows_here * R; i += NT) {
    const int rr = i / R, r = i - rr * R;
    const float* sr = s_row + rr * ROW_SCALARS;
    const float rg = sr[1] * powf(sr[2], r_frac[r]);
    s_rg[rr * R + r] = rg;
    if (r % sub == 0) r_out[(b0 + rr) * Rs + r / sub] = rg;
  }
  __syncthreads();

  // 3. the ring's constants
  const float* rgrid = s_rg + row * R;
  const float n0_msw = n0 * K_MSW;
  float dlnr = 0.f, om_cos_max = 1.f;
  if (SPREAD && active) {
    dlnr = logf(rgrid[1] / rgrid[0]);
    om_cos_max = 1.0f - cosf(theta_max);
  }
  float l0 = 0.f, ts_inj = 1.f, one_m_q = 0.f, safe = 1.f;
  bool power_ok = false;
  if (INJ && active) {
    const float v = slot(prm, S_L0, b);
    l0 = md.inj == INJ_LOG10 ? powf(10.0f, v - 50.0f)
       : md.inj == INJ_RAW ? (v * 1e-25f) * 1e-25f : v;
    ts_inj = clamp_min(slot(prm, S_TS, b), 1.0f);
    one_m_q = 1.0f - slot(prm, S_Q, b);
    power_ok = fabsf(one_m_q) > static_cast<float>(1e-3);
    safe = power_ok ? one_m_q : 1.0f;
  }
  const float eps_b32 = eps_b * K_32PI;
  const float gm_row = ((eps_e * (p - 2.0f)) / (p - 1.0f)) * K_MP_ME;
  const float em_row = (((p - 1.0f) * K_EM_C) * xi) * n0;
  const float log_theta = logf(clamp_min(theta, 1e-6f));

  // 4. the walk along r, CHUNK subgrid radii at a time
  float rg_prev = 0.f, r3_prev = 0.f;
  float head_a = 0.f, acc_a = 0.f, ig_a_prev = 0.f;    // t_b of the swept mass
  float acc_d = 0.f, ig_d_prev = 0.f;                  // dtheta
  float head_m = 0.f, acc_m = 0.f, sf_prev = 0.f;      // trumpet's mass
  float head_b = 0.f, acc_b = 0.f, ibc_prev = 0.f;     // t_b
  float head_t = 0.f, acc_t = 0.f, itd_prev = 0.f;     // t_delay
  float* stage = s_stage + t * PITCH;
  const int stage_stride = NT * PITCH;
  int r = 0;
  for (int js0 = 0; js0 < Rs; js0 += CHUNK) {
    const int jn = Rs - js0 < CHUNK ? Rs - js0 : CHUNK;
    if (active) {
      const int r_end = (js0 + jn - 1) * sub;
      for (; r <= r_end; ++r) {
        const float rg = rgrid[r];
        const float r17 = rg * 1e-17f;
        const float r3 = (r17 * r17) * r17;
        const float msw = n0_msw * r3;
        const float dr = rg - rg_prev;
        float e_inj = 0.f, mass_factor = 1.f, sf = 1.f;
        float theta_dyn = theta;
        if (INJ || SPREAD) {
          const float u2a = clamp_max(e_iso / msw, 1e8f);
          const float gamma_a = sqrtf(u2a + 1.0f);
          const float beta_a = sqrtf(u2a / (u2a + 1.0f));
          if (INJ) {
            const float ig = 1.0f / (beta_a * K_C);
            float tba;
            if (r == 0) {
              head_a = rg * ig;
              tba = head_a;
            } else {
              acc_a = acc_a + ((ig + ig_a_prev) * 0.5f) * dr;
              tba = head_a + acc_a;
            }
            ig_a_prev = ig;
            const float ratio = clamp_min(tba / ts_inj, 1.0f);
            const float integral = power_ok
                ? (powf(ratio, one_m_q) - 1.0f) / safe : logf(ratio);
            const float e = (l0 * ts_inj) * integral;
            e_inj = clamp_min(md.inj == INJ_CONST || l0 > 0.0f ? e : 0.0f,
                              0.0f);
          }
          if (SPREAD) {
            const float gm1 = gamma_a - 1.0f;
            const float ghat = (gamma_a * 4.0f + 1.0f) / (gamma_a * 3.0f);
            const float cs2 =
                ((ghat * (ghat - 1.0f)) * gm1) / (ghat * gm1 + 1.0f);
            const float cs = sqrtf(clamp2(cs2, 0.0f, K_THIRD));
            const float ig = gamma_a * tc < 1.0f
                ? cs / clamp_min(gamma_a * beta_a, 1e-6f) : 0.0f;
            float dtheta = 0.0f;
            if (r > 0) {
              acc_d = acc_d + (ig + ig_d_prev) * 0.5f;
              dtheta = acc_d * dlnr;
            }
            ig_d_prev = ig;
            const float edge = clamp_max(theta_max + dtheta, K_HALF_PI);
            if (TRUMPET) {
              sf = (1.0f - cosf(edge)) / om_cos_max;
              theta_dyn = theta * (edge / theta_max);
              float integ;
              if (r == 0) {
                head_m = sf * r3;
                integ = head_m;
              } else {
                acc_m = acc_m + ((sf + sf_prev) * 0.5f) * (r3 - r3_prev);
                integ = acc_m + head_m;
              }
              sf_prev = sf;
              mass_factor = integ / r3;
            } else {
              const float q = edge / theta_max;
              mass_factor = q * q;
            }
          }
        }
        // the blast wave with the injected energy and the swept mass
        const float num = INJ ? e_iso + e_inj : e_iso;
        const float den = SPREAD ? msw * mass_factor : msw;
        const float u2 = clamp_max(num / den, 1e8f);
        const float gamma = sqrtf(u2 + 1.0f);
        const float s_sh = sqrtf(1.0f / clamp_min(u2, 1e-12f) + 1.0f);
        const float omb = (3.0f - (1.0f / (s_sh + 1.0f)) * 4.0f)
                          / (u2 * 4.0f + 3.0f);
        const float beta_sh = clamp2(1.0f - omb, 1e-6f, 1.0f);
        const float ibc = 1.0f / (beta_sh * K_C);
        const float itd = omb * ibc;
        float t_b, t_d;
        if (r == 0) {
          head_b = rg * ibc;
          head_t = rg * itd;
          t_b = head_b;
          t_d = head_t;
        } else {
          acc_b = acc_b + ((ibc + ibc_prev) * 0.5f) * dr;
          acc_t = acc_t + ((itd + itd_prev) * 0.5f) * dr;
          t_b = head_b + acc_b;
          t_d = head_t + acc_t;
        }
        ibc_prev = ibc;
        itd_prev = itd;
        rg_prev = rg;
        r3_prev = r3;
        if (r % sub == 0) {
          // the synchrotron quantities on the subgrid
          const float gm1 = gamma - 1.0f;
          const float bf =
              sqrtf(((((eps_b32 * gamma) * (gm1 + 1e-12f)) * n0) * K_MP)) *
              K_C;
          const float g_m = clamp_min((gm_row * gm1) / xi, 1.0f);
          const float g_c = (gamma * K_6PI_ME_C) /
                            (((bf * bf) * K_SIGMA_T) * t_b + 1e-30f);
          const float nu_m = (((g_m * g_m) * K_3_4PI) * K_QE * bf) *
                             K_INV_ME_C;
          const float nu_c = (((g_c * g_c) * K_3_4PI) * K_QE * bf) *
                             K_INV_ME_C;
          float em = (((em_row * bf) * K_EM_SCALE) * r3) / gamma;
          if (TRUMPET) em = em * mass_factor;
          const int j = r / sub - js0;
          stage[j] = t_d;
          stage[stage_stride + j] = track(logf(gamma));
          stage[2 * stage_stride + j] = track(logf(clamp_min(nu_m, 1e-30f)));
          stage[3 * stage_stride + j] = track(logf(clamp_min(nu_c, 1e-30f)));
          stage[4 * stage_stride + j] =
              track(logf(clamp_min(em, K_EM_FLOOR)));
          stage[5 * stage_stride + j] = track(
              TRUMPET ? logf(clamp_min(theta_dyn, 1e-6f)) : log_theta);
        }
      }
    }
    __syncthreads();
    // the chunk leaves with consecutive threads on consecutive radii
    const long long plane = static_cast<long long>(Th) * Rs;
    for (int e = t; e < nv * CHUNK; e += NT) {
      const int lr = e / CHUNK, j = e - lr * CHUNK;
      if (j >= jn) continue;
      const int lrow = lr / Th;
      const long long ring_g = b0 * Th + lr;
      const float* st = s_stage + lr * PITCH + j;
      t_delay[ring_g * Rs + js0 + j] = st[0];
      float* out = tracks + (ring_g + (b0 + lrow) * 4 * Th) * Rs + js0 + j;
      for (int k = 0; k < 5; ++k) out[k * plane] = st[(k + 1) * stage_stride];
    }
    __syncthreads();
  }
}

// rows a block takes: the most with rows x Th <= ROW_THREADS threads (or one
// row of up to 256 rings) and a whole number of warps, else the most that
// fit, then fewer while shared memory exceeds 96 KB (several blocks an SM);
// 0 if none fits
__host__ inline int block_rows(long long B, int Th, int R) {
  const int most = Th <= ROW_THREADS ? ROW_THREADS / Th : MAX_THREADS / Th;
  int rows = 0;
  for (int k = most; k >= 1; --k)
    if ((k * Th) % 32 == 0) { rows = k; break; }
  if (rows == 0) rows = most;
  if (B > 0 && rows > B) rows = static_cast<int>(B);
  while (rows > 1 &&
         sizeof(float) * smem_floats(rows, (rows * Th + 31) / 32 * 32, Th, R) >
             96 * 1024)
    --rows;
  if (rows < 1 ||
      sizeof(float) * smem_floats(rows, (rows * Th + 31) / 32 * 32, Th, R) >
          SMEM_LIMIT)
    return 0;
  return rows;
}

template <bool INJ, bool SPREAD, bool TRUMPET>
cudaError_t launch(const Slots& prm, const Modes& md, const float* t_obs,
                   const float* edge_frac, const float* r_frac,
                   float* t_delay, float* tracks, float* r_grid, float* scal,
                   float* d_cos, float* inv_dl26, float* log_q, long long B,
                   int Th, int R, int sub, cudaStream_t stream) {
  const int rows = block_rows(B, Th, R);
  const int threads = (rows * Th + 31) / 32 * 32;
  const size_t smem = sizeof(float) * smem_floats(rows, threads, Th, R);
  const cudaError_t attr = cudaFuncSetAttribute(
      grb_dynamics_kernel<INJ, SPREAD, TRUMPET>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const long long blocks = (B + rows - 1) / rows;
  grb_dynamics_kernel<INJ, SPREAD, TRUMPET>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
          prm, md, t_obs, edge_frac, r_frac, t_delay, tracks, r_grid, scal,
          d_cos, inv_dl26, log_q, B, Th, R, rows, sub);
  return cudaGetLastError();
}

}  // namespace

// 1 if the kernel is built for these shapes and switches: 1 <= Th <= 256,
// 2 <= R <= 4096, T >= 1 shared times (t_per_row 0) or one time a row
// (t_per_row 1), a jet type of models/grb.py, an injection form 0-3, and a
// block that fits in shared memory; else 0. The wrapper asks before a launch.
extern "C" int nmma_grb_dynamics_supported(long long B, int Th, int R, int T,
                                           int t_per_row, int jet, int inj) {
  return B >= 0 && Th >= 1 && Th <= MAX_TH && R >= 2 && R <= MAX_R &&
         T >= 1 && (t_per_row == 0 || t_per_row == 1) &&
         (jet == JET_TOPHAT || jet == JET_GAUSSIAN || jet == JET_POWERLAW) &&
         inj >= INJ_NONE && inj <= INJ_CONST &&
         B <= 0x7fffffffLL && block_rows(B, Th, R) > 0;
}

// Plain C entry point for ctypes. cols, strides and vals are host arrays of
// N_SLOTS: a device pointer to an f32 column read at b * stride, or null for
// the constant vals[k]. Device pointers to contiguous f32 arrays: t_obs [T]
// or [B] (days), edge_frac [Th + 1] and r_frac [R] (the ring edges'
// fractions of theta_max and the radius grid's exponents); outputs t_delay
// [B, Th, R'] (s), tracks [B, 5, Th, R'], r_grid [B, R'] (cm), scal [B, 8],
// d_cos [B, Th], inv_dl26 [B], log_q [T] or [B] (ln s), with R' = R on a
// grid of R < 256 and ceil(R / 2) from 256 on; all on CUDA device `device`,
// the launch on `stream`. Shapes or switches that
// nmma_grb_dynamics_supported refuses return cudaErrorInvalidValue. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int nmma_grb_dynamics(
    const void* const* cols, const long long* strides, const float* vals,
    const void* t_obs, const void* edge_frac, const void* r_frac,
    void* t_delay, void* tracks, void* r_grid, void* scal, void* d_cos,
    void* inv_dl26, void* log_q, long long B, int Th, int R, int T,
    int t_per_row, int jet, int spread, int trumpet, int inj,
    int wing_from_core, float dist_coef, int device, void* stream) {
  if (!nmma_grb_dynamics_supported(B, Th, R, T, t_per_row, jet, inj))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Slots prm;
  for (int k = 0; k < N_SLOTS; ++k) {
    prm.col[k] = static_cast<const float*>(cols[k]);
    prm.stride[k] = strides[k];
    prm.val[k] = vals[k];
  }
  const Modes md{jet, inj, wing_from_core, t_per_row, T, dist_coef};
  const int sub = R >= 256 ? 2 : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool with_inj = inj != INJ_NONE;
  const bool with_trumpet = spread && trumpet;
  auto go = [&](auto kernel_launch) {
    return kernel_launch(prm, md, static_cast<const float*>(t_obs),
                         static_cast<const float*>(edge_frac),
                         static_cast<const float*>(r_frac),
                         static_cast<float*>(t_delay),
                         static_cast<float*>(tracks),
                         static_cast<float*>(r_grid),
                         static_cast<float*>(scal),
                         static_cast<float*>(d_cos),
                         static_cast<float*>(inv_dl26),
                         static_cast<float*>(log_q), B, Th, R, sub, st);
  };
  cudaError_t err;
  if (with_inj) {
    err = !spread ? go(launch<true, false, false>)
        : with_trumpet ? go(launch<true, true, true>)
                       : go(launch<true, true, false>);
  } else {
    err = !spread ? go(launch<false, false, false>)
        : with_trumpet ? go(launch<false, true, true>)
                       : go(launch<false, true, false>);
  }
  return static_cast<int>(err);
}

extern "C" const char* nmma_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
