// K1: batched SVD-surrogate magnitudes on Hopper (sm_90a), IEEE f32.
//
// Replaces the Pallas TPU kernel `_svd_eval_kernel` (nmma_tpu/ops/pallas_svd.py:37,
// called through `svd_surrogate_mags_pallas`). For every live point b and filter f:
//
//     hid  = relu(x[b] . W1[f] + b1[f])      [H]   (never leaves the SM)
//     c    = hid . W2[f] + b2[f]             [C]
//     mags = c . VAq[f] + off[f]             [Q]   -> out[b, f, :]
//
// Two specialised instantiations serve the surrogates of the main paths:
// P=4 (the production Bu2019lm, H=2048) and P=2 (the sparse Bu2019lm of the
// joint GW+EM+EOS path, H=128), both with C=10; P is a template parameter.
// Every other shape a trained surrogate can have (P from 1 to 16, any C: the
// other grid families and other --svd-ncoeff) takes the general kernel at
// the end of this file, which is right for all of them but not tuned.
//
// Bound: per eval 2 F (P H + H C + C Q) FLOP = 543,096 at the production
// dims (P=4, H=2048, C=10, Q=150, F=9), i.e. 4.45 GFLOP at B=8192, against
// ~0.9 MB of weights and 44 MB of output. At the H100 SXM's 67 TFLOP/s of f32
// outside the tensor cores and 3.35 TB/s that is 66 us of arithmetic against
// 13 us of memory: the kernel is bound by f32 FMAs, so the design keeps the
// hidden activations out of memory and spends as few instructions as it can
// on anything but FMAs. Plain FMAs only: no TF32, no tensor cores.
//
// Design: one block of 8 warps per (tile of NB live points, filter). The
// warps split H: warp w takes the 32-unit chunks w, w+8, w+16, ... of the
// filter. Where H has fewer than 8 chunks (H=128: four), the warps past the
// last chunk stage nothing and keep zero partial sums, which the fixed
// reduction below adds in their place: x + 0 is x, so the order of the
// other warps' sums is unchanged. Each chunk's [W2 row, W1 column, b1] records (16 floats a unit) are
// copied by the warp's lanes, one unit each, into the warp's own pair of
// shared-memory buffers with cp.async, the next chunk in flight while the
// warp computes on this one, so no block-wide barrier sits in the loop.
// Register blocking: a thread carries R live points, so one record, read as
// four float4 broadcasts, feeds R x 15 FMAs/maxes (90 at R = 6, where one
// block's two-level sums, inputs and a record take ~180 registers a thread).
// Lanes run over LP live points and 32/LP sub-slices of each chunk; NB = LP x
// R. The launcher takes (R, LP) = (6, 32) where that grid covers three
// quarters of the SMs (B = 8192: 43 x 9 = 387 blocks, one an SM, 2.9 waves),
// else (1, 16), so the samplers' B = 128 launches 8 x 9 = 72 blocks. (On the
// card a 144-block grid of 8 live points a block ran slower: each block
// restages the whole filter for fewer points, and its loads serve four
// addresses.) The loop is bound by the rate of its FMA stream, not by the
// loads: with the record loads taken out it ran only slightly faster
// (PERF.md). The sums are two level: a chunk's terms, then the chunk sums (one
// running sum over all of a slice's terms doubled the f32 error); then the
// sub-slices by a shuffle tree, the warps in order in shared memory, and b2.
// Layer 3 reads VAq[f] and off[f] once per block: a thread keeps the column of
// its output time q in registers and writes out[b, f, q] for the tile's rows,
// coalesced over q.
#include <cuda_runtime.h>

namespace {

constexpr int C = 10;                     // SVD coefficients
constexpr int REC = 16;                   // [W2 row (C), W1 column (P), b1, 0...]
constexpr int CP = 12;                    // C padded for float4 reads
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 32;                 // hidden units per staged chunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // a source size of 0 fills the word with zeros and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// blocks an SM the register file must hold: R = 6 takes ~180 registers
template <int P, int R, int LP>
__global__ void __launch_bounds__(THREADS, R > 1 ? 1 : 3)
svd_mlp_mags_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ vaq,
                    const float* __restrict__ off, float* __restrict__ out,
                    int B, int H, int Q, int F) {
  static_assert(C + P + 1 <= REC, "a hidden unit's record is 16 floats");
  constexpr int SUB = 32 / LP;            // sub-slices of a chunk in a warp
  constexpr int NB = LP * R;              // live points of the block
  constexpr int KS = CHUNK / SUB;         // units of a chunk per sub-slice
  // the warps' staging buffers, then (after the loop) their partial sums
  extern __shared__ __align__(16) float smem[];

  const int f = blockIdx.y;
  const int b0 = blockIdx.x * NB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pl = lane % LP;
  const int sub = lane / LP;

  float xr[R][P];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + pl + LP * r;
#pragma unroll
    for (int p = 0; p < P; ++p) xr[r][p] = (b < B) ? x[(size_t)b * P + p] : 0.f;
  }
  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;

  const float* w1f = w1 + (size_t)f * P * H;
  const float* b1f = b1 + (size_t)f * H;
  const float* w2f = w2 + (size_t)f * H * C;
  float* stage = smem + warp * 2 * CHUNK * REC;
  stage[lane * REC + REC - 1] = 0.f;
  stage[(CHUNK + lane) * REC + REC - 1] = 0.f;
  // lane l copies unit l of the chunk (units past H are zeros: they add 0)
  auto fetch = [&](int chunk, float* buf) {
    const int h = chunk * CHUNK + lane;
    const bool ok = h < H;
    float* rec = buf + lane * REC;
    const float* src = w2f + (ok ? (size_t)h * C : 0);
#pragma unroll
    for (int c = 0; c < C; ++c) cp_async4(rec + c, src + c, ok);
#pragma unroll
    for (int p = 0; p < P; ++p) cp_async4(rec + C + p, w1f + (size_t)p * H + (ok ? h : 0), ok);
    cp_async4(rec + C + P, b1f + (ok ? h : 0), ok);
  };

  const int n_chunks = (H + CHUNK - 1) / CHUNK;
  int buf = 0;
  if (warp < n_chunks) fetch(warp, stage);
  cp_async_commit();
  for (int ch = warp; ch < n_chunks; ch += WARPS) {
    if (ch + WARPS < n_chunks) fetch(ch + WARPS, stage + (buf ^ 1) * CHUNK * REC);
    cp_async_commit();
    cp_async_wait_one();
    __syncwarp();

    float part[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) part[r][c] = 0.f;
    const float* base = stage + buf * CHUNK * REC + sub * KS * REC;
#pragma unroll 4
    for (int k = 0; k < KS; ++k) {
      const float4* src = reinterpret_cast<const float4*>(base + k * REC);
      const float4 v0 = src[0], v1 = src[1], v2 = src[2], v3 = src[3];
      const float rec[REC] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
                              v2.x, v2.y, v2.z, v2.w, v3.x, v3.y, v3.z, v3.w};
      float wo[C], wi[P];
#pragma unroll
      for (int c = 0; c < C; ++c) wo[c] = rec[c];
#pragma unroll
      for (int p = 0; p < P; ++p) wi[p] = rec[C + p];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float hid = rec[C + P];
#pragma unroll
        for (int p = 0; p < P; ++p) hid = fmaf(xr[r][p], wi[p], hid);
        hid = fmaxf(hid, 0.f);
#pragma unroll
        for (int c = 0; c < C; ++c) part[r][c] = fmaf(hid, wo[c], part[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] += part[r][c];
    __syncwarp();  // every lane is done with this buffer before it is refilled
    buf ^= 1;
  }

  // the sub-slices of a warp, by a shuffle tree
#pragma unroll
  for (int o = LP; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] += __shfl_xor_sync(FULL, acc[r][c], o);
  __syncthreads();  // every warp is done with its staging buffers
  float* red = smem;  // [WARPS][NB][CP]
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) red[(warp * NB + pl + LP * r) * CP + c] = acc[r][c];
  }
  __syncthreads();
  // the warps in order, then b2: c of tile row r lands in red[r]
  for (int j = threadIdx.x; j < NB * C; j += THREADS) {
    const int r = j / C;
    const int c = j - r * C;
    float s = red[r * CP + c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[(w * NB + r) * CP + c];
    red[r * CP + c] = s + b2[f * C + c];
  }
  __syncthreads();

  const int rows = min(NB, B - b0);
  const float* vaqf = vaq + (size_t)f * C * Q;
  const float* offf = off + (size_t)f * Q;
  for (int q = threadIdx.x; q < Q; q += THREADS) {
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(vaqf + c * Q + q);
    const float o = __ldg(offf + q);
    float* dst = out + ((size_t)b0 * F + f) * Q + q;
    for (int r = 0; r < rows; ++r) {
      const float4* cr = reinterpret_cast<const float4*>(red + r * CP);
      const float4 a0 = cr[0], a1 = cr[1], a2 = cr[2];
      const float cv[C] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y};
      float m = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) m = fmaf(cv[c], v[c], m);
      dst[(size_t)r * F * Q] = m + o;
    }
  }
}

// shared memory of a block: the warps' staging buffers, then (in the same
// words) their partial sums [WARPS][NB][CP]
template <int R, int LP>
constexpr int smem_bytes() {
  constexpr int stage = WARPS * 2 * CHUNK * REC;
  constexpr int red = WARPS * LP * R * CP;
  return 4 * (stage > red ? stage : red);
}

template <int P, int R, int LP>
cudaError_t launch(const float* x, const float* w1, const float* b1, const float* w2,
            const float* b2, const float* vaq, const float* off, float* out,
            int B, int H, int Q, int F, cudaStream_t stream) {
  const dim3 grid((B + LP * R - 1) / (LP * R), F);
  constexpr int smem = smem_bytes<R, LP>();
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        svd_mlp_mags_kernel<P, R, LP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
  }
  svd_mlp_mags_kernel<P, R, LP><<<grid, THREADS, smem, stream>>>(
      x, w1, b1, w2, b2, vaq, off, out, B, H, Q, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// General path: any P in [1, MAX_P], any C >= 1, any H, Q.
//
// One thread per live point, GT live points a block, one block per (tile,
// filter). The filter's weights are staged in tiles of HT hidden units into
// shared memory, zero-padded to PM inputs and CC coefficients, and every
// thread reads the same word (a broadcast). C is taken in chunks of CC
// coefficients: each chunk recomputes the hidden activations (cheap next to
// the loads at the usual C <= 16) and adds its share of layer 3 to out, the
// first chunk writing and the last adding off. Padded units and inputs are
// zeros and add nothing.
constexpr int MAX_P = 16;
constexpr int GT = 128;                   // live points (threads) a block
constexpr int HT = 64;                    // hidden units a staged tile

template <int PM, int CC>
__global__ void __launch_bounds__(GT)
svd_mlp_general_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ vaq,
                       const float* __restrict__ off, float* __restrict__ out,
                       int B, int P, int H, int C_, int Q, int F) {
  __shared__ float sw1[PM][HT];
  __shared__ float sb1[HT];
  __shared__ float sw2[HT][CC];
  __shared__ float coef[GT][CC + 1];

  const int f = blockIdx.y;
  const int b0 = blockIdx.x * GT;
  const int tid = threadIdx.x;
  const int b = b0 + tid;
  float xr[PM];
#pragma unroll
  for (int p = 0; p < PM; ++p) xr[p] = (b < B && p < P) ? x[(size_t)b * P + p] : 0.f;

  const float* w1f = w1 + (size_t)f * P * H;
  const float* b1f = b1 + (size_t)f * H;
  const float* w2f = w2 + (size_t)f * H * C_;
  const float* vaqf = vaq + (size_t)f * C_ * Q;
  const float* offf = off + (size_t)f * Q;
  const int rows = min(GT, B - b0);

  for (int c0 = 0; c0 < C_; c0 += CC) {
    const int nc = min(CC, C_ - c0);
    float acc[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[c] = 0.f;
    for (int h0 = 0; h0 < H; h0 += HT) {
      __syncthreads();  // the previous tile is consumed
      for (int i = tid; i < PM * HT; i += GT) {
        const int p = i / HT, hh = i - p * HT, h = h0 + hh;
        sw1[p][hh] = (p < P && h < H) ? w1f[(size_t)p * H + h] : 0.f;
      }
      for (int hh = tid; hh < HT; hh += GT) sb1[hh] = (h0 + hh < H) ? b1f[h0 + hh] : 0.f;
      for (int i = tid; i < HT * CC; i += GT) {
        const int hh = i / CC, c = i - hh * CC, h = h0 + hh;
        sw2[hh][c] = (h < H && c < nc) ? w2f[(size_t)h * C_ + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int hh = 0; hh < HT; ++hh) {
        float hid = sb1[hh];
#pragma unroll
        for (int p = 0; p < PM; ++p) hid = fmaf(xr[p], sw1[p][hh], hid);
        hid = fmaxf(hid, 0.f);
#pragma unroll
        for (int c = 0; c < CC; ++c) acc[c] = fmaf(hid, sw2[hh][c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CC; ++c) coef[tid][c] = (c < nc) ? acc[c] + b2[f * C_ + c0 + c] : 0.f;
    __syncthreads();
    const bool last = c0 + CC >= C_;
    for (int q = tid; q < Q; q += GT) {
      float v[CC];
#pragma unroll
      for (int c = 0; c < CC; ++c) v[c] = (c < nc) ? __ldg(vaqf + (size_t)(c0 + c) * Q + q) : 0.f;
      const float o = __ldg(offf + q);
      float* dst = out + ((size_t)b0 * F + f) * Q + q;
      for (int r = 0; r < rows; ++r) {
        float m = 0.f;
#pragma unroll
        for (int c = 0; c < CC; ++c) m = fmaf(coef[r][c], v[c], m);
        if (c0 > 0) m += dst[(size_t)r * F * Q];
        dst[(size_t)r * F * Q] = last ? m + o : m;
      }
    }
    __syncthreads();  // coef is rewritten by the next chunk
  }
}

template <int PM, int CC>
cudaError_t launch_general(const float* x, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* vaq,
                           const float* off, float* out, int B, int P, int H,
                           int C_, int Q, int F, cudaStream_t stream) {
  const dim3 grid((B + GT - 1) / GT, F);
  svd_mlp_general_kernel<PM, CC><<<grid, GT, 0, stream>>>(
      x, w1, b1, w2, b2, vaq, off, out, B, P, H, C_, Q, F);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to contiguous
// f32 arrays: x [B,P], w1 [F,P,H], b1 [F,H], w2 [F,H,C], b2 [F,C],
// vaq [F,C,Q], off [F,Q], out [B,F,Q], all on CUDA device `device`; the
// launch goes to `stream`. (P, C) = (4, 10) and (2, 10) take the specialised
// kernel, every other P in [1, 16] and C >= 1 the general one.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nmma_svd_mlp_mags(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2,
                                 const void* vaq, const void* off, void* out,
                                 int B, int P_, int H, int C_, int Q, int F,
                                 int device, void* stream) {
  if (B <= 0) return 0;
  // this library has its own runtime state: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (P_ < 1 || P_ > MAX_P || C_ < 1 || H <= 0 || Q <= 0 || F <= 0 || F > 65535) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  const float* vaqf = static_cast<const float*>(vaq);
  const float* offf = static_cast<const float*>(off);
  float* outf = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((P_ != 4 && P_ != 2) || C_ != C) {
    if (P_ <= 8)
      return static_cast<int>(C_ <= 8
          ? launch_general<8, 8>(xf, w1f, b1f, w2f, b2f, vaqf, offf, outf, B, P_, H, C_, Q, F, s)
          : launch_general<8, 16>(xf, w1f, b1f, w2f, b2f, vaqf, offf, outf, B, P_, H, C_, Q, F, s));
    return static_cast<int>(C_ <= 8
        ? launch_general<16, 8>(xf, w1f, b1f, w2f, b2f, vaqf, offf, outf, B, P_, H, C_, Q, F, s)
        : launch_general<16, 16>(xf, w1f, b1f, w2f, b2f, vaqf, offf, outf, B, P_, H, C_, Q, F, s));
  }
  int sms = 0;
  const cudaError_t got = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (got != cudaSuccess) return static_cast<int>(got);
  // 192 live points a block where that grid covers three quarters of the
  // SMs (B >= 1921 at F = 9), else 16 (B = 128: 72 blocks)
  const auto fills = [&](int nb) { return 4LL * ((B + nb - 1) / nb) * F >= 3LL * sms; };
  const bool big = fills(192);
  cudaError_t err;
  if (P_ == 4)
    err = big ? launch<4, 6, 32>(xf, w1f, b1f, w2f, b2f, vaqf, offf, outf, B, H, Q, F, s)
              : launch<4, 1, 16>(xf, w1f, b1f, w2f, b2f, vaqf, offf, outf, B, H, Q, F, s);
  else
    err = big ? launch<2, 6, 32>(xf, w1f, b1f, w2f, b2f, vaqf, offf, outf, B, H, Q, F, s)
              : launch<2, 1, 16>(xf, w1f, b1f, w2f, b2f, vaqf, offf, outf, B, H, Q, F, s);
  return static_cast<int>(err);
}

extern "C" const char* nmma_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
