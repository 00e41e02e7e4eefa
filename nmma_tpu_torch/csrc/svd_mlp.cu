// K1: batched SVD-surrogate magnitudes on Hopper (sm_90a), IEEE f32.
//
// Replaces the Pallas TPU kernel `_svd_eval_kernel` (nmma_tpu/ops/pallas_svd.py:37,
// called through `svd_surrogate_mags_pallas`). For every live point b and filter f:
//
//     hid  = relu(x[b] . W1[f] + b1[f])      [H]   (never leaves the SM)
//     c    = hid . W2[f] + b2[f]             [C]
//     mags = c . VAq[f] + off[f]             [Q]   -> out[b, f, :]
//
// Bound: per eval 2 F (P H + H C + C Q) FLOP = 543,096 at the production
// dims (P=4, H=2048, C=10, Q=150, F=9), i.e. 4.45 GFLOP at B=8192, against
// ~0.9 MB of weights and 44 MB of output. At the H100 SXM's 67 TFLOP/s of f32
// outside the tensor cores and 3.35 TB/s that is 66 us of arithmetic against
// 13 us of memory: the kernel is bound by f32 FMAs, so the design keeps the
// hidden activations out of memory and feeds the FMAs from shared memory.
//
// Design: one block per (tile of TILE_B live points, filter). Thread t owns
// live point t % TILE_B and one of SPLITS slices of the hidden dimension, so
// all lanes of a warp read the same shared-memory word at a time (a
// broadcast). H is walked in chunks of HC hidden units; each chunk's
// [W1 column, b1, W2 row] is staged in shared memory as one record per unit
// (16 floats at P=4) and read back as float4s. The partial c of the slices
// is summed in shared memory, then the block writes c . VAq + off for all Q,
// masking the ragged batch edge. Plain FMAs only: no TF32, no tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_B = 64;
constexpr int SPLITS = 4;
constexpr int THREADS = TILE_B * SPLITS;  // 256
constexpr int HC = THREADS;               // hidden units staged per chunk
constexpr int H_PER_SPLIT = HC / SPLITS;

template <int P, int C>
__global__ void __launch_bounds__(THREADS)
svd_mlp_mags_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ vaq,
                    const float* __restrict__ off, float* __restrict__ out,
                    int B, int H, int Q, int F) {
  // one record per hidden unit: W1[:, h] (P), b1[h] (1), W2[h, :] (C), zero pad
  constexpr int S = (P + 1 + C + 3) / 4 * 4;
  __shared__ __align__(16) float wbuf[HC * S];
  __shared__ float cpart[SPLITS][TILE_B][C];
  __shared__ float cfin[TILE_B][C + 1];

  const int f = blockIdx.y;
  const int b0 = blockIdx.x * TILE_B;
  const int tid = threadIdx.x;
  const int row = tid % TILE_B;
  const int split = tid / TILE_B;
  const int b = b0 + row;

  float xr[P];
#pragma unroll
  for (int p = 0; p < P; ++p) xr[p] = (b < B) ? x[(size_t)b * P + p] : 0.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  const float* w1f = w1 + (size_t)f * P * H;
  const float* b1f = b1 + (size_t)f * H;
  const float* w2f = w2 + (size_t)f * H * C;

  for (int h0 = 0; h0 < H; h0 += HC) {
    __syncthreads();  // the previous chunk has been consumed
    {
      const int h = h0 + tid;
      const bool ok = h < H;
      float* rec = wbuf + tid * S;
#pragma unroll
      for (int p = 0; p < P; ++p) rec[p] = ok ? w1f[(size_t)p * H + h] : 0.f;
      rec[P] = ok ? b1f[h] : 0.f;
#pragma unroll
      for (int k = P + 1 + C; k < S; ++k) rec[k] = 0.f;
    }
    // the chunk's W2 rows are HC * C contiguous floats in global memory
    for (int j = tid; j < HC * C; j += THREADS) {
      const int hl = j / C;
      const int c = j - hl * C;
      const int h = h0 + hl;
      wbuf[hl * S + P + 1 + c] = (h < H) ? w2f[(size_t)h * C + c] : 0.f;
    }
    __syncthreads();

    // two-level sum: a chunk's H_PER_SPLIT terms, then the chunk sums; a
    // single running sum over all H/SPLITS terms doubled the f32 error
    float part[C];
#pragma unroll
    for (int c = 0; c < C; ++c) part[c] = 0.f;
    const float* base = wbuf + split * H_PER_SPLIT * S;
#pragma unroll 4
    for (int k = 0; k < H_PER_SPLIT; ++k) {
      float wv[S];
      const float4* src = reinterpret_cast<const float4*>(base + k * S);
#pragma unroll
      for (int v = 0; v < S / 4; ++v) {
        const float4 t = src[v];
        wv[4 * v] = t.x;
        wv[4 * v + 1] = t.y;
        wv[4 * v + 2] = t.z;
        wv[4 * v + 3] = t.w;
      }
      float hid = wv[P];
#pragma unroll
      for (int p = 0; p < P; ++p) hid = fmaf(xr[p], wv[p], hid);
      hid = fmaxf(hid, 0.f);
#pragma unroll
      for (int c = 0; c < C; ++c) part[c] = fmaf(hid, wv[P + 1 + c], part[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += part[c];
  }

#pragma unroll
  for (int c = 0; c < C; ++c) cpart[split][row][c] = acc[c];
  __syncthreads();
  for (int j = tid; j < TILE_B * C; j += THREADS) {
    const int r = j / C;
    const int c = j - r * C;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < SPLITS; ++q) s += cpart[q][r][c];
    cfin[r][c] = s + b2[f * C + c];
  }
  __syncthreads();

  const float* vaqf = vaq + (size_t)f * C * Q;
  const float* offf = off + (size_t)f * Q;
  const int rows = min(TILE_B, B - b0);
  for (int j = tid; j < rows * Q; j += THREADS) {
    const int r = j / Q;
    const int q = j - r * Q;
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) m = fmaf(cfin[r][c], __ldg(vaqf + c * Q + q), m);
    out[((size_t)(b0 + r) * F + f) * Q + q] = m + __ldg(offf + q);
  }
}

template <int P, int C>
void launch(const float* x, const float* w1, const float* b1, const float* w2,
            const float* b2, const float* vaq, const float* off, float* out,
            int B, int H, int Q, int F, cudaStream_t stream) {
  const dim3 grid((B + TILE_B - 1) / TILE_B, F);
  svd_mlp_mags_kernel<P, C><<<grid, THREADS, 0, stream>>>(
      x, w1, b1, w2, b2, vaq, off, out, B, H, Q, F);
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to contiguous
// f32 arrays: x [B,P], w1 [F,P,H], b1 [F,H], w2 [F,H,C], b2 [F,C],
// vaq [F,C,Q], off [F,Q], out [B,F,Q], all on CUDA device `device`; the
// launch goes to `stream`. Built for the surrogate's P == 4 and C == 10.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nmma_svd_mlp_mags(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2,
                                 const void* vaq, const void* off, void* out,
                                 int B, int P, int H, int C, int Q, int F,
                                 int device, void* stream) {
  if (B <= 0) return 0;
  // this library has its own runtime state: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (P != 4 || C != 10 || H <= 0 || Q <= 0 || F <= 0 || F > 65535) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  const float* vaqf = static_cast<const float*>(vaq);
  const float* offf = static_cast<const float*>(off);
  float* outf = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch<4, 10>(xf, w1f, b1f, w2f, b2f, vaqf, offf, outf, B, H, Q, F, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nmma_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
