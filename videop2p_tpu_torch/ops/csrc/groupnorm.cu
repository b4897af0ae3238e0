// GroupNorm (+ optional SiLU) for Hopper (sm_90a) over x of shape
// (N, rows, C), channels last.
//
// Replaces the TPU kernel videop2p_tpu/ops/groupnorm.py:
// fused_group_norm -> _fused_gn -> _gn_kernel (pl.pallas_call).
//
//   mean, var over (rows x C/G) per (sample n, group g), f32,
//   var = E[x^2] - E[x]^2 (biased; the JAX kernel's formula),
//   y = (x - mean) * rsqrt(var + eps) * scale + bias, optionally y*sigmoid(y),
//   stored in x's dtype.
//
// Bound on this card: bytes. One read of x and one write of y,
// 2*N*rows*C*itemsize bytes, at a few FLOPs per element. The TPU kernel keeps
// one sample's whole slab in VMEM and reads it once; the frame-pooled resnet
// slabs here reach 3 x 32768 x 640 fp32 = 252 MB, far past the 50 MB L2, so
// the statistics need a pass of their own and x is read twice.
//
// Design. Three launches, no atomics, so every run sums in the same order:
//   1. partial statistics: grid (S chunks of rows, N samples). A block walks
//      its chunk of rows for 32 channels at a time (one warp row = 32
//      consecutive channels, coalesced), 8 row lanes deep, and writes f32
//      per-channel sums of x and x^2 for its chunk. S is chosen by the
//      caller so that N*S blocks fill the 132 SMs several times over even
//      when N is 1 to 3 (one block per (n, g) would give 32-96 blocks);
//   2. group statistics: one block per (n, g) sums its S x C/G partials in
//      a fixed order (strided per thread, then a tree in shared memory) and
//      writes mean and rsqrt(var + eps);
//   3. apply: grid (row tiles, N). A block folds scale/bias and the group
//      statistics into per-channel (a, c) in shared memory, then streams
//      its rows as y = x*a + c (+ SiLU), coalesced over the flat tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kLanesC = 32;  // channel lanes of the statistics block
constexpr int kLanesR = 8;   // row lanes of the statistics block
constexpr int kFinThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kApplyRows = 32;

// partial[n][s][0][c] = sum of x, partial[n][s][1][c] = sum of x^2 over the
// rows of chunk s.
template <typename T>
__global__ void __launch_bounds__(kLanesC * kLanesR)
gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int rows,
                  int C, int S, int rows_per_chunk) {
  __shared__ float red_s[kLanesR][kLanesC];
  __shared__ float red_q[kLanesR][kLanesC];
  const int s = blockIdx.x;
  const int n = blockIdx.y;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int r0 = s * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  const T* xn = x + (long long)n * rows * C;
  float* pn = partial + ((long long)n * S + s) * 2 * C;
  for (int c0 = 0; c0 < C; c0 += kLanesC) {
    const int c = c0 + tx;
    float sum = 0.f, sq = 0.f;
    if (c < C) {
      for (int r = r0 + ty; r < r1; r += kLanesR) {
        const float val = to_f32(xn[(long long)r * C + c]);
        sum += val;
        sq = fmaf(val, val, sq);
      }
    }
    red_s[ty][tx] = sum;
    red_q[ty][tx] = sq;
    __syncthreads();
    if (ty == 0 && c < C) {
      float ts = 0.f, tq = 0.f;
#pragma unroll
      for (int i = 0; i < kLanesR; ++i) {
        ts += red_s[i][tx];
        tq += red_q[i][tx];
      }
      pn[c] = ts;
      pn[C + c] = tq;
    }
    __syncthreads();
  }
}

// stats[(n*G + g)*2 + {0,1}] = mean, rsqrt(var + eps)
__global__ void __launch_bounds__(kFinThreads)
gn_stats_kernel(const float* __restrict__ partial, float* __restrict__ stats, int rows,
                int C, int G, int S, float eps) {
  __shared__ float red_s[kFinThreads];
  __shared__ float red_q[kFinThreads];
  const int ng = blockIdx.x;
  const int n = ng / G;
  const int g = ng % G;
  const int cpg = C / G;
  const float* pn = partial + (long long)n * S * 2 * C;
  float sum = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < S * cpg; i += kFinThreads) {
    const int s = i / cpg;
    const int c = g * cpg + (i - s * cpg);
    sum += pn[(long long)s * 2 * C + c];
    sq += pn[(long long)s * 2 * C + C + c];
  }
  red_s[threadIdx.x] = sum;
  red_q[threadIdx.x] = sq;
  __syncthreads();
  for (int w = kFinThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      red_s[threadIdx.x] += red_s[threadIdx.x + w];
      red_q[threadIdx.x] += red_q[threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float cnt = (float)rows * (float)cpg;
    const float mean = red_s[0] / cnt;
    const float var = red_q[0] / cnt - mean * mean;
    stats[ng * 2] = mean;
    stats[ng * 2 + 1] = rsqrtf(var + eps);
  }
}

template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ stats,
                T* __restrict__ y, int rows, int C, int G, int silu) {
  extern __shared__ float coef[];  // [0, C): a, [C, 2C): c
  const int n = blockIdx.y;
  const int cpg = C / G;
  for (int c = threadIdx.x; c < C; c += kApplyThreads) {
    const int g = c / cpg;
    const float mean = stats[(n * G + g) * 2];
    const float inv = stats[(n * G + g) * 2 + 1];
    const float a = inv * scale[c];
    coef[c] = a;
    coef[C + c] = bias[c] - mean * a;
  }
  __syncthreads();
  const int r0 = blockIdx.x * kApplyRows;
  const int r1 = min(rows, r0 + kApplyRows);
  const long long base = ((long long)n * rows + r0) * C;
  const int count = (r1 - r0) * C;
  for (int e = threadIdx.x; e < count; e += kApplyThreads) {
    const int c = e % C;
    float val = fmaf(to_f32(x[base + e]), coef[c], coef[C + c]);
    if (silu) val = val / (1.f + __expf(-val));
    y[base + e] = from_f32<T>(val);
  }
}

template <typename T>
cudaError_t run(const void* x, const float* scale, const float* bias, void* y,
                float* partial, float* stats, int N, int rows, int C, int G, int S,
                int rows_per_chunk, float eps, int silu, cudaStream_t stream) {
  gn_partial_kernel<T><<<dim3(S, N), dim3(kLanesC, kLanesR), 0, stream>>>(
      static_cast<const T*>(x), partial, rows, C, S, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_stats_kernel<<<N * G, kFinThreads, 0, stream>>>(partial, stats, rows, C, G, S, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (rows + kApplyRows - 1) / kApplyRows;
  gn_apply_kernel<T><<<dim3(tiles, N), kApplyThreads, 2 * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), scale, bias, stats, static_cast<T*>(y), rows, C, G, silu);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. partial: N*S*2*C floats of scratch;
// stats: N*G*2 floats of scratch. Returns the first cudaError_t raised.
extern "C" int group_norm_fwd(const void* x, const float* scale, const float* bias,
                              void* y, float* partial, float* stats, int dtype, int N,
                              int rows, int C, int G, int S, int rows_per_chunk,
                              float eps, int silu, void* stream) {
  if (N < 1 || rows < 1 || C < 1 || G < 1 || C % G != 0 || S < 1 ||
      (long long)S * rows_per_chunk < rows || 2LL * C * sizeof(float) > 48 * 1024 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(x, scale, bias, y, partial, stats, N, rows, C, G, S,
                           rows_per_chunk, eps, silu, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, scale, bias, y, partial, stats, N, rows, C, G, S,
                                   rows_per_chunk, eps, silu, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* groupnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
