// Frame attention for Hopper (sm_90a): every frame's queries against the
// keys/values of frame 0.
//
// Replaces the TPU kernel videop2p_tpu/ops/attention.py:
// fused_frame_attention -> _fused_rect -> _fused_kernel (pl.pallas_call).
//
//   out[b,f,h,n,:] = softmax(q[b,f,h,n,:] . k[b,h,:,:]^T * scale) . v[b,h,:,:]
//
// Frames fold into the query axis: for one (b, h) the F*N queries of all
// frames form one long rectangular attention against the N keys of frame 0,
// so K/V are shared by every frame and never broadcast per frame.
//
// Bound on this card: operations. 4*B*H*(F*N)*N*D FLOPs against
// (B*H*(2*F*N + 2*N)*D) elements moved; at the 64x64 edit site
// (B=3, F=8, H=8, N=4096, D=40) that is 5.2e11 FLOPs over 63 MB in fp32,
// ~8000 FLOP/byte, far above the ridge point of either precision.
//
// Design. The TPU kernel keeps a full 4096-wide f32 score row per query in
// VMEM; a block's shared memory here (227 KB) cannot hold even 64 such rows,
// so the kernel streams K/V tiles through shared memory instead and keeps an
// online softmax (running max and running sum, f32) per query row:
//   * one block = one (b, h) and a tile of the folded query axis;
//   * four threads share a query row, each holding every fourth element of
//     q and of the f32 accumulator, so D <= 128 fits in registers; a thread
//     also holds RPT rows, so every K/V element read from shared memory
//     feeds RPT fused multiply-adds;
//   * keys are consumed in chunks of KC: the chunk's scores are reduced
//     across the four threads with two warp shuffles, the accumulator is
//     rescaled once per chunk, and exp2 runs on log2(e)-prescaled scores;
//   * a ragged F*N (or N) is masked: rows past the end load zeros and are
//     not stored, keys past the end score -inf.
// This is the simple, exact kernel: f32 FMA on the CUDA cores, no tensor
// cores. Tensor-core tiles (mma.sync / wgmma with D padded to 48 or 96) are
// later work; the measured times sit in PERF.md.
//
// q and out are read/written through strides for a (B, F, H, N, D) view
// (last stride 1), k and v through strides for (B, H, N, D), so callers pass
// the head-split views of their projections without a transposing copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTPR = 4;                  // threads per query row
constexpr int kGroups = kThreads / kTPR; // row groups per block
constexpr int kKC = 8;                   // keys per online-softmax chunk

struct Strides {
  long long q_b, q_f, q_h, q_n;
  long long k_b, k_h, k_n;
  long long v_b, v_h, v_n;
  long long o_b, o_f, o_h, o_n;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// DT: elements of D per thread (D <= 4*DT); RPT: query rows per thread;
// BK: keys per shared-memory tile.
template <typename T, int DT, int RPT, int BK>
__global__ void __launch_bounds__(kThreads)
frame_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int F, int H, int N, int D, Strides st, float scale_log2) {
  constexpr int DP = DT * kTPR;
  constexpr int kRows = kGroups * RPT;
  __shared__ float ks[BK * DP];
  __shared__ float vs[BK * DP];

  const int tid = threadIdx.x;
  const int part = tid % kTPR;
  const int group = tid / kTPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int M = F * N;
  const int row0 = blockIdx.x * kRows;

  float qr[RPT][DT];
  float acc[RPT][DT];
  float mrow[RPT];
  float lrow[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r * kGroups + group;
    const bool live = row < M;
    const int f = live ? row / N : 0;
    const int n = live ? row - f * N : 0;
    const T* qp = q + b * st.q_b + f * st.q_f + h * st.q_h + n * st.q_n;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int d = i * kTPR + part;
      qr[r][i] = (live && d < D) ? to_f32(qp[d]) * scale_log2 : 0.f;
      acc[r][i] = 0.f;
    }
    mrow[r] = -CUDART_INF_F;
    lrow[r] = 0.f;
  }

  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;
  for (int kt = 0; kt < N; kt += BK) {
    __syncthreads();
    for (int e = tid; e < BK * DP; e += kThreads) {
      const int key = kt + e / DP;
      const int d = e % DP;
      const bool ok = key < N && d < D;
      ks[e] = ok ? to_f32(kb[key * st.k_n + d]) : 0.f;
      vs[e] = ok ? to_f32(vb[key * st.v_n + d]) : 0.f;
    }
    __syncthreads();
    const int nk = min(BK, N - kt);
    for (int j0 = 0; j0 < nk; j0 += kKC) {
      float s[RPT][kKC];
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        const float* kr = ks + (j0 + jj) * DP + part;
        float kv[DT];
#pragma unroll
        for (int i = 0; i < DT; ++i) kv[i] = kr[i * kTPR];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < DT; ++i) a = fmaf(qr[r][i], kv[i], a);
          s[r][jj] = a;
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
#pragma unroll
        for (int jj = 0; jj < kKC; ++jj) {
          float a = s[r][jj];
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          s[r][jj] = (j0 + jj < nk) ? a : -CUDART_INF_F;
        }
        float mc = s[r][0];
#pragma unroll
        for (int jj = 1; jj < kKC; ++jj) mc = fmaxf(mc, s[r][jj]);
        const float mn = fmaxf(mrow[r], mc);
        const float alpha = exp2f(mrow[r] - mn);
        lrow[r] *= alpha;
#pragma unroll
        for (int i = 0; i < DT; ++i) acc[r][i] *= alpha;
#pragma unroll
        for (int jj = 0; jj < kKC; ++jj) {
          const float p = exp2f(s[r][jj] - mn);
          lrow[r] += p;
          s[r][jj] = p;
        }
        mrow[r] = mn;
      }
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        const float* vr = vs + (j0 + jj) * DP + part;
        float vv[DT];
#pragma unroll
        for (int i = 0; i < DT; ++i) vv[i] = vr[i * kTPR];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
#pragma unroll
          for (int i = 0; i < DT; ++i) acc[r][i] = fmaf(s[r][jj], vv[i], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r * kGroups + group;
    if (row >= M) continue;
    const int f = row / N;
    const int n = row - f * N;
    T* op = o + b * st.o_b + f * st.o_f + h * st.o_h + n * st.o_n;
    const float inv = 1.f / lrow[r];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int d = i * kTPR + part;
      if (d < D) op[d] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int DT, int RPT, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int F, int H, int N, int D, const Strides& st, float scale,
                   cudaStream_t stream) {
  constexpr int kRows = kGroups * RPT;
  const long long M = (long long)F * N;
  dim3 grid((unsigned)((M + kRows - 1) / kRows), (unsigned)(B * H));
  const float scale_log2 = scale * 1.4426950408889634f;
  frame_attention_kernel<T, DT, RPT, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), F, H, N, D, st, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int F, int H, int N, int D, const Strides& st, float scale,
                     cudaStream_t stream) {
  if (D <= 40) return launch<T, 10, 4, 64>(q, k, v, o, B, F, H, N, D, st, scale, stream);
  if (D <= 80) return launch<T, 20, 2, 64>(q, k, v, o, B, F, H, N, D, st, scale, stream);
  return launch<T, 32, 1, 32>(q, k, v, o, B, F, H, N, D, st, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int frame_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int F, int H, int N,
                                   int D, const long long* strides, float scale,
                                   void* stream) {
  if (D < 1 || D > 128 || N < 1 || F < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  Strides st;
  st.q_b = strides[0]; st.q_f = strides[1]; st.q_h = strides[2]; st.q_n = strides[3];
  st.k_b = strides[4]; st.k_h = strides[5]; st.k_n = strides[6];
  st.v_b = strides[7]; st.v_h = strides[8]; st.v_n = strides[9];
  st.o_b = strides[10]; st.o_f = strides[11]; st.o_h = strides[12]; st.o_n = strides[13];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, o, B, F, H, N, D, st, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, F, H, N, D, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* frame_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
