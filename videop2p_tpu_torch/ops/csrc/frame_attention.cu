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
// Bound on this card: operations. 4*B*F*H*N^2*D FLOPs (the true D, not the
// padded one) against (B*H*(2*F*N + 2*N)*D) elements moved; at the 64x64
// edit site (B=3, F=8, H=8, N=4096, D=40) 5.2e11 FLOPs over 142 MB in bf16,
// ~3600 FLOP/byte, far above the ridge point: 0.521 ms at 989 TFLOP/s.
//
// bfloat16: the warpgroup core of frame_attention_sm90.cuh, shared with the
// flash kernel. Tensor cores: Q.K^T and P.V run as wgmma (bf16 in, f32
// accumulators in registers), the head dim zero-padded to a multiple of 16
// (40 -> 48). Copies: K/V tiles arrive by TMA into a ring of shared-memory
// stages that a producer warp keeps full while three consumer warpgroups
// (two above D = 96) compute; Q is loaded once into registers, and the
// softmax, P and O never leave registers. L2: the query tiles of one
// (b, h) run next to each other, so one (b, h)'s K/V is read from HBM
// about once and from L2 by every block of it, 192 FLOP per byte fetched
// (192 query rows a block). Numerics: scores and softmax in f32, the
// unnormalized P rounded to bf16 before P.V (the JAX kernel's
// p.astype(v.dtype)), the row sum in f32.
//
// float32: the simple exact kernel, f32 FMA on the CUDA cores (no TF32):
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
//
// q and out are read/written through strides for a (B, F, H, N, D) view
// (last stride 1), k and v through strides for (B, H, N, D), so callers pass
// the head-split views of their projections without a transposing copy.
// The bf16 path reads K/V through TMA and Q as 32-bit pairs: the base
// addresses of q, k and v must be 16-byte aligned and their strides
// multiples of 8 elements (ops/attention.py checks this before the launch
// and raises otherwise).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "frame_attention_sm90.cuh"

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

// DT: elements of D per thread (D <= 4*DT); RPT: query rows per thread;
// BK: keys per shared-memory tile.
template <int DT, int RPT, int BK>
__global__ void __launch_bounds__(kThreads)
frame_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
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
    const float* qp = q + b * st.q_b + f * st.q_f + h * st.q_h + n * st.q_n;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int d = i * kTPR + part;
      qr[r][i] = (live && d < D) ? qp[d] * scale_log2 : 0.f;
      acc[r][i] = 0.f;
    }
    mrow[r] = -CUDART_INF_F;
    lrow[r] = 0.f;
  }

  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  for (int kt = 0; kt < N; kt += BK) {
    __syncthreads();
    for (int e = tid; e < BK * DP; e += kThreads) {
      const int key = kt + e / DP;
      const int d = e % DP;
      const bool ok = key < N && d < D;
      ks[e] = ok ? kb[key * st.k_n + d] : 0.f;
      vs[e] = ok ? vb[key * st.v_n + d] : 0.f;
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
    float* op = o + b * st.o_b + f * st.o_f + h * st.o_h + n * st.o_n;
    const float inv = 1.f / lrow[r];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int d = i * kTPR + part;
      if (d < D) op[d] = acc[r][i] * inv;
    }
  }
}

template <int DT, int RPT, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int F, int H, int N, int D, const Strides& st, float scale,
                   cudaStream_t stream) {
  constexpr int kRows = kGroups * RPT;
  const long long M = (long long)F * N;
  dim3 grid((unsigned)((M + kRows - 1) / kRows), (unsigned)(B * H));
  const float scale_log2 = scale * 1.4426950408889634f;
  frame_attention_kernel<DT, RPT, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), F, H, N, D, st, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                     int F, int H, int N, int D, const Strides& st, float scale,
                     cudaStream_t stream) {
  if (D <= 40) return launch<10, 4, 64>(q, k, v, o, B, F, H, N, D, st, scale, stream);
  if (D <= 80) return launch<20, 2, 64>(q, k, v, o, B, F, H, N, D, st, scale, stream);
  return launch<32, 1, 32>(q, k, v, o, B, F, H, N, D, st, scale, stream);
}

template <int DP>
__global__ void __launch_bounds__(sm90::Config<DP>::kThreads, 1)
frame_attention_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const sm90::Problem p) {
  sm90::attention_block<DP>(&kmap, &vmap, p);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int F,
                        int H, int N, int D, const Strides& st, float scale,
                        cudaStream_t stream) {
  const sm90::Problem p{static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o),
                        nullptr, nullptr, st.q_b, st.q_f, st.q_h, st.q_n,
                        st.o_b, st.o_f, st.o_h, st.o_n, F, H, N, N, D, scale};
  const long long k_st[3] = {st.k_b, st.k_h, st.k_n};
  const long long v_st[3] = {st.v_b, st.v_h, st.v_n};
  return sm90::dispatch_dp(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return sm90::launch<DP>(frame_attention_wgmma_kernel<DP>, p, B, k, k_st, v, v_st, stream);
  });
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
  if (dtype == 0) return (int)launch_f32(q, k, v, o, B, F, H, N, D, st, scale, s);
  if (dtype == 1) return (int)launch_bf16(q, k, v, o, B, F, H, N, D, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* frame_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
