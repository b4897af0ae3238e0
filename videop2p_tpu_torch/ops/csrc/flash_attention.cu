// Flash attention for Hopper (sm_90a): O = softmax(Q.K^T * scale) . V,
// non-causal, over q (B0, B1, H, Lq, D) against k, v (B0, H, Lk, D): the B1
// query batches share one K/V batch (the caller passes a K/V batch stride
// of 0 over B1, or B1 = 1). All operands are strided, last dimension
// contiguous.
//
// Replaces the TPU kernel that videop2p_tpu/ops/attention.py reaches from
// flash_frame_attention (:81) and flash_rect_frame_attention (:94): JAX's
// stock Pallas TPU flash attention (jax/experimental/pallas/ops/tpu/
// flash_attention.py: flash_attention :140, forward pallas_call :758), a
// blocked matrix-unit kernel with an online softmax.
//   * flash:      B0 = B, B1 = F, K/V batch stride 0 over the frame axis, so
//                 every frame reads frame 0's K/V in place (the JAX wrapper
//                 materializes the broadcast; the values are the same);
//   * flash_rect: B0 = B, B1 = 1, frames folded into the query length,
//                 Lq = F*N against Lk = N.
//
// Bound on this card: operations. 4*B0*B1*H*Lq*Lk*D FLOPs (the true D, not
// the padded one) against B0*H*(2*B1*Lq + 2*Lk)*D elements moved; at the
// 64x64 edit site (B=3, F=8, H=8, N=4096, D=40) 5.2e11 FLOPs over 142 MB in
// bf16: 0.521 ms at 989 TFLOP/s.
//
// bfloat16: the warpgroup core of frame_attention_sm90.cuh, shared with the
// fused kernel (frame_attention.cu). The B1 query batches fold into one
// query axis of B1*Lq rows per (b0, h), since they read the same K/V.
// Tensor cores: Q.K^T and P.V as wgmma, f32 accumulators in registers, the
// head dim zero-padded to a multiple of 16. Copies: K/V tiles by TMA into a
// ring of shared-memory stages, kept full by a producer warp; no score, P
// or O tile passes through shared memory. L2: the query tiles of one
// (b0, h) run next to each other, 192 FLOP per byte of K/V fetched (192
// query rows a block up to D = 96, 128 above).
// Numerics: scores and softmax in f32, the unnormalized probabilities
// rounded to bf16 before P.V (the stock kernel's p.astype(v.dtype)), the
// row sum in f32. Residuals: when the caller passes m and l, each row's
// final max (of the scaled scores, natural-log units) and sum are written
// to them in f32, the stock forward's save_residuals outputs, which the
// backward kernels (flash_attention_bwd.cu) read. K/V go through TMA: the
// base addresses of q, k and v 16-byte aligned, their strides multiples of
// 8 elements (ops/attention.py checks this before the launch and raises
// otherwise).
//
// float32: one block of 4 warps takes a tile of 64 queries (16 per warp)
// and walks the keys in tiles of 64 through shared memory, with an online
// softmax per query row (running max and running sum in f32, the
// accumulator rescaled once per tile), full fp32 FMAs on the CUDA cores (no
// TF32): the CLI's fp32 default is held to the JAX package on the CPU. Two
// lanes share a query row: lane (r, half) owns keys half + 2j of each tile
// and output columns half + 2i, so the row max and sum reduce with one
// shuffle. Keys past Lk score -inf before the max, queries past Lq load
// zeros and are not stored; a row whose keys are all masked keeps a
// running max of -inf and takes exp2(-inf) = 0, never NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "frame_attention_sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;        // queries per block, 16 per warp
constexpr int kBK = 64;                 // keys per shared-memory tile
constexpr int kKeysPerLane = kBK / 2;   // two lanes share a query row

struct Strides {
  long long q[4], k[4], v[4], o[4];  // (b0, b1, h, l)
};

struct Shape {
  int B1, H, Lq, Lk, D;
};

// Rows [row0, row0 + 64) of an (L, D) matrix at `src` (row stride `ld`)
// into shared memory `dst` (64 x DP, row stride LDS), zero past L and D.
template <int DP, int LDS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ld,
                                          int row0, int L, int D) {
  for (int e = threadIdx.x; e < 64 * DP; e += kThreads) {
    const int r = e / DP;
    const int d = e - r * DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < L && d < D) x = src[(long long)row * ld + d];
    dst[r * LDS + d] = x;
  }
}

// Block coordinates: x = (b0, b1, h) flattened, y = query tile.
struct Coords {
  long long q, k, v, o;
  int q0;
};

__device__ __forceinline__ Coords block_coords(const Shape& sh, const Strides& st) {
  const int bh = blockIdx.x;
  const int h = bh % sh.H;
  const int b = bh / sh.H;
  const int b1 = b % sh.B1;
  const int b0 = b / sh.B1;
  Coords c;
  c.q = b0 * st.q[0] + b1 * st.q[1] + h * st.q[2];
  c.k = b0 * st.k[0] + b1 * st.k[1] + h * st.k[2];
  c.v = b0 * st.v[0] + b1 * st.v[1] + h * st.v[2];
  c.o = b0 * st.o[0] + b1 * st.o[1] + h * st.o[2];
  c.q0 = blockIdx.y * kBQ;
  return c;
}

// The online-softmax update of one tile for the row a lane owns: s holds the
// lane's scores (already in log2 units, -inf where masked); writes the
// unnormalized probabilities through `put`, returns the rescale factor of
// the accumulator and updates the running max m and sum l.
template <typename Put>
__device__ __forceinline__ float online_softmax(float (&s)[kKeysPerLane], float& m,
                                                float& l, Put put) {
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) mx = fmaxf(mx, s[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m, mx);
  const float m_use = (m_new == -CUDART_INF_F) ? 0.f : m_new;
  const float alpha = exp2f(m - m_use);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const float p = exp2f(s[j] - m_use);
    sum += p;
    put(j, p);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l = l * alpha + sum;
  m = m_new;
  return alpha;
}

template <int DP>
__device__ __forceinline__ void store_row(float* o, const Coords& c, const Strides& st,
                                          const Shape& sh, int row, int half,
                                          const float (&acc)[DP / 2], float m, float l,
                                          float* m_out, float* l_out) {
  if (row >= sh.Lq) return;
  if (m_out != nullptr && half == 0) {
    // blockIdx.x flattens (b0, b1, h): the residuals are (B0, B1, H, Lq)
    const long long r = (long long)blockIdx.x * sh.Lq + row;
    m_out[r] = m * 0.69314718055994531f;  // log2 units -> natural
    l_out[r] = l;
  }
  float* op = o + c.o + (long long)row * st.o[3];
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int d = half + 2 * i;
    if (d < sh.D) op[d] = acc[i] * inv;
  }
}

// ----------------------------------------------------------------- float32

template <int DP>
struct FmaSmem {
  static constexpr int LD = DP + 1;  // odd: a warp's 16 rows hit 16 banks
  static constexpr int LDP = kBK + 1;
  static constexpr size_t bytes =
      ((size_t)(kBQ + 2 * kBK) * LD + (size_t)kWarps * 16 * LDP) * 4;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out, Shape sh,
                         Strides st, float scale_log2) {
  using L = FmaSmem<DP>;
  constexpr int LD = L::LD, LDP = L::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  const Coords c = block_coords(sh, st);
  const float* Qw = Qs + (warp * 16 + r) * LD;
  float* Pw = Ps + warp * 16 * LDP;

  load_tile<DP, LD>(Qs, q + c.q, st.q[3], c.q0, sh.Lq, sh.D);

  float m = -CUDART_INF_F, l = 0.f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < sh.Lk; kt += kBK) {
    __syncthreads();  // Q is loaded; every warp is done with the last K/V tile
    load_tile<DP, LD>(Ks, k + c.k, st.k[3], kt, sh.Lk, sh.D);
    load_tile<DP, LD>(Vs, v + c.v, st.v[3], kt, sh.Lk, sh.D);
    __syncthreads();

    float s[kKeysPerLane];
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) s[j] = 0.f;
    // columns past D are zero in both Q and K: stop at D rounded up to 8
    for (int d0 = 0; d0 < DP && d0 < sh.D; d0 += 8) {
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        const float qv = Qw[d0 + dd];
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j)
          s[j] = fmaf(qv, Ks[(half + 2 * j) * LD + d0 + dd], s[j]);
      }
    }
    const int nk = min(kBK, sh.Lk - kt);
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j)
      s[j] = (half + 2 * j < nk) ? s[j] * scale_log2 : -CUDART_INF_F;
    const float alpha = online_softmax(s, m, l, [&](int j, float p) {
      Pw[r * LDP + half + 2 * j] = p;
    });
    __syncwarp();

#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha;
    for (int key = 0; key < nk; ++key) {
      const float p = Pw[r * LDP + key];
      const float* vr = Vs + key * LD + half;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = fmaf(p, vr[2 * i], acc[i]);
    }
    __syncwarp();
  }
  store_row<DP>(o, c, st, sh, c.q0 + warp * 16 + r, half, acc, m, l, m_out, l_out);
}

// ------------------------------------------------------------------ launch

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* m,
                       float* l, int B0, const Shape& sh, const Strides& st, float scale,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)((long long)B0 * sh.B1 * sh.H),
                  (unsigned)((sh.Lq + kBQ - 1) / kBQ));
  const size_t smem = FmaSmem<DP>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_fma_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), m, l, sh, st,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int DP>
__global__ void __launch_bounds__(sm90::Config<DP>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const sm90::Problem p) {
  sm90::attention_block<DP>(&kmap, &vmap, p);
}

// The B1 query batches of one (b0, h) fold into one query axis of B1 * Lq
// rows against the shared K/V.
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* m,
                        float* l, int B0, const Shape& sh, const Strides& st, float scale,
                        cudaStream_t stream) {
  const sm90::Problem p{static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o),
                        m, l, st.q[0], st.q[1], st.q[2], st.q[3],
                        st.o[0], st.o[1], st.o[2], st.o[3], sh.B1, sh.H, sh.Lq, sh.Lk, sh.D,
                        scale};
  const long long k_st[3] = {st.k[0], st.k[2], st.k[3]};
  const long long v_st[3] = {st.v[0], st.v[2], st.v[3]};
  return sm90::dispatch_dp(sh.D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return sm90::launch<DP>(flash_fwd_wgmma_kernel<DP>, p, B0, k, k_st, v, v_st, stream);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: q, k, v, o, each (b0, b1, h, l)
// in elements; the b1 strides of k and v are 0 or B1 is 1. m, l: null, or
// contiguous f32 (B0, B1, H, Lq) buffers for the per-row residuals. Returns
// the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* m, float* l, int dtype, int B0,
                                   int B1, int H, int Lq,
                                   int Lk, int D, const long long* strides, float scale,
                                   void* stream) {
  if (D < 1 || D > 128 || Lq < 1 || Lk < 1 || B0 < 1 || B1 < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  if ((m == nullptr) != (l == nullptr)) return (int)cudaErrorInvalidValue;
  if ((long long)B0 * B1 * H > 0x7fffffffLL || (Lq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
    st.o[i] = strides[12 + i];
  }
  if (B1 > 1 && (st.k[1] != 0 || st.v[1] != 0)) return (int)cudaErrorInvalidValue;
  const Shape sh{B1, H, Lq, Lk, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if ((long long)B0 * H > 65535) return (int)cudaErrorInvalidValue;
    return (int)launch_bf16(q, k, v, o, m, l, B0, sh, st, scale, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)sm90::dispatch_dp(D, [&](auto dp) {
    return launch_f32<decltype(dp)::value>(q, k, v, o, m, l, B0, sh, st, scale, s);
  });
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
