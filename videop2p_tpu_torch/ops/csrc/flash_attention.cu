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
// float32: the 3xTF32 warpgroup core of frame_attention_tf32_sm90.cuh,
// shared with the fused kernel (frame_attention.cu): a prep kernel writes
// each K/V tile's TF32 hi/lo image into a scratch the caller allocates (the
// fused kernel's frame_attention_tf32_scratch_bytes), then the B1 query
// batches, folded into one query axis, run S = Q.K^T and P.V as three TF32
// wgmma passes each, with an online f32 softmax; the residuals m and l as
// in bfloat16. Every operand is read at any strides (no TMA). Keys past Lk
// score -inf; key 0 is never masked, so no row gives NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "frame_attention_sm90.cuh"
#include "frame_attention_tf32_sm90.cuh"

namespace {

struct Strides {
  long long q[4], k[4], v[4], o[4];  // (b0, b1, h, l)
};

struct Shape {
  int B1, H, Lq, Lk, D;
};

template <int DP>
__global__ void __launch_bounds__(sm90::tf32::kPrepThreads)
flash_fwd_tf32_prep_kernel(const sm90::tf32::fwd::Problem p) {
  sm90::tf32::fwd::prep_tile<DP>(p);
}

template <int DP>
__global__ void __launch_bounds__(sm90::tf32::kThreads, 1)
flash_fwd_tf32_kernel(const sm90::tf32::fwd::Problem p) {
  sm90::tf32::fwd::attention_block<DP>(p);
}

// The B1 query batches of one (b0, h) fold into one query axis of B1 * Lq
// rows against the shared K/V.
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* m,
                       float* l, void* scratch, int B0, const Shape& sh, const Strides& st,
                       float scale, cudaStream_t stream) {
  const sm90::tf32::fwd::Problem p{
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), m, l, static_cast<uint8_t*>(scratch),
      {st.q[0], st.q[1], st.q[2], st.q[3]}, {st.o[0], st.o[1], st.o[2], st.o[3]},
      {st.k[0], st.k[2], st.k[3]}, {st.v[0], st.v[2], st.v[3]},
      sh.B1, sh.H, sh.Lq, sh.Lk, sh.D, 0, scale};
  return sm90::tf32::dispatch_dp(sh.D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return sm90::tf32::fwd::launch<DP>(flash_fwd_tf32_prep_kernel<DP>, flash_fwd_tf32_kernel<DP>,
                                       p, B0, stream);
  });
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
// contiguous f32 (B0, B1, H, Lq) buffers for the per-row residuals.
// scratch: float32, a device buffer of the fused kernel's
// frame_attention_tf32_scratch_bytes(B0, H, Lk, D) bytes; bfloat16, unused.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* m, float* l, int dtype, int B0,
                                   int B1, int H, int Lq,
                                   int Lk, int D, const long long* strides, float scale,
                                   void* scratch, void* stream) {
  if (D < 1 || D > 128 || Lq < 1 || Lk < 1 || B0 < 1 || B1 < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  if ((m == nullptr) != (l == nullptr)) return (int)cudaErrorInvalidValue;
  if ((long long)B0 * B1 * H > 0x7fffffffLL || (long long)B0 * H > 65535)
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
  if (dtype == 1) return (int)launch_bf16(q, k, v, o, m, l, B0, sh, st, scale, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_f32(q, k, v, o, m, l, scratch, B0, sh, st, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
