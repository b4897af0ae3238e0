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
// float32: the 3xTF32 warpgroup core of frame_attention_tf32_sm90.cuh,
// shared with the flash kernel: a prep kernel writes each K/V tile's TF32
// hi/lo image (V transposed) into a scratch the caller allocates
// (frame_attention_tf32_scratch_bytes), then S = Q.K^T and each key tile's
// P.V run as three TF32 wgmma passes each (about 2^-21 relative error a
// product; PyTorch's own products keep TF32 off), Q resident in shared
// memory, the online softmax and O in f32 registers. Bound at the 64x64
// edit site: 5.2e11 FLOPs x 3 passes at 495 TFLOP/s, 3.126 ms (the CUDA
// cores' 67 TFLOP/s would give 7.692 ms).
//
// q and out are read/written through strides for a (B, F, H, N, D) view
// (last stride 1), k and v through strides for (B, H, N, D), so callers pass
// the head-split views of their projections without a transposing copy.
// The bf16 path reads K/V through TMA and Q as 32-bit pairs: the base
// addresses of q, k and v must be 16-byte aligned and their strides
// multiples of 8 elements (ops/attention.py checks this before the launch
// and raises otherwise). The float32 path reads every operand at any
// strides.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "frame_attention_sm90.cuh"
#include "frame_attention_tf32_sm90.cuh"

namespace {

struct Strides {
  long long q_b, q_f, q_h, q_n;
  long long k_b, k_h, k_n;
  long long v_b, v_h, v_n;
  long long o_b, o_f, o_h, o_n;
};

template <int DP>
__global__ void __launch_bounds__(sm90::tf32::kPrepThreads)
frame_attention_tf32_prep_kernel(const sm90::tf32::fwd::Problem p) {
  sm90::tf32::fwd::prep_tile<DP>(p);
}

template <int DP>
__global__ void __launch_bounds__(sm90::tf32::kThreads, 1)
frame_attention_tf32_kernel(const sm90::tf32::fwd::Problem p) {
  sm90::tf32::fwd::attention_block<DP>(p);
}

// The frames fold into the query axis: F query batches of N rows against
// the N keys of frame 0's K/V.
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* scratch,
                       int B, int F, int H, int N, int D, const Strides& st, float scale,
                       cudaStream_t stream) {
  const sm90::tf32::fwd::Problem p{
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), nullptr, nullptr, static_cast<uint8_t*>(scratch),
      {st.q_b, st.q_f, st.q_h, st.q_n}, {st.o_b, st.o_f, st.o_h, st.o_n},
      {st.k_b, st.k_h, st.k_n}, {st.v_b, st.v_h, st.v_n}, F, H, N, N, D, 0, scale};
  return sm90::tf32::dispatch_dp(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return sm90::tf32::fwd::launch<DP>(frame_attention_tf32_prep_kernel<DP>,
                                       frame_attention_tf32_kernel<DP>, p, B, stream);
  });
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

// The bytes of the float32 kernels' scratch (the prep kernel's K/V tiles)
// for B0 (b0, h) problems of H heads, Lk keys and head dim D, into *bytes;
// the flash kernel's float32 path takes the same scratch. Returns a
// cudaError_t.
extern "C" int frame_attention_tf32_scratch_bytes(int B0, int H, int Lk, int D,
                                                  long long* bytes) {
  *bytes = 0;
  if (B0 < 1 || H < 1 || Lk < 1) return (int)cudaErrorInvalidValue;
  return (int)sm90::tf32::dispatch_dp(D, [&](auto dp) {
    *bytes = sm90::tf32::fwd::scratch_bytes<decltype(dp)::value>(B0, H, Lk);
    return cudaSuccess;
  });
}

// The float32 kernels' geometry at head dim D, for reports: keys per
// streamed tile, ring stages, and the attention kernel's dynamic shared
// memory in bytes. Returns a cudaError_t.
extern "C" int frame_attention_tf32_config(int D, int* keys, int* stages, int* smem) {
  return (int)sm90::tf32::dispatch_dp(D, [&](auto dp) {
    using C = sm90::tf32::fwd::Config<decltype(dp)::value>;
    *keys = C::kT;
    *stages = C::kStages;
    *smem = C::kSmem;
    return cudaSuccess;
  });
}

// dtype: 0 = float32, 1 = bfloat16. scratch: float32, a device buffer of
// frame_attention_tf32_scratch_bytes(B, H, N, D) bytes; bfloat16, unused.
// Returns the cudaError_t of the launch.
extern "C" int frame_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int F, int H, int N,
                                   int D, const long long* strides, float scale,
                                   void* scratch, void* stream) {
  if (D < 1 || D > 128 || N < 1 || F < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  Strides st;
  st.q_b = strides[0]; st.q_f = strides[1]; st.q_h = strides[2]; st.q_n = strides[3];
  st.k_b = strides[4]; st.k_h = strides[5]; st.k_n = strides[6];
  st.v_b = strides[7]; st.v_h = strides[8]; st.v_n = strides[9];
  st.o_b = strides[10]; st.o_f = strides[11]; st.o_h = strides[12]; st.o_n = strides[13];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(q, k, v, o, scratch, B, F, H, N, D, st, scale, s);
  if (dtype == 1) return (int)launch_bf16(q, k, v, o, B, F, H, N, D, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* frame_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
