// Flash attention for Hopper (sm_90a): O = softmax(Q.K^T * scale) . V,
// non-causal, over q (B0, B1, H, Lq, D) and k, v (B0, B1, H, Lk, D), all
// strided (last dimension contiguous). A batch stride of 0 lets many query
// batches read one K/V batch in place.
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
// Bound on this card: operations. 4*B*H*Lq*Lk*D FLOPs against
// B*H*(2*Lq + 2*Lk)*D elements moved; at the 64x64 edit site (B=3, F=8,
// H=8, N=4096, D=40) 5.2e11 FLOPs over 63 MB in fp32.
//
// Design. One block of 4 warps takes a tile of 64 queries (16 per warp) and
// walks the keys in tiles of 64 through shared memory, with an online
// softmax per query row (running max and running sum in f32, the
// accumulator rescaled once per tile). Two lanes share a query row: lane
// (r, half) owns keys half + 2j of each tile and output columns half + 2i,
// so the row max and sum reduce with one shuffle.
//   * bfloat16: Q.K^T and P.V run on the tensor cores as WMMA 16x16x16 bf16
//     fragments with f32 accumulation. Q is row-major, K^T a col_major B
//     fragment read straight from the row-major K tile. The head dimension
//     is zero-padded to DP, a multiple of 16, in shared memory (40 -> 48).
//     Scores are scaled in f32 after Q.K^T; the unnormalized probabilities
//     are rounded to bf16 before P.V, as the stock kernel's
//     p.astype(v.dtype) does; the running sum adds the f32 values. The
//     score and P.V fragments pass through a per-warp f32 scratch in shared
//     memory, since a WMMA fragment's element-to-row map is unspecified.
//   * float32: the same tiling on the CUDA cores, full fp32 FMAs (no TF32):
//     the CLI's fp32 default is held to the JAX package on the CPU.
//   * ragged lengths: keys past Lk score -inf before the max, queries past
//     Lq load zeros and are not stored; a row whose keys are all masked
//     keeps a running max of -inf and takes exp2(-inf) = 0, never NaN.
//   * residuals: when the caller passes m and l, each row's final running
//     max (of the scaled scores, natural-log units) and running sum are
//     written to them in f32, the stock forward's save_residuals outputs,
//     which the backward kernels (flash_attention_bwd.cu) read.
// wgmma, TMA and warp specialization are later work; the measured times sit
// in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of an (L, D) matrix at `src` (row stride `ld`)
// into shared memory `dst` (64 x DP, row stride LDS), zero past L and D.
template <typename T, typename S, int DP, int LDS>
__device__ __forceinline__ void load_tile(S* dst, const T* src, long long ld,
                                          int row0, int L, int D) {
  for (int e = threadIdx.x; e < 64 * DP; e += kThreads) {
    const int r = e / DP;
    const int d = e - r * DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < L && d < D) x = to_f32(src[(long long)row * ld + d]);
    dst[r * LDS + d] = from_f32<S>(x);
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

template <typename T, int DP>
__device__ __forceinline__ void store_row(T* o, const Coords& c, const Strides& st,
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
  T* op = o + c.o + (long long)row * st.o[3];
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int d = half + 2 * i;
    if (d < sh.D) op[d] = from_f32<T>(acc[i] * inv);
  }
}

// ---------------------------------------------------------------- bfloat16

template <int DP>
struct TcSmem {
  static constexpr int LDQ = DP + 8;  // bf16; a multiple of 8 for WMMA
  static constexpr int LDP = kBK + 8;
  static constexpr int LDS = (DP > kBK ? DP : kBK) + 4;  // f32; multiple of 4
  static constexpr size_t bytes =
      (size_t)(kBQ + 2 * kBK) * LDQ * 2 + (size_t)kWarps * 16 * LDP * 2 +
      (size_t)kWarps * 16 * LDS * 4;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wmma_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                           float* __restrict__ l_out, Shape sh, Strides st,
                           float scale_log2) {
  using L = TcSmem<DP>;
  constexpr int LDQ = L::LDQ, LDP = L::LDP, LDS = L::LDS;
  // every region starts on a 32-byte boundary, as WMMA loads require:
  // 64 * LDQ * 2 and 16 * LDP * 2 and 16 * LDS * 4 are multiples of 32
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * LDQ;
  __nv_bfloat16* Vs = Ks + kBK * LDQ;
  __nv_bfloat16* Ps = Vs + kBK * LDQ;
  float* Sf = reinterpret_cast<float*>(Ps + kWarps * 16 * LDP);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  const Coords c = block_coords(sh, st);
  __nv_bfloat16* Pw = Ps + warp * 16 * LDP;
  float* Sw = Sf + warp * 16 * LDS;

  load_tile<__nv_bfloat16, __nv_bfloat16, DP, LDQ>(Qs, q + c.q, st.q[3], c.q0, sh.Lq, sh.D);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[DP / 16];
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd)
    wmma::load_matrix_sync(qf[kd], Qs + warp * 16 * LDQ + kd * 16, LDQ);

  float m = -CUDART_INF_F, l = 0.f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < sh.Lk; kt += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<__nv_bfloat16, __nv_bfloat16, DP, LDQ>(Ks, k + c.k, st.k[3], kt, sh.Lk, sh.D);
    load_tile<__nv_bfloat16, __nv_bfloat16, DP, LDQ>(Vs, v + c.v, st.v[3], kt, sh.Lk, sh.D);
    __syncthreads();

    // S = Q.K^T, the warp's 16 rows x 64 keys, f32 on the tensor cores
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * LDQ + kd * 16, LDQ);
        wmma::mma_sync(sf, qf[kd], kf, sf);
      }
      wmma::store_matrix_sync(Sw + j * 16, sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    const int nk = min(kBK, sh.Lk - kt);
    float s[kKeysPerLane];
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      const int key = half + 2 * j;
      s[j] = key < nk ? Sw[r * LDS + key] * scale_log2 : -CUDART_INF_F;
    }
    const float alpha = online_softmax(s, m, l, [&](int j, float p) {
      Pw[r * LDP + half + 2 * j] = __float2bfloat16(p);
    });
    __syncwarp();

    // P.V for the warp's 16 rows, into the (now free) score scratch
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf[kBK / 16];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wmma::load_matrix_sync(pf[kk], Pw + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * 16 * LDQ + n * 16, LDQ);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(Sw + n * 16, of, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = acc[i] * alpha + Sw[r * LDS + half + 2 * i];
    __syncwarp();
  }
  store_row<__nv_bfloat16, DP>(o, c, st, sh, c.q0 + warp * 16 + r, half, acc, m, l,
                               m_out, l_out);
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

  load_tile<float, float, DP, LD>(Qs, q + c.q, st.q[3], c.q0, sh.Lq, sh.D);

  float m = -CUDART_INF_F, l = 0.f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < sh.Lk; kt += kBK) {
    __syncthreads();  // Q is loaded; every warp is done with the last K/V tile
    load_tile<float, float, DP, LD>(Ks, k + c.k, st.k[3], kt, sh.Lk, sh.D);
    load_tile<float, float, DP, LD>(Vs, v + c.v, st.v[3], kt, sh.Lk, sh.D);
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
  store_row<float, DP>(o, c, st, sh, c.q0 + warp * 16 + r, half, acc, m, l, m_out, l_out);
}

// ------------------------------------------------------------------ launch

template <int DP>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   float* m, float* l, int B0, const Shape& sh, const Strides& st,
                   float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)((long long)B0 * sh.B1 * sh.H),
                  (unsigned)((sh.Lq + kBQ - 1) / kBQ));
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = TcSmem<DP>::bytes;
    err = cudaFuncSetAttribute(flash_fwd_wmma_bf16_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_wmma_bf16_kernel<DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), m, l, sh,
        st, scale_log2);
  } else {
    const size_t smem = FmaSmem<DP>::bytes;
    err = cudaFuncSetAttribute(flash_fwd_fma_f32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_fma_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), m, l, sh, st, scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: q, k, v, o, each (b0, b1, h, l)
// in elements. m, l: null, or contiguous f32 (B0, B1, H, Lq) buffers for the
// per-row residuals. Returns the cudaError_t of the launch.
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
    st.o[i] = strides[12 + i];
  }
  const Shape sh{B1, H, Lq, Lk, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return (int)launch<16>(dtype, q, k, v, o, m, l, B0, sh, st, scale, s);
    case 2: return (int)launch<32>(dtype, q, k, v, o, m, l, B0, sh, st, scale, s);
    case 3: return (int)launch<48>(dtype, q, k, v, o, m, l, B0, sh, st, scale, s);
    case 4: return (int)launch<64>(dtype, q, k, v, o, m, l, B0, sh, st, scale, s);
    case 5: return (int)launch<80>(dtype, q, k, v, o, m, l, B0, sh, st, scale, s);
    case 6: return (int)launch<96>(dtype, q, k, v, o, m, l, B0, sh, st, scale, s);
    case 7: return (int)launch<112>(dtype, q, k, v, o, m, l, B0, sh, st, scale, s);
    default: return (int)launch<128>(dtype, q, k, v, o, m, l, B0, sh, st, scale, s);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
