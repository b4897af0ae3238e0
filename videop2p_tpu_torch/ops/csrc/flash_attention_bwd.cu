// The backward of flash attention for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q.K^T * scale) . V, non-causal, from the forward's per-row
// residuals m (max of the scaled scores) and l (sum of exp(s - m)), written
// by flash_attention.cu, and di = sum_d O*dO (f32, computed by the caller).
//
// q, do, dq: (B0, B1, H, Lq, D); k, v, dk, dv: (B0, H, Lk, D), shared by the
// B1 query batches; all strided with a contiguous last dimension.
//   * flash:      B1 = F frames, each against frame 0's K/V;
//   * flash_rect: B1 = 1, frames folded into the query length Lq = F*N.
// dK and dV of the shared K/V are sums over every query of the B1 batches.
//
// Replaces the stock Pallas TPU backward kernels that JAX differentiates
// flash_frame_attention / flash_rect_frame_attention through
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
//   * _flash_attention_bwd_dkv (:941, pallas_call :1121, body :796):
//     flash_bwd_dkv_* below;
//   * _flash_attention_bwd_dq (:1287, pallas_call :1456, body :1146):
//     flash_bwd_dq_* below.
// The stock kernels carry dK/dV (dQ) in VMEM scratch across a sequential
// grid axis over query (key) blocks. Blocks of a CUDA grid run in no order,
// so each block here loops over that axis itself and writes its tile once.
//
// Math, per query row r and key c (s in natural-log units):
//   p  = exp(q.k * scale - m_r) / l_r
//   dV = sum_r p^T . dO                  dP = dO . V^T
//   dS = (dP - di_r) * p * scale         dK = sum_r dS^T . Q,   dQ = dS . K
// In bf16, p and dS are rounded to bf16 before their products, as the stock
// kernels do (p.T.astype(do.dtype), ds.T.astype(do.dtype), ds.astype(k.dtype));
// every product accumulates in f32 and each output is written once.
//
// Bound on this card: operations. 10*B*H*Lq*Lk*D FLOPs (S recomputed, dP,
// dV, dK, dQ; the dQ kernel recomputes S and dP once more, which the bound
// does not count) against B*H*(4*Lq + 4*Lk)*D elements moved.
//
// Design. Blocks of 4 warps and tiles of 64 rows, as in the forward.
//   * dK/dV: a block owns 64 keys (16 per warp) and walks all query tiles of
//     all B1 batches: no two blocks write one dK/dV row, so the sum over the
//     frames needs no atomics.
//   * dQ: a block owns 64 queries (16 per warp) and walks the key tiles.
//   * bfloat16: the four products of each tile run on the tensor cores as
//     WMMA 16x16x16 bf16 fragments with f32 accumulation, the head dimension
//     zero-padded to DP, a multiple of 16 (40 -> 48). The per-warp K/V (dK/dV
//     kernel) or Q/dO (dQ kernel) operands stay in fragments for the whole
//     walk, and so do the f32 dK, dV or dQ accumulators. The S and dP
//     fragments pass through a per-warp f32 scratch in shared memory, where
//     two lanes per row compute p and dS elementwise (a WMMA fragment's
//     element-to-row map is unspecified).
//   * float32: the same tiling on the CUDA cores, full fp32 FMAs (no TF32);
//     two lanes per row, each owning half of the 64 columns of the tile for
//     the scores and half of the head dimension for the accumulators.
//   * ragged lengths: rows past Lq load zeros and take an infinite
//     log-sum-exp, so p = 0; keys past Lk take p = 0; neither is stored.
// wgmma, TMA and a faster design are later work; the measured times sit in
// PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;      // rows per tile (queries or keys)
constexpr int kHalf = kTile / 2;        // columns per lane: two lanes share a row
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long q[4], dout[4], dq[4];  // (b0, b1, h, l)
  long long k[3], v[3], dk[3], dv[3];  // (b0, h, l)
};

struct Shape {
  int B1, H, Lq, Lk, D;
};

// The per-row inputs of one query batch (b0, b1, h): contiguous f32.
struct RowInputs {
  const float* m;
  const float* l;
  const float* di;
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
template <typename T, int DP, int LDS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld, int row0,
                                          int L, int D) {
  for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
    const int r = e / DP;
    const int d = e - r * DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < L && d < D) x = to_f32(src[(long long)row * ld + d]);
    dst[r * LDS + d] = from_f32<T>(x);
  }
}

// The log-sum-exp (log2 units) and di of rows [row0, row0 + 64): +inf past
// Lq, so that every p of such a row is exp2(-inf) = 0.
__device__ __forceinline__ void load_rows(float* lse, float* di, const RowInputs& in,
                                          int row0, int Lq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = row0 + r;
    const bool ok = row < Lq;
    lse[r] = ok ? in.m[row] * kLog2e + log2f(in.l[row]) : CUDART_INF_F;
    di[r] = ok ? in.di[row] : 0.f;
  }
}

__device__ __forceinline__ RowInputs row_inputs(const float* m, const float* l,
                                                const float* di, long long batch,
                                                int Lq) {
  const long long off = batch * Lq;
  return RowInputs{m + off, l + off, di + off};
}

// Rows of a warp's 16 x DP f32 block at `src` (row stride LDS) to global
// memory: rows row0 + r < L, columns < D.
template <typename T, int DP, int LDS>
__device__ __forceinline__ void store_warp_rows(T* dst, long long ld, const float* src,
                                                int row0, int L, int D) {
  const int lane = threadIdx.x % 32;
  for (int e = lane; e < 16 * DP; e += 32) {
    const int r = e / DP;
    const int d = e - r * DP;
    if (row0 + r < L && d < D) dst[(long long)(row0 + r) * ld + d] = from_f32<T>(src[r * LDS + d]);
  }
}

// ---------------------------------------------------------------- bfloat16

template <int DP>
struct TcSmem {
  static constexpr int LDQ = DP + 8;     // bf16 tiles; a multiple of 8 for WMMA
  static constexpr int LDP = kTile + 8;  // bf16 per-warp P / dS
  static constexpr int LDS = (DP > kTile ? DP : kTile) + 4;  // f32; multiple of 4
  // every region starts on a 32-byte boundary, as WMMA loads require
  static constexpr size_t tiles = (size_t)4 * kTile * LDQ * 2;
  static constexpr size_t pds = (size_t)kWarps * 2 * 16 * LDP * 2;
  static constexpr size_t sdp = (size_t)kWarps * 2 * 16 * LDS * 4;
  static constexpr size_t bytes = tiles + pds + sdp + 2 * kTile * 4;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out (16 x 64, f32 at `out`, row stride LDS) = A (16 x DP fragments) .
// T^T, where T is a 64 x DP row-major bf16 tile (row stride LDQ).
template <int DP, int LDQ, int LDS>
__device__ __forceinline__ void product_abt(float* out, const FragA (&a)[DP / 16],
                                            const __nv_bfloat16* t) {
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      FragBCol b;
      wmma::load_matrix_sync(b, t + j * 16 * LDQ + kd * 16, LDQ);
      wmma::mma_sync(c, a[kd], b, c);
    }
    wmma::store_matrix_sync(out + j * 16, c, LDS, wmma::mem_row_major);
  }
}

// acc (16 x DP) += A (16 x 64 bf16 at `a`, row stride LDP) . T, where T is
// a 64 x DP row-major bf16 tile (row stride LDQ).
template <int DP, int LDQ, int LDP>
__device__ __forceinline__ void accumulate_at(FragC (&acc)[DP / 16], const __nv_bfloat16* a,
                                              const __nv_bfloat16* t) {
  FragA af[kTile / 16];
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) wmma::load_matrix_sync(af[kk], a + kk * 16, LDP);
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      FragBRow b;
      wmma::load_matrix_sync(b, t + kk * 16 * LDQ + n * 16, LDQ);
      wmma::mma_sync(acc[n], af[kk], b, acc[n]);
    }
  }
}

template <typename T, int DP, int LDS>
__device__ __forceinline__ void store_acc(T* dst, long long ld, float* scratch,
                                          FragC (&acc)[DP / 16], int row0, int L, int D) {
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(scratch + n * 16, acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  store_warp_rows<T, DP, LDS>(dst, ld, scratch, row0, L, D);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wmma_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ m, const float* __restrict__ l,
                               const float* __restrict__ di,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, Shape sh, Strides st,
                               float scale) {
  using L = TcSmem<DP>;
  constexpr int LDQ = L::LDQ, LDP = L::LDP, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * LDQ;
  __nv_bfloat16* Qs = Vs + kTile * LDQ;
  __nv_bfloat16* dOs = Qs + kTile * LDQ;
  __nv_bfloat16* Pbuf = dOs + kTile * LDQ;
  float* Sbuf = reinterpret_cast<float*>(smem + L::tiles + L::pds);
  float* lse = reinterpret_cast<float*>(smem + L::tiles + L::pds + L::sdp);
  float* dis = lse + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int h = blockIdx.x % sh.H;
  const int b0 = blockIdx.x / sh.H;
  const int k0 = blockIdx.y * kTile;
  __nv_bfloat16* Pw = Pbuf + warp * 2 * 16 * LDP;  // P^T of the warp's keys
  __nv_bfloat16* dSw = Pw + 16 * LDP;              // dS^T
  float* Sw = Sbuf + warp * 2 * 16 * LDS;           // S^T, then the outputs
  float* dPw = Sw + 16 * LDS;                       // dP^T
  const bool key_ok = k0 + warp * 16 + r < sh.Lk;

  load_tile<__nv_bfloat16, DP, LDQ>(Ks, k + b0 * st.k[0] + h * st.k[1], st.k[2], k0,
                                    sh.Lk, sh.D);
  load_tile<__nv_bfloat16, DP, LDQ>(Vs, v + b0 * st.v[0] + h * st.v[1], st.v[2], k0,
                                    sh.Lk, sh.D);
  __syncthreads();
  FragA kf[DP / 16], vf[DP / 16];
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    wmma::load_matrix_sync(kf[kd], Ks + warp * 16 * LDQ + kd * 16, LDQ);
    wmma::load_matrix_sync(vf[kd], Vs + warp * 16 * LDQ + kd * 16, LDQ);
  }
  FragC dk_acc[DP / 16], dv_acc[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  const float scale_log2 = scale * kLog2e;

  for (int b1 = 0; b1 < sh.B1; ++b1) {
    const __nv_bfloat16* qb = q + b0 * st.q[0] + b1 * st.q[1] + h * st.q[2];
    const __nv_bfloat16* dob = dout + b0 * st.dout[0] + b1 * st.dout[1] + h * st.dout[2];
    const RowInputs rows = row_inputs(m, l, di, ((long long)b0 * sh.B1 + b1) * sh.H + h,
                                      sh.Lq);
    for (int q0 = 0; q0 < sh.Lq; q0 += kTile) {
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<__nv_bfloat16, DP, LDQ>(Qs, qb, st.q[3], q0, sh.Lq, sh.D);
      load_tile<__nv_bfloat16, DP, LDQ>(dOs, dob, st.dout[3], q0, sh.Lq, sh.D);
      load_rows(lse, dis, rows, q0, sh.Lq);
      __syncthreads();

      // S^T = K_w . Q^T and dP^T = V_w . dO^T: the warp's 16 keys x 64 queries
      product_abt<DP, LDQ, LDS>(Sw, kf, Qs);
      product_abt<DP, LDQ, LDS>(dPw, vf, dOs);
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < kHalf; ++j) {
        const int c = half + 2 * j;
        const float p = key_ok ? exp2f(Sw[r * LDS + c] * scale_log2 - lse[c]) : 0.f;
        const float ds = p * (dPw[r * LDS + c] - dis[c]) * scale;
        Pw[r * LDP + c] = __float2bfloat16(p);
        dSw[r * LDP + c] = __float2bfloat16(ds);
      }
      __syncwarp();
      // dV_w += P^T . dO, dK_w += dS^T . Q
      accumulate_at<DP, LDQ, LDP>(dv_acc, Pw, dOs);
      accumulate_at<DP, LDQ, LDP>(dk_acc, dSw, Qs);
    }
  }
  const int row0 = k0 + warp * 16;
  store_acc<__nv_bfloat16, DP, LDS>(dk + b0 * st.dk[0] + h * st.dk[1], st.dk[2], Sw, dk_acc,
                                    row0, sh.Lk, sh.D);
  __syncwarp();
  store_acc<__nv_bfloat16, DP, LDS>(dv + b0 * st.dv[0] + h * st.dv[1], st.dv[2], Sw, dv_acc,
                                    row0, sh.Lk, sh.D);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wmma_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ m, const float* __restrict__ l,
                              const float* __restrict__ di,
                              __nv_bfloat16* __restrict__ dq, Shape sh, Strides st,
                              float scale) {
  using L = TcSmem<DP>;
  constexpr int LDQ = L::LDQ, LDP = L::LDP, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kTile * LDQ;
  __nv_bfloat16* Ks = dOs + kTile * LDQ;
  __nv_bfloat16* Vs = Ks + kTile * LDQ;
  __nv_bfloat16* Pbuf = Vs + kTile * LDQ;
  float* Sbuf = reinterpret_cast<float*>(smem + L::tiles + L::pds);
  float* lse = reinterpret_cast<float*>(smem + L::tiles + L::pds + L::sdp);
  float* dis = lse + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  // blockIdx.x flattens (b0, b1, h)
  const int h = blockIdx.x % sh.H;
  const int b = blockIdx.x / sh.H;
  const int b1 = b % sh.B1;
  const int b0 = b / sh.B1;
  const int q0 = blockIdx.y * kTile;
  __nv_bfloat16* dSw = Pbuf + warp * 2 * 16 * LDP;
  float* Sw = Sbuf + warp * 2 * 16 * LDS;
  float* dPw = Sw + 16 * LDS;
  const __nv_bfloat16* kb = k + b0 * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vb = v + b0 * st.v[0] + h * st.v[1];

  load_tile<__nv_bfloat16, DP, LDQ>(Qs, q + b0 * st.q[0] + b1 * st.q[1] + h * st.q[2],
                                    st.q[3], q0, sh.Lq, sh.D);
  load_tile<__nv_bfloat16, DP, LDQ>(
      dOs, dout + b0 * st.dout[0] + b1 * st.dout[1] + h * st.dout[2], st.dout[3], q0, sh.Lq,
      sh.D);
  load_rows(lse, dis, row_inputs(m, l, di, blockIdx.x, sh.Lq), q0, sh.Lq);
  __syncthreads();
  FragA qf[DP / 16], dof[DP / 16];
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    wmma::load_matrix_sync(qf[kd], Qs + warp * 16 * LDQ + kd * 16, LDQ);
    wmma::load_matrix_sync(dof[kd], dOs + warp * 16 * LDQ + kd * 16, LDQ);
  }
  FragC dq_acc[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);
  const float scale_log2 = scale * kLog2e;
  const float row_lse = lse[warp * 16 + r];
  const float row_di = dis[warp * 16 + r];

  for (int k0 = 0; k0 < sh.Lk; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<__nv_bfloat16, DP, LDQ>(Ks, kb, st.k[2], k0, sh.Lk, sh.D);
    load_tile<__nv_bfloat16, DP, LDQ>(Vs, vb, st.v[2], k0, sh.Lk, sh.D);
    __syncthreads();

    // S = Q_w . K^T and dP = dO_w . V^T: the warp's 16 queries x 64 keys
    product_abt<DP, LDQ, LDS>(Sw, qf, Ks);
    product_abt<DP, LDQ, LDS>(dPw, dof, Vs);
    __syncwarp();
    const int nk = min(kTile, sh.Lk - k0);
#pragma unroll 4
    for (int j = 0; j < kHalf; ++j) {
      const int c = half + 2 * j;
      const float p = c < nk ? exp2f(Sw[r * LDS + c] * scale_log2 - row_lse) : 0.f;
      dSw[r * LDP + c] = __float2bfloat16(p * (dPw[r * LDS + c] - row_di) * scale);
    }
    __syncwarp();
    // dQ_w += dS . K
    accumulate_at<DP, LDQ, LDP>(dq_acc, dSw, Ks);
  }
  store_acc<__nv_bfloat16, DP, LDS>(dq + b0 * st.dq[0] + b1 * st.dq[1] + h * st.dq[2],
                                    st.dq[3], Sw, dq_acc, q0 + warp * 16, sh.Lq, sh.D);
}

// ----------------------------------------------------------------- float32

template <int DP>
struct FmaSmem {
  static constexpr int LD = DP + 1;      // odd: a warp's 16 rows hit 16 banks
  static constexpr int LDP = kTile + 1;
  static constexpr size_t bytes =
      ((size_t)4 * kTile * LD + (size_t)kWarps * 2 * 16 * LDP + 2 * kTile) * 4;
};

// s[j] += a . t[half + 2j] and u[j] += b . w[half + 2j] over the head
// dimension, for a lane's 32 columns of two 64 x DP tiles t, w (row stride LD).
template <int DP, int LD>
__device__ __forceinline__ void dot_rows(float (&s)[kHalf], float (&u)[kHalf],
                                         const float* a, const float* t, const float* b,
                                         const float* w, int half, int D) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) s[j] = u[j] = 0.f;
  // columns past D are zero in every tile: stop at D rounded up to 8
  for (int d0 = 0; d0 < DP && d0 < D; d0 += 8) {
#pragma unroll
    for (int dd = 0; dd < 8; ++dd) {
      const float av = a[d0 + dd];
      const float bv = b[d0 + dd];
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        s[j] = fmaf(av, t[(half + 2 * j) * LD + d0 + dd], s[j]);
        u[j] = fmaf(bv, w[(half + 2 * j) * LD + d0 + dd], u[j]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fma_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ m, const float* __restrict__ l,
                             const float* __restrict__ di, float* __restrict__ dk,
                             float* __restrict__ dv, Shape sh, Strides st, float scale) {
  using L = FmaSmem<DP>;
  constexpr int LD = L::LD, LDP = L::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Pbuf = dOs + kTile * LD;
  float* lse = Pbuf + kWarps * 2 * 16 * LDP;
  float* dis = lse + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int h = blockIdx.x % sh.H;
  const int b0 = blockIdx.x / sh.H;
  const int k0 = blockIdx.y * kTile;
  float* Pw = Pbuf + warp * 2 * 16 * LDP;
  float* dSw = Pw + 16 * LDP;
  const int key = warp * 16 + r;
  const bool key_ok = k0 + key < sh.Lk;

  load_tile<float, DP, LD>(Ks, k + b0 * st.k[0] + h * st.k[1], st.k[2], k0, sh.Lk, sh.D);
  load_tile<float, DP, LD>(Vs, v + b0 * st.v[0] + h * st.v[1], st.v[2], k0, sh.Lk, sh.D);
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int b1 = 0; b1 < sh.B1; ++b1) {
    const float* qb = q + b0 * st.q[0] + b1 * st.q[1] + h * st.q[2];
    const float* dob = dout + b0 * st.dout[0] + b1 * st.dout[1] + h * st.dout[2];
    const RowInputs rows = row_inputs(m, l, di, ((long long)b0 * sh.B1 + b1) * sh.H + h,
                                      sh.Lq);
    for (int q0 = 0; q0 < sh.Lq; q0 += kTile) {
      __syncthreads();  // K/V are loaded; every warp is done with the last Q/dO tile
      load_tile<float, DP, LD>(Qs, qb, st.q[3], q0, sh.Lq, sh.D);
      load_tile<float, DP, LD>(dOs, dob, st.dout[3], q0, sh.Lq, sh.D);
      load_rows(lse, dis, rows, q0, sh.Lq);
      __syncthreads();

      // the lane's key against queries half + 2j: S^T and dP^T
      float s[kHalf], dp[kHalf];
      dot_rows<DP, LD>(s, dp, Ks + key * LD, Qs, Vs + key * LD, dOs, half, sh.D);
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const int c = half + 2 * j;
        const float p = key_ok ? exp2f(s[j] * scale_log2 - lse[c]) : 0.f;
        Pw[r * LDP + c] = p;
        dSw[r * LDP + c] = p * (dp[j] - dis[c]) * scale;
      }
      __syncwarp();
      // dV += P^T . dO and dK += dS^T . Q over the valid queries
      const int nq = min(kTile, sh.Lq - q0);
      for (int c = 0; c < nq; ++c) {
        const float p = Pw[r * LDP + c];
        const float ds = dSw[r * LDP + c];
        const float* dor = dOs + c * LD + half;
        const float* qr = Qs + c * LD + half;
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) {
          dv_acc[i] = fmaf(p, dor[2 * i], dv_acc[i]);
          dk_acc[i] = fmaf(ds, qr[2 * i], dk_acc[i]);
        }
      }
      __syncwarp();
    }
  }
  if (!key_ok) return;
  float* dkr = dk + b0 * st.dk[0] + h * st.dk[1] + (long long)(k0 + key) * st.dk[2];
  float* dvr = dv + b0 * st.dv[0] + h * st.dv[1] + (long long)(k0 + key) * st.dv[2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int d = half + 2 * i;
    if (d < sh.D) {
      dkr[d] = dk_acc[i];
      dvr[d] = dv_acc[i];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fma_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ m, const float* __restrict__ l,
                            const float* __restrict__ di, float* __restrict__ dq, Shape sh,
                            Strides st, float scale) {
  using L = FmaSmem<DP>;
  constexpr int LD = L::LD, LDP = L::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Pbuf = Vs + kTile * LD;
  float* lse = Pbuf + kWarps * 2 * 16 * LDP;
  float* dis = lse + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int h = blockIdx.x % sh.H;
  const int b = blockIdx.x / sh.H;
  const int b1 = b % sh.B1;
  const int b0 = b / sh.B1;
  const int q0 = blockIdx.y * kTile;
  const int row = warp * 16 + r;
  float* dSw = Pbuf + warp * 2 * 16 * LDP;
  const float* kb = k + b0 * st.k[0] + h * st.k[1];
  const float* vb = v + b0 * st.v[0] + h * st.v[1];

  load_tile<float, DP, LD>(Qs, q + b0 * st.q[0] + b1 * st.q[1] + h * st.q[2], st.q[3], q0,
                           sh.Lq, sh.D);
  load_tile<float, DP, LD>(dOs, dout + b0 * st.dout[0] + b1 * st.dout[1] + h * st.dout[2],
                           st.dout[3], q0, sh.Lq, sh.D);
  load_rows(lse, dis, row_inputs(m, l, di, blockIdx.x, sh.Lq), q0, sh.Lq);
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int k0 = 0; k0 < sh.Lk; k0 += kTile) {
    __syncthreads();  // Q/dO are loaded; every warp is done with the last K/V tile
    load_tile<float, DP, LD>(Ks, kb, st.k[2], k0, sh.Lk, sh.D);
    load_tile<float, DP, LD>(Vs, vb, st.v[2], k0, sh.Lk, sh.D);
    __syncthreads();

    // the lane's query against keys half + 2j: S and dP
    float s[kHalf], dp[kHalf];
    dot_rows<DP, LD>(s, dp, Qs + row * LD, Ks, dOs + row * LD, Vs, half, sh.D);
    const int nk = min(kTile, sh.Lk - k0);
    const float row_lse = lse[row];
    const float row_di = dis[row];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int c = half + 2 * j;
      const float p = c < nk ? exp2f(s[j] * scale_log2 - row_lse) : 0.f;
      dSw[r * LDP + c] = p * (dp[j] - row_di) * scale;
    }
    __syncwarp();
    // dQ += dS . K
    for (int c = 0; c < nk; ++c) {
      const float ds = dSw[r * LDP + c];
      const float* kr = Ks + c * LD + half;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dq_acc[i] = fmaf(ds, kr[2 * i], dq_acc[i]);
    }
    __syncwarp();
  }
  const int qrow = q0 + row;
  if (qrow >= sh.Lq) return;
  float* dqr = dq + b0 * st.dq[0] + b1 * st.dq[1] + h * st.dq[2] + (long long)qrow * st.dq[3];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int d = half + 2 * i;
    if (d < sh.D) dqr[d] = dq_acc[i];
  }
}

// ------------------------------------------------------------------ launch

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const float* m, const float* l, const float* di,
                       void* dk, void* dv, int B0, const Shape& sh, const Strides& st,
                       float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)((long long)B0 * sh.H), (unsigned)((sh.Lk + kTile - 1) / kTile));
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    err = allow_smem(flash_bwd_dkv_wmma_bf16_kernel<DP>, TcSmem<DP>::bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_wmma_bf16_kernel<DP><<<grid, kThreads, TcSmem<DP>::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), m, l, di, static_cast<T*>(dk), static_cast<T*>(dv), sh,
        st, scale);
  } else {
    err = allow_smem(flash_bwd_dkv_fma_f32_kernel<DP>, FmaSmem<DP>::bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_fma_f32_kernel<DP><<<grid, kThreads, FmaSmem<DP>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), m, l, di,
        static_cast<float*>(dk), static_cast<float*>(dv), sh, st, scale);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const float* m, const float* l, const float* di,
                      void* dq, int B0, const Shape& sh, const Strides& st, float scale,
                      cudaStream_t stream) {
  const dim3 grid((unsigned)((long long)B0 * sh.B1 * sh.H),
                  (unsigned)((sh.Lq + kTile - 1) / kTile));
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    err = allow_smem(flash_bwd_dq_wmma_bf16_kernel<DP>, TcSmem<DP>::bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_wmma_bf16_kernel<DP><<<grid, kThreads, TcSmem<DP>::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), m, l, di, static_cast<T*>(dq), sh, st, scale);
  } else {
    err = allow_smem(flash_bwd_dq_fma_f32_kernel<DP>, FmaSmem<DP>::bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_fma_f32_kernel<DP><<<grid, kThreads, FmaSmem<DP>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), m, l, di,
        static_cast<float*>(dq), sh, st, scale);
  }
  return cudaGetLastError();
}

bool parse(int dtype, int B0, int B1, int H, int Lq, int Lk, int D, const long long* strides,
           Shape* sh, Strides* st) {
  if (D < 1 || D > 128 || Lq < 1 || Lk < 1 || B0 < 1 || B1 < 1 || H < 1) return false;
  if ((long long)B0 * B1 * H > 0x7fffffffLL) return false;
  if ((Lq + kTile - 1) / kTile > 65535 || (Lk + kTile - 1) / kTile > 65535) return false;
  if (dtype != 0 && dtype != 1) return false;
  for (int i = 0; i < 4; ++i) {
    st->q[i] = strides[i];
    st->dout[i] = strides[4 + i];
    st->dq[i] = strides[8 + i];
  }
  for (int i = 0; i < 3; ++i) {
    st->k[i] = strides[12 + i];
    st->v[i] = strides[15 + i];
    st->dk[i] = strides[18 + i];
    st->dv[i] = strides[21 + i];
  }
  *sh = Shape{B1, H, Lq, Lk, D};
  return true;
}

}  // namespace

// The dK/dV kernel. dtype: 0 = float32, 1 = bfloat16. m, l, di: contiguous
// f32 (B0, B1, H, Lq). strides (in elements): q, dout, dq (each b0, b1, h,
// l), then k, v, dk, dv (each b0, h, l); dq's are not read here. Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* m, const float* l,
                                       const float* di, void* dk, void* dv, int dtype,
                                       int B0, int B1, int H, int Lq, int Lk, int D,
                                       const long long* strides, float scale,
                                       void* stream) {
  Shape sh;
  Strides st;
  if (dk == nullptr || dv == nullptr ||
      !parse(dtype, B0, B1, H, Lq, Lk, D, strides, &sh, &st))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return (int)launch_dkv<16>(dtype, q, k, v, dout, m, l, di, dk, dv, B0, sh, st, scale, s);
    case 2: return (int)launch_dkv<32>(dtype, q, k, v, dout, m, l, di, dk, dv, B0, sh, st, scale, s);
    case 3: return (int)launch_dkv<48>(dtype, q, k, v, dout, m, l, di, dk, dv, B0, sh, st, scale, s);
    case 4: return (int)launch_dkv<64>(dtype, q, k, v, dout, m, l, di, dk, dv, B0, sh, st, scale, s);
    case 5: return (int)launch_dkv<80>(dtype, q, k, v, dout, m, l, di, dk, dv, B0, sh, st, scale, s);
    case 6: return (int)launch_dkv<96>(dtype, q, k, v, dout, m, l, di, dk, dv, B0, sh, st, scale, s);
    case 7: return (int)launch_dkv<112>(dtype, q, k, v, dout, m, l, di, dk, dv, B0, sh, st, scale, s);
    default: return (int)launch_dkv<128>(dtype, q, k, v, dout, m, l, di, dk, dv, B0, sh, st, scale, s);
  }
}

// The dQ kernel: the same arguments as flash_attention_bwd_dkv, with dq in
// the place of dk and an unused dv.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* m, const float* l,
                                      const float* di, void* dq, void* unused, int dtype,
                                      int B0, int B1, int H, int Lq, int Lk, int D,
                                      const long long* strides, float scale, void* stream) {
  (void)unused;
  Shape sh;
  Strides st;
  if (dq == nullptr || !parse(dtype, B0, B1, H, Lq, Lk, D, strides, &sh, &st))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return (int)launch_dq<16>(dtype, q, k, v, dout, m, l, di, dq, B0, sh, st, scale, s);
    case 2: return (int)launch_dq<32>(dtype, q, k, v, dout, m, l, di, dq, B0, sh, st, scale, s);
    case 3: return (int)launch_dq<48>(dtype, q, k, v, dout, m, l, di, dq, B0, sh, st, scale, s);
    case 4: return (int)launch_dq<64>(dtype, q, k, v, dout, m, l, di, dq, B0, sh, st, scale, s);
    case 5: return (int)launch_dq<80>(dtype, q, k, v, dout, m, l, di, dq, B0, sh, st, scale, s);
    case 6: return (int)launch_dq<96>(dtype, q, k, v, dout, m, l, di, dq, B0, sh, st, scale, s);
    case 7: return (int)launch_dq<112>(dtype, q, k, v, dout, m, l, di, dq, B0, sh, st, scale, s);
    default: return (int)launch_dq<128>(dtype, q, k, v, dout, m, l, di, dq, B0, sh, st, scale, s);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
