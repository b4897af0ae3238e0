// The backward of flash attention for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q.K^T * scale) . V, non-causal, from the forward's per-row
// residuals m (max of the scaled scores) and l (sum of exp(s - m)), written
// by flash_attention.cu, and di = sum_d O*dO (f32; computed by the caller in
// float32, by the dQ kernel in bfloat16).
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
//     flash_bwd_dkv_* (float32 below, bfloat16 in flash_attention_bwd_sm90.cuh);
//   * _flash_attention_bwd_dq (:1287, pallas_call :1456, body :1146):
//     flash_bwd_dq_* (likewise).
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
// bfloat16: the Hopper warpgroup core of flash_attention_bwd_sm90.cuh (wgmma
// on the tensor cores, Q/dO or K/V tiles fed by TMA, p and dS in
// registers, the dK/dV query walk split over a thread-block cluster where
// the key blocks alone leave SMs idle); the design and its bounds are
// described there. The TMA maps read q and dO in place, so their base
// addresses are 16-byte aligned and their strides multiples of 8 elements
// (ops/attention.py checks q in the forward and makes a grad_out TMA cannot
// read contiguous).
//
// float32: blocks of 4 warps and tiles of 64 rows on the CUDA cores, full
// fp32 FMAs (no TF32); two lanes per row, each owning half of the 64
// columns of the tile for the scores and half of the head dimension for
// the accumulators.
//   * dK/dV: a block owns 64 keys (16 per warp) and walks all query tiles of
//     all B1 batches: no two blocks write one dK/dV row, so the sum over the
//     frames needs no atomics.
//   * dQ: a block owns 64 queries (16 per warp) and walks the key tiles.
//   * ragged lengths: rows past Lq load zeros and take an infinite
//     log-sum-exp, so p = 0; keys past Lk take p = 0; neither is stored.
// The measured times sit in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_attention_bwd_sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;      // rows per tile (queries or keys)
constexpr int kHalf = kTile / 2;        // columns per lane: two lanes share a row
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long q[4], o[4], dout[4], dq[4];  // (b0, b1, h, l)
  long long k[3], v[3], dk[3], dv[3];    // (b0, h, l)
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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const float* m, const float* l, const float* di, void* dk, void* dv,
                           int B0, const Shape& sh, const Strides& st, float scale,
                           cudaStream_t stream) {
  const dim3 grid((unsigned)((long long)B0 * sh.H), (unsigned)((sh.Lk + kTile - 1) / kTile));
  const cudaError_t err = allow_smem(flash_bwd_dkv_fma_f32_kernel<DP>, FmaSmem<DP>::bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_fma_f32_kernel<DP><<<grid, kThreads, FmaSmem<DP>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), m, l, di,
      static_cast<float*>(dk), static_cast<float*>(dv), sh, st, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const float* m, const float* l, const float* di, void* dq, int B0,
                          const Shape& sh, const Strides& st, float scale,
                          cudaStream_t stream) {
  const dim3 grid((unsigned)((long long)B0 * sh.B1 * sh.H),
                  (unsigned)((sh.Lq + kTile - 1) / kTile));
  const cudaError_t err = allow_smem(flash_bwd_dq_fma_f32_kernel<DP>, FmaSmem<DP>::bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_fma_f32_kernel<DP><<<grid, kThreads, FmaSmem<DP>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), m, l, di,
      static_cast<float*>(dq), sh, st, scale);
  return cudaGetLastError();
}

// The bf16 kernels of the warpgroup core: the dQ kernel (which also writes
// `rows`), or the dK/dV kernel (which reads them), its query walk split over
// `split` CTAs of a cluster.
cudaError_t launch_bf16(bool dkv, const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* m, const float* l, float* rows,
                        void* out0, void* out1, int B0, const Shape& sh, const Strides& st,
                        float scale, int split, cudaStream_t stream) {
  using T = __nv_bfloat16;
  if ((long long)B0 * sh.H > 65535 || rows == nullptr || (!dkv && o == nullptr))
    return cudaErrorInvalidValue;
  sm90::bwd::Problem p{};
  p.q = static_cast<const T*>(q);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.m = m;
  p.l = l;
  p.rows = rows;
  p.dq = dkv ? nullptr : static_cast<T*>(out0);
  p.dk = dkv ? static_cast<T*>(out0) : nullptr;
  p.dv = dkv ? static_cast<T*>(out1) : nullptr;
  for (int i = 0; i < 4; ++i) {
    p.q_st[i] = st.q[i];
    p.o_st[i] = st.o[i];
    p.do_st[i] = st.dout[i];
    p.dq_st[i] = st.dq[i];
  }
  for (int i = 0; i < 3; ++i) {
    p.dk_st[i] = st.dk[i];
    p.dv_st[i] = st.dv[i];
  }
  p.B1 = sh.B1;
  p.H = sh.H;
  p.Lq = sh.Lq;
  p.Lk = sh.Lk;
  p.D = sh.D;
  p.split = split;
  p.scale = scale;
  const long long k_st[3] = {st.k[0], st.k[1], st.k[2]};
  const long long v_st[3] = {st.v[0], st.v[1], st.v[2]};
  return sm90::dispatch_dp(sh.D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return dkv ? sm90::bwd::launch_dkv<DP>(p, B0, k, k_st, v, v_st, stream)
               : sm90::bwd::launch_dq<DP>(p, B0, k, k_st, v, v_st, stream);
  });
}

bool parse(int dtype, int B0, int B1, int H, int Lq, int Lk, int D, const long long* strides,
           Shape* sh, Strides* st) {
  if (D < 1 || D > 128 || Lq < 1 || Lk < 1 || B0 < 1 || B1 < 1 || H < 1) return false;
  if ((long long)B0 * B1 * H > 0x7fffffffLL) return false;
  if ((Lq + kTile - 1) / kTile > 65535 || (Lk + kTile - 1) / kTile > 65535) return false;
  if (dtype != 0 && dtype != 1) return false;
  for (int i = 0; i < 4; ++i) {
    st->q[i] = strides[i];
    st->o[i] = strides[4 + i];
    st->dout[i] = strides[8 + i];
    st->dq[i] = strides[12 + i];
  }
  for (int i = 0; i < 3; ++i) {
    st->k[i] = strides[16 + i];
    st->v[i] = strides[19 + i];
    st->dk[i] = strides[22 + i];
    st->dv[i] = strides[25 + i];
  }
  *sh = Shape{B1, H, Lq, Lk, D};
  return true;
}

}  // namespace

// The dQ kernel, launched first. dtype: 0 = float32, 1 = bfloat16. m, l:
// contiguous f32 (B0, B1, H, Lq). strides (in elements): q, o, dout, dq
// (each b0, b1, h, l), then k, v, dk, dv (each b0, h, l); dk's and dv's
// are not read here. float32 reads di, contiguous f32 (B0, B1, H, Lq)
// computed by the caller, and ignores o and rows; bfloat16 computes di from
// o and dout itself and writes each row's lse and di * scale to rows, f32
// (B0 * B1 * H, ceil(Lq / 64), 2, 64), for the dK/dV kernel. Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* m, const float* l,
                                      const float* di, float* rows, void* dq, int dtype, int B0,
                                      int B1, int H, int Lq, int Lk, int D,
                                      const long long* strides, float scale, void* stream) {
  Shape sh;
  Strides st;
  if (dq == nullptr || !parse(dtype, B0, B1, H, Lq, Lk, D, strides, &sh, &st))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_bf16(false, q, k, v, o, dout, m, l, rows, dq, nullptr, B0, sh, st, scale,
                            1, s);
  if (di == nullptr) return (int)cudaErrorInvalidValue;
  return (int)sm90::dispatch_dp(D, [&](auto dp) {
    return launch_dq_f32<decltype(dp)::value>(q, k, v, dout, m, l, di, dq, B0, sh, st, scale,
                                              s);
  });
}

// The dK/dV kernel, launched after the dQ kernel on the same stream: the
// same arguments, with dk and dv in the place of dq; bfloat16 reads rows
// (not m, l, di). split: the CTAs of a cluster that share one key block's
// query walk (bfloat16: 1 .. 8; float32: 1).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* m,
                                       const float* l, const float* di, float* rows, void* dk,
                                       void* dv, int dtype, int B0, int B1, int H, int Lq,
                                       int Lk, int D, const long long* strides, float scale,
                                       int split, void* stream) {
  Shape sh;
  Strides st;
  if (dk == nullptr || dv == nullptr || split < 1 || split > 8 ||
      !parse(dtype, B0, B1, H, Lq, Lk, D, strides, &sh, &st))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_bf16(true, q, k, v, o, dout, m, l, rows, dk, dv, B0, sh, st, scale, split,
                            s);
  if (split != 1 || di == nullptr) return (int)cudaErrorInvalidValue;
  return (int)sm90::dispatch_dp(D, [&](auto dp) {
    return launch_dkv_f32<decltype(dp)::value>(q, k, v, dout, m, l, di, dk, dv, B0, sh, st,
                                               scale, s);
  });
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
