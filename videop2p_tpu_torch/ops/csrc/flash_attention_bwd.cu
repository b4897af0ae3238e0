// The backward of flash attention for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q.K^T * scale) . V, non-causal, from the forward's per-row
// residuals m (max of the scaled scores) and l (sum of exp(s - m)), written
// by flash_attention.cu, and di = sum_d O*dO (f32; computed by the dQ kernel
// in bfloat16, by the float32 prep kernel in float32).
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
//     flash_bwd_dkv_* (bfloat16 in flash_attention_bwd_sm90.cuh, float32 in
//     flash_attention_bwd_tf32_sm90.cuh);
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
// float32: the Hopper warpgroup core of flash_attention_bwd_tf32_sm90.cuh
// (wgmma on the TF32 tensor cores with error-compensated 3xTF32 products, a
// prep kernel that writes ready hi/lo tiles in both layouts, tiles fed by
// bulk copies); the design and its bounds are described there. Its prep
// kernel reads q, o, dO, k, v at any strides with a contiguous last
// dimension and computes di itself.
// The measured times sit in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_attention_bwd_sm90.cuh"
#include "flash_attention_bwd_tf32_sm90.cuh"

namespace {

constexpr int kTile = 64;  // the bf16 kernels' query and key tiles bound the grid

struct Strides {
  long long q[4], o[4], dout[4], dq[4];  // (b0, b1, h, l)
  long long k[3], v[3], dk[3], dv[3];    // (b0, h, l)
};

struct Shape {
  int B1, H, Lq, Lk, D;
};

// The float32 problem of the TF32 core; scratch: the prep kernel's tiles.
sm90::tf32::Problem f32_problem(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* m, const float* l,
                                void* scratch, const Shape& sh, const Strides& st,
                                float scale) {
  sm90::tf32::Problem p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.m = m;
  p.l = l;
  p.scratch = static_cast<uint8_t*>(scratch);
  for (int i = 0; i < 4; ++i) {
    p.q_st[i] = st.q[i];
    p.o_st[i] = st.o[i];
    p.do_st[i] = st.dout[i];
    p.dq_st[i] = st.dq[i];
  }
  for (int i = 0; i < 3; ++i) {
    p.k_st[i] = st.k[i];
    p.v_st[i] = st.v[i];
    p.dk_st[i] = st.dk[i];
    p.dv_st[i] = st.dv[i];
  }
  p.B1 = sh.B1;
  p.H = sh.H;
  p.Lq = sh.Lq;
  p.Lk = sh.Lk;
  p.D = sh.D;
  p.scale = scale;
  return p;
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
  if ((long long)B0 * B1 * H > 0x7fffffffLL || (long long)B0 * H > 65535) return false;
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

// The bytes of the float32 kernels' scratch for one problem (0 for a shape
// they do not take), into *bytes. Returns a cudaError_t.
extern "C" int flash_attention_bwd_scratch_bytes(int B0, int B1, int H, int Lq, int Lk, int D,
                                                 long long* bytes) {
  Shape sh;
  Strides st;
  long long zeros[28] = {};
  *bytes = 0;
  if (!parse(0, B0, B1, H, Lq, Lk, D, zeros, &sh, &st)) return (int)cudaErrorInvalidValue;
  sm90::tf32::Problem p{};
  p.B1 = B1;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  return (int)sm90::tf32::dispatch_dp(D, [&](auto dp) {
    *bytes = sm90::tf32::geometry<decltype(dp)::value>(p, B0);
    return cudaSuccess;
  });
}

// The dQ kernel, launched first. dtype: 0 = float32, 1 = bfloat16. m, l:
// contiguous f32 (B0, B1, H, Lq). strides (in elements): q, o, dout, dq
// (each b0, b1, h, l), then k, v, dk, dv (each b0, h, l); dk's and dv's
// are not read here. bfloat16 computes di from o and dout itself and
// writes each row's lse and di * scale to rows, f32 (B0 * B1 * H,
// ceil(Lq / 64), 2, 64), for the dK/dV kernel; float32 runs the prep kernel
// first, which writes the tiles of both kernels (and each row's lse and
// di * scale) to rows, a scratch of flash_attention_bwd_scratch_bytes.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* m, const float* l,
                                      float* rows, void* dq, int dtype, int B0, int B1, int H,
                                      int Lq, int Lk, int D, const long long* strides,
                                      float scale, void* stream) {
  Shape sh;
  Strides st;
  if (dq == nullptr || rows == nullptr || o == nullptr ||
      !parse(dtype, B0, B1, H, Lq, Lk, D, strides, &sh, &st))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_bf16(false, q, k, v, o, dout, m, l, rows, dq, nullptr, B0, sh, st, scale,
                            1, s);
  sm90::tf32::Problem p = f32_problem(q, k, v, o, dout, m, l, rows, sh, st, scale);
  p.dq = static_cast<float*>(dq);
  return (int)sm90::tf32::dispatch_dp(D, [&](auto dp) {
    return sm90::tf32::launch_dq<decltype(dp)::value>(p, B0, s);
  });
}

// The dK/dV kernel, launched after the dQ kernel on the same stream: the
// same arguments, with dk and dv in the place of dq; it reads rows (not m,
// l). split: the CTAs of a cluster that share one key block's query walk
// (bfloat16: 1 .. 8; float32: 1).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* m,
                                       const float* l, float* rows, void* dk, void* dv,
                                       int dtype, int B0, int B1, int H, int Lq, int Lk, int D,
                                       const long long* strides, float scale, int split,
                                       void* stream) {
  Shape sh;
  Strides st;
  if (dk == nullptr || dv == nullptr || rows == nullptr || split < 1 || split > 8 ||
      !parse(dtype, B0, B1, H, Lq, Lk, D, strides, &sh, &st))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_bf16(true, q, k, v, o, dout, m, l, rows, dk, dv, B0, sh, st, scale, split,
                            s);
  if (split != 1) return (int)cudaErrorInvalidValue;
  sm90::tf32::Problem p = f32_problem(q, k, v, o, dout, m, l, rows, sh, st, scale);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  return (int)sm90::tf32::dispatch_dp(D, [&](auto dp) {
    return sm90::tf32::launch_dkv<decltype(dp)::value>(p, B0, s);
  });
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
