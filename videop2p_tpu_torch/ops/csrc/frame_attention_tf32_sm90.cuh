// The Hopper (sm_90a) warpgroup core of the float32 frame-attention forward
// kernels, on the TF32 tensor cores with error-compensated products
// (3xTF32), shared by frame_attention.cu (the fused kernel) and
// flash_attention.cu (the flash kernel behind the flash and flash_rect
// wrappers). Both compute
//
//   out[b0,b1,h,n,:] = softmax(q[b0,b1,h,n,:] . k[b0,h,:,:]^T * scale) . v[b0,h,:,:]
//
// every query batch's (frame's) queries against one (b0, h)'s keys and
// values; the B1 query batches fold into one query axis of M = B1 * Lq rows,
// since all of them read the same K/V. q, o: (B0, B1, H, Lq, D) strided; k,
// v: (B0, H, Lk, D) strided; the last dimension contiguous, no alignment
// asked of any of them. The flash entry also writes each row's residuals:
// m, the max of the scaled scores (natural-log units), and l, the sum of
// exp(s - m), f32 (B0, B1, H, Lq), which the float32 backward reads.
//
// Precision and the operand layouts: sm90_tf32_common.cuh. Every product,
// S = Q.K^T and each key tile's P.V, runs as three TF32 passes (the cross
// terms, then hi.hi) with f32 accumulation; the online softmax runs in f32
// registers on ex2, and the row sum l adds the full f32 p (not p_hi), as
// the plain version does. The tensor cores' f32 accumulation drifts with
// the number of k steps it carries (the backward measured 2.7e-4 * max|ref|
// over 32768 rows, 2.2e-5 over 3000), so each key tile's P.V (3 * T / 8 k
// steps) goes into a fresh accumulator, and the CUDA cores, which round to
// nearest, take O = O * alpha + partial: the rescale is theirs anyway.
//
// Two kernels, launched in this order on one stream:
//   * a prep kernel (one block per key tile of T keys of a (b0, h)) reads k
//     and v once, at any strides, and writes each key tile's exact
//     shared-memory image into a scratch (4 * B0 * H * ceil(Lk / T) * T * DP
//     floats, allocated by the caller): K hi, K lo as keys x DP; V hi, V lo
//     as DP x keys, the keys permuted within groups of 8 by sigma, so that
//     the S accumulator, rounded to TF32 hi/lo in place, is P's register A
//     fragment as it is. wgmma transposes only 16-bit operands, so V, which
//     P.V reduces over its keys, must be stored with the keys contiguous.
//     Keys past Lk and columns past D are written as 0.
//   * the attention kernel: a block is two consumer warpgroups of 64 query
//     rows each (128 rows of the folded query axis) and one producer warp,
//     one block per SM. Each warpgroup loads its 64 rows of q once, at any
//     strides, splits them into hi/lo and keeps both in shared memory as
//     K-major tiles (64 x DP): Q is the A operand of S from shared memory,
//     since its fragments (DP registers) do not fit beside O, the partial,
//     S and P's fragments at DP 80. One producer thread streams the key
//     tiles of the (b0, h) through a ring of stages, one cp.async.bulk per
//     tile (no tensor map, so no alignment refusal in float32). Per key
//     tile a warpgroup runs
//       S = Q.K^T        wgmma m64nTk8 SS, 3 * DP / 8 steps;
//       softmax          keys past Lk score -inf; the quad of threads that
//                        owns a row reduces its max with two shuffles;
//                        alpha = exp2((m_old - m_new) * c), p = exp2(s * c -
//                        m_new * c), c = scale * log2(e); l = l * alpha +
//                        sum(p) (the thread's partial sums, reduced across
//                        the quad at the end); p split into TF32 hi / lo;
//       partial = P.V    wgmma m64nDPk8 RS (N in pieces of 64 / 32 / 16 / 8),
//                        3 * T / 8 steps, into a zeroed accumulator;
//       O = O * alpha + partial   on the CUDA cores.
//     The two warpgroups overlap: while one runs its softmax, the other's
//     products run. Key 0 of the first tile is never masked (Lk >= 1), so
//     the first max is finite and the first alpha is exp2(-inf) = 0; no row
//     is all masked, and none gives NaN.
//
// Determinism: no atomics, no split over keys; every row walks the key
// tiles in one order, and a row's arithmetic does not depend on where in a
// block or batch it lies. Two calls give the same bits, and row r of a
// B = 1 call equals row r of the same inputs inside a larger batch.
//
// Sizes (T = keys per streamed tile): DP 16-48 T 64, 64-96 T 32, 128 T 16.
// Shared memory: the resident Q (2 warpgroups x 64 rows x DP, hi and lo)
// and 2-4 stages of 16 * T * DP bytes (40 KB at DP 40 and 80). Registers:
// O and the tile's partial (DP / 2 each), S (T / 2) and P's hi / lo
// fragments (T); nine warps a block cap ptxas at 168.
//
// Bound on this card: 3 TF32 products per f32 product, 4 * (rows) * Lk * D
// FLOPs each (S and P.V), at 495 TFLOP/s; beside it one ex2 per (query,
// key) pair and the split of every p on the CUDA cores.

#pragma once

#include "sm90_tf32_common.cuh"

namespace sm90 {
namespace tf32 {
namespace fwd {

// One float32 forward problem. Strides in elements: q, o (b0, b1, h, n); k,
// v (b0, h, n). m_out, l_out: null, or f32 (B0, B1, H, Lq).
struct Problem {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* m_out;
  float* l_out;
  uint8_t* scratch;  // written by the prep kernel, read by the attention kernel
  long long q_st[4], o_st[4];
  long long k_st[3], v_st[3];
  int B1, H, Lq, Lk, D;
  int tk;  // key tiles per (b0, h), ceil(Lk / T)
  float scale;
};

template <int DP>
struct Config {
  static constexpr int kT = DP <= 48 ? 64 : (DP <= 96 ? 32 : 16);  // keys per streamed tile
  static constexpr int kBlockRows = 64 * kWGs;
  static constexpr int kArr = kT * DP * 4;        // bytes of one tile array
  static constexpr int kTileBytes = 4 * kArr;     // K hi, lo (T x DP); V hi, lo (DP x T)
  static constexpr int kQArr = 64 * DP * 4;       // one warpgroup's Q, hi or lo
  static constexpr int kResBytes = kWGs * 2 * kQArr;
  static constexpr int kStages = ring_stages(kResBytes, kTileBytes);
  static constexpr int kSmem = smem_bytes(kResBytes, kTileBytes);
  static_assert(DP % 8 == 0 && kT % 8 == 0, "tile geometry");
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// ------------------------------------------------------------------ prep

// Key tile blockIdx.x of the (b0, h) = divmod(blockIdx.y, H) problem into
// its scratch image: K hi, K lo (T x DP), V hi, V lo (DP x T, sigma order).
template <int DP>
__device__ __forceinline__ void prep_tile(const Problem& p) {
  using C = Config<DP>;
  constexpr int T = C::kT;
  constexpr int E = T * DP;  // floats per array
  const int bh = blockIdx.y;
  const int h = bh % p.H;
  const int b0 = bh / p.H;
  float* out = reinterpret_cast<float*>(p.scratch + ((long long)bh * p.tk + blockIdx.x) *
                                                        C::kTileBytes);
  const int n0 = blockIdx.x * T;
  const int nrows = min(T, p.Lk - n0);
  const float* kb = p.k + b0 * p.k_st[0] + h * p.k_st[1];
  const float* vb = p.v + b0 * p.v_st[0] + h * p.v_st[1];
  for (int e = threadIdx.x; e < 2 * E; e += kPrepThreads) {
    const int a = e / E;  // 0: K, 1: V
    const int o = e - a * E;
    int r, c;
    tile_source<DP, T>(o, a == 1, r, c);
    float x = 0.f;
    if (r < nrows && c < p.D) {
      const long long n = n0 + r;
      x = a == 1 ? vb[n * p.v_st[2] + c] : kb[n * p.k_st[2] + c];
    }
    uint32_t hi, lo;
    split(x, hi, lo);
    out[2 * a * E + o] = __uint_as_float(hi);
    out[(2 * a + 1) * E + o] = __uint_as_float(lo);
  }
}

// -------------------------------------------------------------- attention

// One block: query rows [blockIdx.x * kBlockRows, + kBlockRows) of the
// folded query axis (B1 * Lq rows) of the (b0, h) = divmod(blockIdx.y, H)
// problem. Launched with kThreads threads and Config<DP>::kSmem bytes of
// dynamic shared memory.
template <int DP>
__device__ __forceinline__ void attention_block(const Problem& p) {
  using C = Config<DP>;
  constexpr int T = C::kT;
  constexpr int S = C::kStages;
  constexpr int kStage = C::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t ring = base + C::kResBytes;
  const uint32_t bars = ring + S * kStage;
  const int bh = blockIdx.y;
  const int h = bh % p.H;
  const int b0 = bh / p.H;

  init_barriers<S>(bars, 4 * kWGs);
  if (threadIdx.x >= 128 * kWGs) {
    if (threadIdx.x == 128 * kWGs)
      stream_tiles<S>(ring, bars, p.scratch + (long long)bh * p.tk * kStage, kStage, p.tk);
    return;
  }

  const int wg = threadIdx.x / 128;
  const int ctid = threadIdx.x % 128;
  const int warp = ctid / 32;
  const int lane = threadIdx.x % 32;
  const int c2 = (lane & 3) * 2;
  const long long M = (long long)p.B1 * p.Lq;
  const long long row_base = (long long)blockIdx.x * C::kBlockRows + wg * 64;
  const uint32_t q_hi = base + wg * 2 * C::kQArr;
  const uint32_t q_lo = q_hi + C::kQArr;

  // this warpgroup's 64 query rows, hi and lo, as 64 x DP K-major tiles: two
  // threads a row, each writing 16-byte runs of four columns
  {
    float* qh = reinterpret_cast<float*>(gbase + (q_hi - base));
    float* ql = qh + C::kQArr / 4;
    const int r = ctid >> 1;
    const long long R = row_base + r;
    const float* qrow = nullptr;
    if (R < M) {
      const int b1 = (int)(R / p.Lq);
      const int n = (int)(R - (long long)b1 * p.Lq);
      qrow = p.q + b0 * p.q_st[0] + b1 * p.q_st[1] + h * p.q_st[2] + n * p.q_st[3];
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c0 = 8 * j + 4 * (ctid & 1);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split((qrow != nullptr && c0 + e < p.D) ? qrow[c0 + e] : 0.f, hi[e], lo[e]);
      const int at = tile_offset<DP>(r, c0);
      *reinterpret_cast<uint4*>(qh + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(ql + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  // the generic-proxy stores above are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();

  const float c = p.scale * kLog2e;          // scores -> log2 units
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of rows ra, ra + 8 (raw q.k)
  float l[2] = {0.f, 0.f};                      // this thread's partial sums
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  for (int t = 0; t < p.tk; ++t) {
    const int s = t % S;
    mbar_wait(bars + 8 * s, (t / S) & 1);
    const uint32_t kt = ring + s * kStage;  // K hi, K lo, V hi, V lo
    float sc[T / 2];
    wgmma_fence();
    ss_product<DP, T>(sc, q_hi, q_lo, kt, kt + C::kArr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    // keys past Lk (zero rows of K and V) score -inf
    if (t * T + T > p.Lk) {
#pragma unroll
      for (int jj = 0; jj < T / 8; ++jj) {
        const int key = t * T + 8 * jj + c2;
        if (key >= p.Lk) sc[4 * jj] = sc[4 * jj + 2] = -CUDART_INF_F;
        if (key + 1 >= p.Lk) sc[4 * jj + 1] = sc[4 * jj + 3] = -CUDART_INF_F;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < T / 8; ++jj) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * jj], sc[4 * jj + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
    }
    float alpha[2], neg_mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = ex2((m[i] - mx[i]) * c);
      neg_mc[i] = -mx[i] * c;
      m[i] = mx[i];
    }
    // p in f32 for the row sum, split into the hi / lo A fragments of P.V
    uint32_t ph[T / 2], pl[T / 2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const float pe = ex2(fmaf(sc[i], c, neg_mc[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += pe;
      split(pe, ph[i], pl[i]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], sum[i]);
    // the tile's P.V on the tensor cores, the running O here
    float part[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) part[i] = 0.f;
    wgmma_fence();
    rs_product<DP, T>(part, ph, pl, kt + 2 * C::kArr, kt + 3 * C::kArr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], part[i]);
    // the stage is free once this warp's share of both products is done
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (S + s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    orow[i] = nullptr;
    const long long R = row_base + warp * 16 + (lane >> 2) + 8 * i;
    if (R >= M) continue;
    const int b1 = (int)(R / p.Lq);
    const int n = (int)(R - (long long)b1 * p.Lq);
    orow[i] = p.o + b0 * p.o_st[0] + b1 * p.o_st[1] + h * p.o_st[2] + n * p.o_st[3];
    if (p.m_out != nullptr && (lane & 3) == 0) {
      const long long r = (((long long)b0 * p.B1 + b1) * p.H + h) * p.Lq + n;
      p.m_out[r] = m[i] * p.scale;  // natural-log units of the scaled scores
      p.l_out[r] = l[i];
    }
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  store_rows<DP>(orow, o, c2, p.D);
}

// -------------------------------------------------------------------- host

typedef void (*KernelFn)(const Problem);

// The bytes of the scratch of B0 (b0, h) problems of H heads and Lk keys at
// the padded head dim DP.
template <int DP>
long long scratch_bytes(int B0, int H, int Lk) {
  using C = Config<DP>;
  return (long long)B0 * H * ((Lk + C::kT - 1) / C::kT) * C::kTileBytes;
}

// The prep kernel, then the attention kernel, over B0 (b0, h) problems (the
// callers check B0 * H <= 65535). `prep` and `kernel` are __global__
// wrappers of prep_tile<DP> and attention_block<DP> (the caller's, so that
// each entry's kernels carry its name).
template <int DP>
cudaError_t launch(KernelFn prep, KernelFn kernel, Problem p, int B0, cudaStream_t stream) {
  using C = Config<DP>;
  if (p.scratch == nullptr) return cudaErrorInvalidValue;
  p.tk = (p.Lk + C::kT - 1) / C::kT;
  const long long blocks = ((long long)p.B1 * p.Lq + C::kBlockRows - 1) / C::kBlockRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  prep<<<dim3((unsigned)p.tk, (unsigned)(B0 * p.H)), kPrepThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)blocks, (unsigned)(B0 * p.H)), kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fwd
}  // namespace tf32
}  // namespace sm90
