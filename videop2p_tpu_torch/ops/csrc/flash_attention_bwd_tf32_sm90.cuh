// The Hopper (sm_90a) warpgroup core of the float32 flash-attention
// backward: the dQ kernel and the dK/dV kernel behind flash_attention_bwd.cu,
// on the TF32 tensor cores with error-compensated products (3xTF32). With
// s = q.k^T * scale (natural-log units) and the forward's per-row residuals
// m (max of s) and l (sum of exp(s - m)), per query row r and key c:
//
//   p  = exp2(q.k * scale * log2(e) - lse_r),   lse_r = m_r * log2(e) + log2(l_r)
//   dV = sum_r p^T . dO                       dP = dO . V^T
//   dS = p * (dP - di_r) * scale              dK = sum_r dS^T . Q,   dQ = dS . K
//
// with di_r = sum_d O*dO, all in f32. q, o, dO: (B0, B1, H, Lq, D) strided;
// k, v: (B0, H, Lk, D), shared by the B1 query batches; dK and dV sum over
// every query of every query batch.
//
// Precision and the operand layouts: sm90_tf32_common.cuh (3xTF32 products,
// each part rounded with cvt.rna; the no-swizzle K-major tiles; the sigma
// order of a D x rows tile that an accumulator used as the A fragment
// multiplies). The tensor cores' f32 accumulation drifts with the number of
// k steps it carries: dK and dV kept in the wgmma accumulator across the
// 32768 queries of the 64x64 null-text site read 2.7e-4 * max|ref| off the
// plain backward (the limit is 1e-4), the error growing with the query
// count. So each streamed tile's dV, dK or dQ (3 * T / 8 k steps) is summed
// on the tensor cores into a fresh partial accumulator and added to the
// running sum on the CUDA cores, which round to nearest: about 1e-6 *
// max|ref| then.

// Three kernels, launched in this order on one stream, no atomics (each
// output element is summed in one fixed order and written once: two calls
// on the same inputs give the same bits):
//   * flash_bwd_dq_prep_tf32_kernel: reads q, dO, o, m, l, k, v once, at any
//     strides, and writes a scratch buffer (allocated by the caller) of
//     ready tiles: per query tile of T rows of a (b0, h), Q and dO in two
//     layouts (rows x D and D x rows), each as hi and lo, and the rows' lse
//     and di * scale (past Lq: +inf and 0, so p = dS = 0 there); per key
//     tile, K and V (rows x D) and K (D x rows), hi and lo. Each tile is
//     the exact shared-memory image the main kernels read, so a stage is
//     one bulk copy (cp.async.bulk) and no tensor map or TMA refusal exists.
//   * flash_bwd_dq_tf32_kernel: 64 query rows per consumer warpgroup
//     resident in shared memory (Q, dO hi/lo), the key tiles streamed through
//     a ring by one producer thread: S = Q.K^T and dP = dO.V^T (both
//     operands from shared memory), p and dS in registers (keys past Lk
//     masked), dS split into hi/lo register fragments, dQ += dS.K (B = the
//     D x keys tile).
//   * flash_bwd_dkv_tf32_kernel: 64 keys per consumer warpgroup resident (K,
//     V hi/lo), the (b0, h)'s query tiles of every query batch streamed:
//     S^T = K.Q^T and dP^T = V.dO^T, p^T and dS^T in registers, dV += P^T.dO
//     and dK += dS^T.Q (B = the D x queries tiles).
//   A block is two consumer warpgroups and one producer warp. Up to DP 64
//   the two warpgroups own 64 rows each and both read every streamed tile;
//   above, they share one 64-row block (the resident tiles would not fit
//   twice) and take alternate tiles, and warpgroup 1 hands its partial sums
//   to warpgroup 0 through shared memory (a fixed order).
//
// Why both layouts: wgmma transposes only 16-bit operands, so a .tf32
// operand in shared memory is K-major (the reduction axis contiguous). Q,
// dO and K are needed both as rows x D (for S, dP: reduction over D) and as
// D x rows (for dK, dV, dQ: reduction over the rows, in sigma order); the
// prep kernel writes both, the padded columns as 0.
//
// Sizes (T = rows per streamed tile): DP 16-48 T 32, 64-96 T 16, 128 T 8;
// the stages of the ring fill the 227 KB of shared memory left by the
// resident tiles (2 to 4). Registers: dK/dV holds dK and dV (DP floats), a
// tile's partial sum (DP / 2), S^T and dP^T (T floats) and their hi/lo
// fragments (2T); dQ holds dQ and a partial (DP), S and dP (T) and dS's
// fragments (T). Nine warps a block cap ptxas at 168 registers.
//
// Bound on this card: 3 TF32 products per f32 product, 4 per (query, key,
// d) for dK/dV (S^T, dP^T, dV, dK) and 3 for dQ, at 495 TFLOP/s, beside one
// ex2 per (query, key) pair in each kernel.

#pragma once

#include "sm90_tf32_common.cuh"

namespace sm90 {
namespace tf32 {

// One float32 backward problem. Strides in elements: q, o, dout, dq (b0, b1,
// h, l); k, v, dk, dv (b0, h, l).
struct Problem {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* m;
  const float* l;
  float* dq;
  float* dk;
  float* dv;
  uint8_t* scratch;  // written by the prep kernel, read by the other two
  long long q_st[4], o_st[4], do_st[4], dq_st[4];
  long long k_st[3], v_st[3], dk_st[3], dv_st[3];
  int B1, H, Lq, Lk, D;
  int tpb;     // query tiles per query batch, ceil(Lq / T)
  int tq_pad;  // query tiles per (b0, h): B1 * tpb rounded up to whole dQ blocks
  int tk;      // key tiles per (b0, h), ceil(Lk / T)
  int tk_pad;  // tk rounded up to whole dK/dV blocks
  long long k_offset;  // bytes from the scratch's start to the key tiles
  float scale;
};

template <int DP>
struct Config {
  static constexpr int kT = DP <= 48 ? 32 : (DP <= 96 ? 16 : 8);  // rows per streamed tile
  static constexpr bool kOwn = DP <= 64;  // each warpgroup owns its 64 rows
  static constexpr int kBlockRows = kOwn ? 64 * kWGs : 64;
  static constexpr int kTilesPerBlock = kBlockRows / kT;
  static constexpr int kArr = kT * DP * 4;  // bytes of one tile array
  // a query tile: Q, dO (T x DP) hi, lo; Q, dO (DP x T) hi, lo; lse, di*scale
  static constexpr int kQTileBytes = 8 * kArr + 8 * kT;
  static constexpr int kRowsOffset = 8 * kArr;
  // a key tile: K, V (T x DP) hi, lo; K (DP x T) hi, lo
  static constexpr int kKTileBytes = 6 * kArr;
  // resident: four (kBlockRows x DP) arrays, hi and lo of two operands
  static constexpr int kResArr = kBlockRows * DP * 4;
  static constexpr int kResBytes = 4 * kResArr;
  static constexpr int kDkvStages = ring_stages(kResBytes, kQTileBytes);
  static constexpr int kDqStages = ring_stages(kResBytes, kKTileBytes);
  static constexpr int kDkvSmem = smem_bytes(kResBytes, kQTileBytes);
  static constexpr int kDqSmem = smem_bytes(kResBytes, kKTileBytes);
  static_assert(DP % 8 == 0 && kBlockRows % kT == 0, "tile geometry");
  static_assert(kDkvStages >= 2 && kDqStages >= 2, "the ring needs two stages");
  static_assert(kDkvSmem <= kSmemMax && kDqSmem <= kSmemMax, "shared memory");
  // one accumulator of warpgroup 1 handed over through the ring
  static_assert(kOwn || (128 * (DP / 2) * 4 <= kDqStages * kKTileBytes &&
                         128 * (DP / 2) * 4 <= kDkvStages * kQTileBytes),
                "reduction buffer");
};

// Warpgroup 1's accumulator added into warpgroup 0's through shared memory
// (`red`, 128 * R floats); warpgroup 1 is done after this.
template <int R>
__device__ __forceinline__ void hand_over(float (&acc)[R], float* red, int wg, int ctid) {
  consumers_sync();  // every warpgroup is done with what `red` held
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) red[i * 128 + ctid] = acc[i];
  }
  consumers_sync();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += red[i * 128 + ctid];
  }
}

// ------------------------------------------------------------------ prep

// One query tile (blockIdx.x < tq_pad) or key tile of the (b0, h) =
// divmod(blockIdx.y, H) problem into its scratch image.
template <int DP>
__device__ __forceinline__ void prep_tile(const Problem& p) {
  using C = Config<DP>;
  constexpr int T = C::kT;
  constexpr int E = T * DP;  // floats per array
  const int bh = blockIdx.y;
  const int h = bh % p.H;
  const int b0 = bh / p.H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if ((int)blockIdx.x < p.tq_pad) {
    const int x = blockIdx.x;
    float* out = reinterpret_cast<float*>(p.scratch + ((long long)bh * p.tq_pad + x) *
                                                          C::kQTileBytes);
    const bool real = x < p.B1 * p.tpb;
    const int b1 = real ? x / p.tpb : 0;
    const int n0 = real ? (x % p.tpb) * T : 0;
    const int nrows = real ? min(T, p.Lq - n0) : 0;
    const float* qb = p.q + b0 * p.q_st[0] + b1 * p.q_st[1] + h * p.q_st[2];
    const float* ob = p.o + b0 * p.o_st[0] + b1 * p.o_st[1] + h * p.o_st[2];
    const float* db = p.dout + b0 * p.do_st[0] + b1 * p.do_st[1] + h * p.do_st[2];
    // each row's lse and di * scale, one warp a row
    float* lse = out + C::kRowsOffset / 4;
    for (int r = warp; r < T; r += kPrepThreads / 32) {
      float di = 0.f;
      if (r < nrows) {
        const long long n = n0 + r;
        for (int d = lane; d < p.D; d += 32)
          di = fmaf(ob[n * p.o_st[3] + d], db[n * p.do_st[3] + d], di);
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) di += __shfl_xor_sync(0xffffffffu, di, s);
      if (lane == 0) {
        if (r < nrows) {
          const long long row = (((long long)b0 * p.B1 + b1) * p.H + h) * p.Lq + n0 + r;
          lse[r] = p.m[row] * kLog2e + log2f(p.l[row]);
          lse[T + r] = di * p.scale;
        } else {
          lse[r] = CUDART_INF_F;  // p = 0 on a row past the end
          lse[T + r] = 0.f;
        }
      }
    }
    // Q, dO (T x DP), then Q, dO (DP x T): hi at array 2a, lo at 2a + 1
    for (int e = threadIdx.x; e < 4 * E; e += kPrepThreads) {
      const int a = e / E;
      const int o = e - a * E;
      int r, c;
      tile_source<DP, T>(o, a >= 2, r, c);
      float x = 0.f;
      if (r < nrows && c < p.D) {
        const long long n = n0 + r;
        x = (a & 1) ? db[n * p.do_st[3] + c] : qb[n * p.q_st[3] + c];
      }
      uint32_t hi, lo;
      split(x, hi, lo);
      out[2 * a * E + o] = __uint_as_float(hi);
      out[(2 * a + 1) * E + o] = __uint_as_float(lo);
    }
  } else {
    const int x = blockIdx.x - p.tq_pad;
    float* out = reinterpret_cast<float*>(p.scratch + p.k_offset +
                                          ((long long)bh * p.tk_pad + x) * C::kKTileBytes);
    const int n0 = x * T;
    const int nrows = max(0, min(T, p.Lk - n0));
    const float* kb = p.k + b0 * p.k_st[0] + h * p.k_st[1];
    const float* vb = p.v + b0 * p.v_st[0] + h * p.v_st[1];
    // K, V (T x DP), then K (DP x T)
    for (int e = threadIdx.x; e < 3 * E; e += kPrepThreads) {
      const int a = e / E;
      const int o = e - a * E;
      int r, c;
      tile_source<DP, T>(o, a == 2, r, c);
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
}

// ------------------------------------------------------------ the rings

// The producer thread: the resident tiles (four arrays of each of
// kTilesPerBlock tiles of `res_src`, tile_bytes apart), then the n streamed
// tiles of `stream` through the S-stage ring.
template <int DP, int S>
__device__ __forceinline__ void produce(uint32_t res, uint32_t ring, uint32_t bars,
                                        const uint8_t* res_src, int tile_bytes,
                                        const uint8_t* stream, int stage_bytes, int n) {
  using C = Config<DP>;
  const uint32_t res_bar = bars + 16 * S;
  mbar_expect_tx(res_bar, C::kResBytes);
  for (int i = 0; i < C::kTilesPerBlock; ++i) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      bulk_load(res + a * C::kResArr + i * C::kArr,
                res_src + (long long)i * tile_bytes + a * C::kArr, C::kArr, res_bar);
  }
  stream_tiles<S>(ring, bars, stream, stage_bytes, n);
}

// -------------------------------------------------------------------- dQ

// One block: query rows [blockIdx.x * kBlockRows, + kBlockRows) of the B1 *
// tpb query tiles of the (b0, h) = divmod(blockIdx.y, H) problem.
template <int DP>
__device__ __forceinline__ void dq_block(const Problem& p) {
  using C = Config<DP>;
  constexpr int T = C::kT;
  constexpr int S = C::kDqStages;
  constexpr int kStage = C::kKTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t res = base;
  const uint32_t ring = res + C::kResBytes;
  const uint32_t bars = ring + S * kStage;
  const int bh = blockIdx.y;
  const int h = bh % p.H;
  const int b0 = bh / p.H;
  const long long tile0 = (long long)blockIdx.x * C::kTilesPerBlock;
  const uint8_t* qtiles = p.scratch + ((long long)bh * p.tq_pad + tile0) * C::kQTileBytes;
  const uint8_t* ktiles = p.scratch + p.k_offset + (long long)bh * p.tk_pad * kStage;

  init_barriers<S>(bars, C::kOwn ? 4 * kWGs : 4);
  if (threadIdx.x >= 128 * kWGs) {
    if (threadIdx.x == 128 * kWGs)
      produce<DP, S>(res, ring, bars, qtiles, C::kQTileBytes, ktiles, kStage, p.tk);
    return;
  }

  const int wg = threadIdx.x / 128;
  const int ctid = threadIdx.x % 128;
  const int warp = ctid / 32;
  const int lane = threadIdx.x % 32;
  const int c2 = (lane & 3) * 2;
  const int row0 = (C::kOwn ? wg * 64 : 0) + warp * 16 + (lane >> 2);  // block-local rows
  const uint32_t q_hi = res + (C::kOwn ? wg * 64 * DP * 4 : 0);
  const uint32_t q_lo = q_hi + C::kResArr;
  const uint32_t do_hi = q_hi + 2 * C::kResArr;
  const uint32_t do_lo = q_hi + 3 * C::kResArr;
  float lse[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = row0 + 8 * i;
    const float* rows = reinterpret_cast<const float*>(qtiles + (R / T) * C::kQTileBytes +
                                                       C::kRowsOffset);
    lse[i] = rows[R % T];
    di[i] = rows[T + R % T];
  }
  const float c = p.scale * kLog2e;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  mbar_wait(bars + 16 * S, 0);
  for (int t = C::kOwn ? 0 : wg; t < p.tk; t += C::kOwn ? 1 : kWGs) {
    const int s = t % S;
    mbar_wait(bars + 8 * s, (t / S) & 1);
    const uint32_t kt = ring + s * kStage;  // K hi, lo; V hi, lo; K (D x keys) hi, lo
    float sc[T / 2], dp[T / 2];
    // S = Q.K^T and dP = dO.V^T: this warpgroup's 64 queries x T keys
    wgmma_fence();
    ss_product<DP, T>(sc, q_hi, q_lo, kt, kt + C::kArr);
    ss_product<DP, T>(dp, do_hi, do_lo, kt + 2 * C::kArr, kt + 3 * C::kArr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // keys past Lk (zero rows of K and V) take p = 0
    if (t * T + T > p.Lk) {
#pragma unroll
      for (int jj = 0; jj < T / 8; ++jj) {
        const int key = t * T + 8 * jj + c2;
        if (key >= p.Lk) sc[4 * jj] = sc[4 * jj + 2] = -CUDART_INF_F;
        if (key + 1 >= p.Lk) sc[4 * jj + 1] = sc[4 * jj + 3] = -CUDART_INF_F;
      }
    }
    uint32_t dh[T / 2], dl[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const float pe = ex2(fmaf(sc[i], c, -lse[(i >> 1) & 1]));
      split(pe * fmaf(dp[i], p.scale, -di[(i >> 1) & 1]), dh[i], dl[i]);
    }
    // dQ += dS.K: the tile's sum on the tensor cores, the running sum here
    float part[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) part[i] = 0.f;
    wgmma_fence();
    rs_product<DP, T>(part, dh, dl, kt + 4 * C::kArr, kt + 5 * C::kArr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] += part[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (S + s));
  }
  if constexpr (!C::kOwn) {
    hand_over(dq, reinterpret_cast<float*>(gbase + (ring - base)), wg, ctid);
    if (wg != 0) return;
  }
  float* dqrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = row0 + 8 * i;
    const long long tile = tile0 + R / T;
    const int b1 = (int)(tile / p.tpb);
    const int n = (int)(tile % p.tpb) * T + R % T;
    dqrow[i] = (b1 < p.B1 && n < p.Lq)
                   ? p.dq + b0 * p.dq_st[0] + b1 * p.dq_st[1] + h * p.dq_st[2] + n * p.dq_st[3]
                   : nullptr;
  }
  store_rows<DP>(dqrow, dq, c2, p.D);
}

// -------------------------------------------------------------- dK/dV

// One block: keys [blockIdx.x * kBlockRows, + kBlockRows) of the (b0, h) =
// divmod(blockIdx.y, H) problem, against every query tile of its B1 batches.
template <int DP>
__device__ __forceinline__ void dkv_block(const Problem& p) {
  using C = Config<DP>;
  constexpr int T = C::kT;
  constexpr int S = C::kDkvStages;
  constexpr int kStage = C::kQTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t res = base;
  const uint32_t ring = res + C::kResBytes;
  const uint32_t bars = ring + S * kStage;
  const int bh = blockIdx.y;
  const int h = bh % p.H;
  const int b0 = bh / p.H;
  const int key0 = blockIdx.x * C::kBlockRows;
  const uint8_t* ktiles = p.scratch + p.k_offset +
                          ((long long)bh * p.tk_pad + (long long)blockIdx.x * C::kTilesPerBlock) *
                              C::kKTileBytes;
  const uint8_t* qtiles = p.scratch + (long long)bh * p.tq_pad * kStage;
  const int n_tiles = p.B1 * p.tpb;

  init_barriers<S>(bars, C::kOwn ? 4 * kWGs : 4);
  if (threadIdx.x >= 128 * kWGs) {
    if (threadIdx.x == 128 * kWGs)
      produce<DP, S>(res, ring, bars, ktiles, C::kKTileBytes, qtiles, kStage, n_tiles);
    return;
  }

  const int wg = threadIdx.x / 128;
  const int ctid = threadIdx.x % 128;
  const int warp = ctid / 32;
  const int lane = threadIdx.x % 32;
  const int c2 = (lane & 3) * 2;
  const int row0 = (C::kOwn ? wg * 64 : 0) + warp * 16 + (lane >> 2);
  const uint32_t k_hi = res + (C::kOwn ? wg * 64 * DP * 4 : 0);
  const uint32_t k_lo = k_hi + C::kResArr;
  const uint32_t v_hi = k_hi + 2 * C::kResArr;
  const uint32_t v_lo = k_hi + 3 * C::kResArr;
  const float c = p.scale * kLog2e;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(bars + 16 * S, 0);
  for (int t = C::kOwn ? 0 : wg; t < n_tiles; t += C::kOwn ? 1 : kWGs) {
    const int s = t % S;
    mbar_wait(bars + 8 * s, (t / S) & 1);
    // Q, dO (queries x D) hi, lo; Q, dO (D x queries) hi, lo; lse, di * scale
    const uint32_t qt = ring + s * kStage;
    const float* rows = reinterpret_cast<const float*>(gbase + (qt - base) + C::kRowsOffset);
    float st[T / 2], dpt[T / 2];
    // S^T = K.Q^T and dP^T = V.dO^T: this warpgroup's 64 keys x T queries
    wgmma_fence();
    ss_product<DP, T>(st, k_hi, k_lo, qt, qt + C::kArr);
    ss_product<DP, T>(dpt, v_hi, v_lo, qt + 2 * C::kArr, qt + 3 * C::kArr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    // p^T and dS^T; columns 8jj + c2 + {0, 1} are this thread's queries
    uint32_t ph[T / 2], pl[T / 2], dh[T / 2], dl[T / 2];
#pragma unroll
    for (int jj = 0; jj < T / 8; ++jj) {
      const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * jj + c2);
      const float2 d2 = *reinterpret_cast<const float2*>(rows + T + 8 * jj + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const float pe = ex2(fmaf(st[i], c, -((e & 1) ? l2.y : l2.x)));
        split(pe, ph[i], pl[i]);
        split(pe * fmaf(dpt[i], p.scale, -((e & 1) ? d2.y : d2.x)), dh[i], dl[i]);
      }
    }
    // dV += P^T.dO, then dK += dS^T.Q: each tile's sum on the tensor cores,
    // the running sums here
    float part[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) part[i] = 0.f;
    wgmma_fence();
    rs_product<DP, T>(part, ph, pl, qt + 6 * C::kArr, qt + 7 * C::kArr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      dv[i] += part[i];
      part[i] = 0.f;
    }
    wgmma_fence();
    rs_product<DP, T>(part, dh, dl, qt + 4 * C::kArr, qt + 5 * C::kArr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] += part[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (S + s));
  }
  if constexpr (!C::kOwn) {
    float* red = reinterpret_cast<float*>(gbase + (ring - base));
    hand_over(dk, red, wg, ctid);
    hand_over(dv, red, wg, ctid);
    if (wg != 0) return;
  }
  float* dkrow[2];
  float* dvrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + row0 + 8 * i;
    const bool ok = key < p.Lk;
    dkrow[i] = ok ? p.dk + b0 * p.dk_st[0] + h * p.dk_st[1] + key * p.dk_st[2] : nullptr;
    dvrow[i] = ok ? p.dv + b0 * p.dv_st[0] + h * p.dv_st[1] + key * p.dv_st[2] : nullptr;
  }
  store_rows<DP>(dkrow, dk, c2, p.D);
  store_rows<DP>(dvrow, dv, c2, p.D);
}

// ------------------------------------------------------------------ kernels

template <int DP>
__global__ void __launch_bounds__(kPrepThreads)
flash_bwd_dq_prep_tf32_kernel(const Problem p) {
  prep_tile<DP>(p);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_tf32_kernel(const Problem p) {
  dq_block<DP>(p);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_tf32_kernel(const Problem p) {
  dkv_block<DP>(p);
}

// -------------------------------------------------------------------- host

// The tile counts of p (B1, H, Lq, Lk set) and the bytes of its scratch.
template <int DP>
inline long long geometry(Problem& p, int B0) {
  using C = Config<DP>;
  constexpr int T = C::kT;
  constexpr int per = C::kTilesPerBlock;
  p.tpb = (p.Lq + T - 1) / T;
  p.tq_pad = (p.B1 * p.tpb + per - 1) / per * per;
  p.tk = (p.Lk + T - 1) / T;
  p.tk_pad = (p.tk + per - 1) / per * per;
  p.k_offset = ((long long)B0 * p.H * p.tq_pad * C::kQTileBytes + 127) / 128 * 128;
  return p.k_offset + (long long)B0 * p.H * p.tk_pad * C::kKTileBytes;
}

// The prep kernel, then the dQ kernel, over B0 (b0, h) problems.
template <int DP>
cudaError_t launch_dq(Problem p, int B0, cudaStream_t stream) {
  using C = Config<DP>;
  geometry<DP>(p, B0);
  flash_bwd_dq_prep_tf32_kernel<DP>
      <<<dim3((unsigned)(p.tq_pad + p.tk_pad), (unsigned)(B0 * p.H)), kPrepThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tf32_kernel<DP>
      <<<dim3((unsigned)(p.tq_pad / C::kTilesPerBlock), (unsigned)(B0 * p.H)), kThreads,
         C::kDqSmem, stream>>>(p);
  return cudaGetLastError();
}

// The dK/dV kernel, after launch_dq on the same stream and scratch.
template <int DP>
cudaError_t launch_dkv(Problem p, int B0, cudaStream_t stream) {
  using C = Config<DP>;
  geometry<DP>(p, B0);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkvSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tf32_kernel<DP>
      <<<dim3((unsigned)(p.tk_pad / C::kTilesPerBlock), (unsigned)(B0 * p.H)), kThreads,
         C::kDkvSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace sm90
