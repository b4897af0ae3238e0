// The Hopper (sm_90a) warpgroup core of the bf16 flash-attention backward:
// the dQ kernel and the dK/dV kernel behind flash_attention_bwd.cu. With
// s = q.k^T * scale (natural-log units) and the forward's per-row
// residuals m (max of s) and l (sum of exp(s - m)), per query row r and
// key c:
//
//   p  = exp2(q.k * scale * log2(e) - lse_r),   lse_r = m_r * log2(e) + log2(l_r)
//   dV = sum_r p^T . dO                       dP = dO . V^T
//   dS = p * (dP - di_r) * scale              dK = sum_r dS^T . Q,   dQ = dS . K
//
// with di_r = sum_d O*dO (f32), computed as p * (dP * scale - di_r * scale)
// (one FFMA, one FMUL). p is rounded to bf16 before dV and dS before dK and
// dQ, as the stock kernels do; every product accumulates in f32 and each
// output is rounded to bf16 once.
//
// q, o, dO: (B0, B1, H, Lq, D) strided; k, v: (B0, H, Lk, D), shared by the
// B1 query batches (the frames of the flash wrapper; B1 = 1 with the frames
// folded into Lq for flash_rect). dK and dV sum over every query of every
// query batch. m, l: contiguous f32 (B0, B1, H, Lq).
//
// Two kernels, launched dQ first, and no atomics: each output element is
// summed in one fixed order and written once, so two calls on the same
// inputs give the same bits (the null-text Adam turns gradient differences
// into steps of lr * sign(g)).
//
// dQ kernel (flash_bwd_dq_wgmma_kernel): queries are M, as in the forward.
//   * A block owns 128 query rows (two consumer warpgroups; the B1 query
//     batches fold into B1*Lq rows per (b0, h), all reading one K/V). Q and
//     dO load once as register A operands, O beside dO: each row's di, its
//     lse and di * scale stay in registers, and the kernel writes the last
//     two to `rows`, (B0*B1*H, ceil(Lq/64), 2, 64) f32 — per 64-row tile the
//     lse, then di * scale, and past Lq +inf and 0 — for the dK/dV kernel.
//   * One producer warp streams the K and V tiles through a 4-stage TMA
//     ring (the forward's K/V tensor maps).
//   * Per key tile: S = Q.K^T and dP = dO.V^T (B = the K-major K / V tile),
//     p and dS in registers (keys past Lk masked on the last tile), dS
//     rounded to bf16 as the A fragment of dQ += dS.K (B = the K tile,
//     MN-major).
// dK/dV kernel (flash_bwd_dkv_wgmma_kernel): keys are the M dimension.
//   * A block owns 128 keys of one (b0, h): two consumer warpgroups of 64
//     keys, whose K and V rows are loaded once by TMA and stay in shared
//     memory as the A operand (wgmma with both operands from descriptors),
//     so the registers hold only dK, dV and one tile's S^T, dP^T.
//   * One producer thread streams the Q and dO tiles of the (b0, h)'s query
//     rows, kBQ rows a tile and tile by tile within each query batch,
//     through a 4-stage TMA ring (5-D tensor maps over (D, Lq, B1, H, B0),
//     so any strides a TMA can read work and a tile never straddles two
//     query batches), and with each tile the tile's lse and di * scale from
//     `rows` by a bulk copy: the producer issues copies and nothing else,
//     so the consumer warps it shares a scheduler with never hold it up.
//   * Per tile a consumer warpgroup runs S^T = K.Q^T and dP^T = V.dO^T
//     (m64n{kBQ}k16, B = the K-major Q / dO tile), computes p^T and dS^T in
//     registers (the accumulator's columns are queries: each thread reads
//     the lse and di of its columns from the stage; past Lq `rows` holds
//     lse = +inf and di = 0, so p = dS = 0 there), rounds both to bf16 in
//     registers — the f32 accumulator fragment is, pair for pair, the
//     register A fragment of the next products — and runs dV += P^T.dO and
//     dK += dS^T.Q (m64n{DP}k16, B = the same tiles, MN-major). No S, P or
//     dS tile touches shared memory.
//   * Parallelism: B0*H*ceil(Lk/128) blocks. Where that leaves SMs idle
//     (the 32x32 null-text site: 64 blocks on 132 SMs) the caller splits
//     each block's query walk over the `split` CTAs (2..8) of a thread-block
//     cluster; the ranks above 0 leave their f32 partial dK and dV in their
//     own shared memory and rank 0 adds them in rank order through
//     distributed shared memory and stores: a fixed order, no atomics.
// Both kernels pad the head dim to DP, a multiple of 16, through the TMA
// boxes' zero fill (64-column slabs, 128B-swizzled, as in the forward);
// keys past Lk arrive as zero rows: their dK/dV rows are not stored, and
// the dQ kernel masks their p. Rows past Lq are not stored.
//
// Registers: ptxas allocates under the launch bound, and a block's nine
// warps (two consumer warpgroups and the producer warp) put three on one
// SM sub-partition, so at most 168 a thread. dK/dV holds dK and dV (DP
// floats), S^T and dP^T (kBQ floats) and their bf16 fragments: kBQ = 64 up
// to DP = 96, 32 above. dQ holds the Q and dO fragments (DP / 2), dQ (DP /
// 2), S and dP (kBK floats): kBK = 64 up to DP = 96, 32 above. Both spill
// at DP 96 and 128, which no SD-1.5 site uses.
//
// Bound on this card: at D 40 the exponential unit and the tensor cores
// are close: each kernel computes one ex2 per (query, key) pair (16 a clock
// per SM), and 8 (dK/dV) or 6 (dQ) * DP tensor-core FLOPs per pair.

#pragma once

#include <cooperative_groups.h>

#include "sm90_common.cuh"

namespace sm90 {
namespace bwd {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 4;   // TMA ring depth of both kernels
constexpr int kWGs = 2;      // consumer warpgroups of both kernels
constexpr int kThreads = 128 * kWGs + 32;  // and one producer warp
constexpr int kRowTile = 64;  // query rows per tile of `rows`

// One backward problem. Strides in elements: q, o, dout, dq (b0, b1, h, l);
// dk, dv (b0, h, l). k and v reach the kernels through tensor maps, q and
// dout the dK/dV kernel's too.
struct Problem {
  const __nv_bfloat16* q;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* m;
  const float* l;
  float* rows;  // written by the dQ kernel, read by the dK/dV kernel
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_st[4], o_st[4], do_st[4], dq_st[4];
  long long dk_st[3], dv_st[3];
  int B1, H, Lq, Lk, D;
  int split;  // dK/dV: CTAs of a cluster sharing one key block's query walk
  float scale;
};

// -------------------------------------------------------------- PTX extras

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3,
                                            int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory, completing on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A barrier among the consumer warpgroups alone (the producer warp is not
// counted).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kWGs) : "memory");
}

// wgmma m64nNk16, f32 += bf16 x bf16, A and B both K-major from shared
// memory (descriptors).
template <int N> struct WgmmaSS;

template <> struct WgmmaSS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// ------------------------------------------------------------ shared parts

// The K-major product of one tile, not committed: acc (64 x N) = A (64 x
// DP, a_tile) . B (N x DP, b_tile)^T, both 128B-swizzled 64-column slabs
// (a_slab, b_slab bytes apart); k-step kk reads 32 bytes of each row of
// slab kk / 4.
template <int DP, int N>
__device__ __forceinline__ void issue_kmajor_ss(float (&acc)[N / 2], uint32_t a_tile,
                                                int a_slab, uint32_t b_tile, int b_slab) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t da = make_desc(a_tile + (kk / 4) * a_slab + (kk % 4) * 32, 16, 1024);
    const uint64_t db = make_desc(b_tile + (kk / 4) * b_slab + (kk % 4) * 32, 16, 1024);
    WgmmaSS<N>::mma(acc, da, db, kk > 0);
  }
}

// The same with A (64 x DP) from register fragments.
template <int DP, int N>
__device__ __forceinline__ void issue_kmajor_rs(float (&acc)[N / 2],
                                                const uint32_t (&af)[DP / 16][4],
                                                uint32_t b_tile, int b_slab) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t db = make_desc(b_tile + (kk / 4) * b_slab + (kk % 4) * 32, 16, 1024);
    WgmmaRS<N>::template mma<0>(acc, af[kk], db, kk > 0);
  }
}

// acc (64 x DP) += A (64 x K, register fragments) . B, where B (K x DP) is
// a tile of K rows stored (rows, head dim) in 64-column slabs b_slab bytes
// apart, read MN-major: k-step kk reads rows 16kk .. 16kk + 15.
template <int DP, int K>
__device__ __forceinline__ void issue_mnmajor(float (&acc)[DP / 2],
                                              const uint32_t (&af)[K / 16][4], uint32_t b_tile,
                                              int b_slab) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = make_desc(b_tile + kk * 2048, b_slab, 1024);
    WgmmaRS<DP>::template mma<1>(acc, af[kk], db, 1);
  }
}

// The f32 accumulator pairs of columns 16kk .. 16kk + 15, rounded to bf16:
// the register A fragment of k-step kk of the next product.
template <int N>
__device__ __forceinline__ void to_fragments(uint32_t (&f)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
  }
}

// Rows ra and ra + 8 of an m64nDP accumulator to a bf16 (rows, D) output
// (row pointers null past the end).
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* (&row)[2], const float (&acc)[DP / 2],
                                           int c2, int D) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      store_pair(row[i], 8 * j + c2, D, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// The two bf16 of a 32-bit A-fragment register as floats.
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

// -------------------------------------------------------------------- dQ

template <int DP>
struct DqConfig {
  static constexpr int kBQ = 64 * kWGs;            // query rows per block
  static constexpr int kBK = DP <= 96 ? 64 : 32;   // keys per tile
  static constexpr int kSlabs = (DP + kSlabCols - 1) / kSlabCols;
  static constexpr int kSlabBytes = kBK * kSlabCols * 2;
  static constexpr int kStageBytes = 2 * kSlabs * kSlabBytes;  // K, then V
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// One block: query rows [blockIdx.x * kBQ, + kBQ) of the B1 * Lq rows of the
// (b0, h) = divmod(blockIdx.y, H) problem.
template <int DP>
__device__ __forceinline__ void dq_block(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                         const Problem& p) {
  using C = DqConfig<DP>;
  constexpr int BK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * C::kStageBytes;  // full[s], empty[s]
  const int M = p.B1 * p.Lq;
  const int h = blockIdx.y % p.H;
  const int b0 = blockIdx.y / p.H;
  const int n_tiles = (p.Lk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kWGs * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kWGs) {
    // ---- producer: one thread keeps the ring of K/V tiles full
    if (threadIdx.x == 128 * kWGs) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bars + 8 * (kStages + s), (t / kStages - 1) & 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, C::kStageBytes);
        const uint32_t kdst = base + s * C::kStageBytes;
        const uint32_t vdst = kdst + C::kSlabs * C::kSlabBytes;
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl) {
          tma_load_4d(kdst + sl * C::kSlabBytes, kmap, full, sl * kSlabCols, t * BK, h, b0);
          tma_load_4d(vdst + sl * C::kSlabBytes, vmap, full, sl * kSlabCols, t * BK, h, b0);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows per warpgroup
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int c2 = (lane & 3) * 2;
  const int ra = blockIdx.x * C::kBQ + wg * 64 + warp * 16 + (lane >> 2);
  const __nv_bfloat16* qrow[2];
  const __nv_bfloat16* orow[2];
  const __nv_bfloat16* dorow[2];
  __nv_bfloat16* dqrow[2];
  float* rowout[2];  // this row's lse in `rows`; its di * scale lies kRowTile on
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ra + 8 * i;
    qrow[i] = orow[i] = dorow[i] = nullptr;
    dqrow[i] = nullptr;
    rowout[i] = nullptr;
    lse[i] = CUDART_INF_F;  // p = 0 on a row past the end
    if (row < M) {
      const int b1 = row / p.Lq;
      const int n = row - b1 * p.Lq;
      qrow[i] = p.q + b0 * p.q_st[0] + b1 * p.q_st[1] + h * p.q_st[2] + n * p.q_st[3];
      orow[i] = p.o + b0 * p.o_st[0] + b1 * p.o_st[1] + h * p.o_st[2] + n * p.o_st[3];
      dorow[i] = p.dout + b0 * p.do_st[0] + b1 * p.do_st[1] + h * p.do_st[2] + n * p.do_st[3];
      dqrow[i] = p.dq + b0 * p.dq_st[0] + b1 * p.dq_st[1] + h * p.dq_st[2] + n * p.dq_st[3];
      const long long bh = ((long long)b0 * p.B1 + b1) * p.H + h;
      const long long r = bh * p.Lq + n;
      lse[i] = p.m[r] * kLog2e + log2f(p.l[r]);
      const int per_batch = (p.Lq + kRowTile - 1) / kRowTile;
      rowout[i] = p.rows + ((bh * per_batch + n / kRowTile) * 2) * kRowTile + n % kRowTile;
    }
  }
  uint32_t qf[DP / 16][4], dof[DP / 16][4];
  // di = sum_d O*dO over this thread's columns of each row, then its quad's
  float di[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kk * 16 + c2 + 8 * half;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qf[kk][2 * half + i] = load_pair(qrow[i], col, p.D);
        dof[kk][2 * half + i] = load_pair(dorow[i], col, p.D);
        const float2 o2 = unpack_bf16(load_pair(orow[i], col, p.D));
        const float2 d2 = unpack_bf16(dof[kk][2 * half + i]);
        di[i] = fmaf(o2.x, d2.x, fmaf(o2.y, d2.y, di[i]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    di[i] += __shfl_xor_sync(0xffffffffu, di[i], 1);
    di[i] += __shfl_xor_sync(0xffffffffu, di[i], 2);
    di[i] *= p.scale;
    if (rowout[i] != nullptr && (lane & 3) == 0) {
      rowout[i][0] = lse[i];
      rowout[i][kRowTile] = di[i];
      // the last row of a query batch also fills the rest of its tile of
      // `rows`: lse = +inf and di = 0, so the dK/dV kernel's p and dS are 0
      // past Lq
      if ((ra + 8 * i + 1) % p.Lq == 0) {
        for (int pad = 1; ((ra + 8 * i) % p.Lq + pad) % kRowTile != 0; ++pad) {
          rowout[i][pad] = CUDART_INF_F;
          rowout[i][kRowTile + pad] = 0.f;
        }
      }
    }
  }

  const float c = p.scale * kLog2e;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  float sc[BK / 2], dp[BK / 2];
  uint32_t dsf[BK / 16][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(bars + 8 * s, (t / kStages) & 1);
    const uint32_t kt = base + s * C::kStageBytes;
    const uint32_t vt = kt + C::kSlabs * C::kSlabBytes;
    // S = Q.K^T and dP = dO.V^T: this warpgroup's 64 queries x BK keys
    wgmma_fence();
    issue_kmajor_rs<DP, BK>(sc, qf, kt, C::kSlabBytes);
    issue_kmajor_rs<DP, BK>(dp, dof, vt, C::kSlabBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // keys past Lk (zero rows of K and V) take p = 0
    if (t * BK + BK > p.Lk) {
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const int key = t * BK + 8 * jj + c2;
        if (key >= p.Lk) sc[4 * jj] = sc[4 * jj + 2] = -CUDART_INF_F;
        if (key + 1 >= p.Lk) sc[4 * jj + 1] = sc[4 * jj + 3] = -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(sc[4 * jj + e], c, -lse[e >> 1]));
        dp[4 * jj + e] = pe * fmaf(dp[4 * jj + e], p.scale, -di[e >> 1]);
      }
    }
    to_fragments<BK>(dsf, dp);
    // dQ += dS.K
    fence_regs(dq);
    wgmma_fence();
    issue_mnmajor<DP, BK>(dq, dsf, kt, C::kSlabBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    // the stage is free once this warp's share of the three products is done
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
  }
  store_rows<DP>(dqrow, dq, c2, p.D);
}

// -------------------------------------------------------------- dK/dV

template <int DP>
struct DkvConfig {
  static constexpr int kKeys = 64 * kWGs;  // keys per block
  static constexpr int kBQ = DP <= 96 ? 64 : 32;  // query rows per tile
  static constexpr int kSlabs = (DP + kSlabCols - 1) / kSlabCols;
  static constexpr int kKVSlabBytes = kKeys * kSlabCols * 2;
  static constexpr int kKVBytes = 2 * kSlabs * kKVSlabBytes;  // K, then V
  static constexpr int kQSlabBytes = kBQ * kSlabCols * 2;
  // Q slabs, dO slabs, then lse[kBQ] and di * scale [kBQ], padded so that
  // the next stage's tiles keep the 1024-byte alignment of a 128B-swizzled
  // tile
  static constexpr int kRowsOffset = 2 * kSlabs * kQSlabBytes;
  static constexpr int kStageBytes = kRowsOffset + 1024;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // the alignment slack, K/V, the ring, then full[s], empty[s] and the K/V
  // barrier
  static constexpr int kSmemBytes = 1024 + kKVBytes + kRingBytes + (2 * kStages + 1) * 8;
  // one round of the cluster reduction (dK or dV of every consumer thread)
  // reuses the ring
  static_assert(128 * kWGs * (DP / 2) * 4 <= kRingBytes, "reduction buffer exceeds the ring");
  static_assert(kRowTile % kBQ == 0, "a query tile straddles two tiles of `rows`");
};

// The cluster's reduction of one accumulator: ranks above 0 leave theirs in
// `red` (their own ring), rank 0 adds them in rank order.
template <int R>
__device__ __forceinline__ void cluster_reduce(float (&acc)[R], float* red, int rank,
                                               int split, int ctid) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (rank != 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) red[i * 128 * kWGs + ctid] = acc[i];
  }
  cluster.sync();
  if (rank == 0) {
    for (int r = 1; r < split; ++r) {
      const float* remote = cluster.map_shared_rank(red, r);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += remote[i * 128 * kWGs + ctid];
    }
  }
  cluster.sync();  // rank 0 is done reading before the buffers change or exit
}

// One block: keys [blockIdx.y * kKeys, + kKeys) of the (b0, h) =
// divmod(blockIdx.z, H) problem; query tiles [T * r / split, T * (r + 1) /
// split) of the T tiles of its B1 * ceil(Lq / kBQ), r = blockIdx.x (the
// rank in its cluster).
template <int DP>
__device__ __forceinline__ void dkv_block(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                          const CUtensorMap* qmap, const CUtensorMap* dmap,
                                          const Problem& p) {
  using C = DkvConfig<DP>;
  constexpr int BQ = C::kBQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // generic pointer of `base`
  const uint32_t kres = base;                         // K slabs, then V slabs
  const uint32_t vres = base + C::kSlabs * C::kKVSlabBytes;
  const uint32_t ring = base + C::kKVBytes;
  const uint32_t bars = ring + C::kRingBytes;  // full[s], empty[s], kv
  const uint32_t kv_bar = bars + 16 * kStages;
  const int h = blockIdx.z % p.H;
  const int b0 = blockIdx.z / p.H;
  const int key0 = blockIdx.y * C::kKeys;
  const int rank = blockIdx.x;
  const int per_batch = (p.Lq + BQ - 1) / BQ;
  const long long n_tiles = (long long)p.B1 * per_batch;
  const long long t0 = n_tiles * rank / p.split;
  const long long t1 = n_tiles * (rank + 1) / p.split;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kWGs * 4);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 128 * kWGs) {
    // ---- producer: one thread loads K/V once, then keeps the ring of Q/dO
    // tiles and their rows full
    if (lane == 0) {
      mbar_expect_tx(kv_bar, C::kKVBytes);
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl) {
        tma_load_4d(kres + sl * C::kKVSlabBytes, kmap, kv_bar, sl * kSlabCols, key0, h, b0);
        tma_load_4d(vres + sl * C::kKVSlabBytes, vmap, kv_bar, sl * kSlabCols, key0, h, b0);
      }
      const int row_tiles = (p.Lq + kRowTile - 1) / kRowTile;
      for (long long t = t0; t < t1; ++t) {
        const int j = (int)(t - t0);
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(bars + 8 * (kStages + s), (j / kStages - 1) & 1);
        const int b1 = (int)(t / per_batch);
        const int n0 = (int)(t % per_batch) * BQ;
        const uint32_t stage = ring + s * C::kStageBytes;
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * C::kSlabs * C::kQSlabBytes + 2 * BQ * 4);
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl) {
          tma_load_5d(stage + sl * C::kQSlabBytes, qmap, full, sl * kSlabCols, n0, b1, h, b0);
          tma_load_5d(stage + (C::kSlabs + sl) * C::kQSlabBytes, dmap, full, sl * kSlabCols,
                      n0, b1, h, b0);
        }
        const long long bh = ((long long)b0 * p.B1 + b1) * p.H + h;
        const float* src = p.rows + (bh * row_tiles + n0 / kRowTile) * 2 * kRowTile + n0 % kRowTile;
        bulk_load(stage + C::kRowsOffset, src, BQ * 4, full);
        bulk_load(stage + C::kRowsOffset + BQ * 4, src + kRowTile, BQ * 4, full);
      }
    }
    if (p.split > 1) {
      // the consumers' four cluster barriers (two rounds of cluster_reduce)
      namespace cg = cooperative_groups;
      for (int i = 0; i < 4; ++i) cg::this_cluster().sync();
    }
    return;
  }

  // ---- consumers: 64 keys per warpgroup
  const int wg = threadIdx.x / 128;
  const int ctid = threadIdx.x;  // 0 .. 128 * kWGs - 1
  const int warp = (threadIdx.x % 128) / 32;
  const int c2 = (lane & 3) * 2;
  // this warpgroup's 64 key rows inside each K and V slab
  const uint32_t ka = kres + wg * 64 * kSlabCols * 2;
  const uint32_t va = vres + wg * 64 * kSlabCols * 2;
  const float c = p.scale * kLog2e;  // scores -> log2 units

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];
  uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
  mbar_wait(kv_bar, 0);
  for (long long t = t0; t < t1; ++t) {
    const int j = (int)(t - t0);
    const int s = j % kStages;
    mbar_wait(bars + 8 * s, (j / kStages) & 1);
    const uint32_t qt = ring + s * C::kStageBytes;
    const uint32_t dt = qt + C::kSlabs * C::kQSlabBytes;
    const float* rows = reinterpret_cast<const float*>(gbase + (qt - base) + C::kRowsOffset);
    // S^T = K.Q^T and dP^T = V.dO^T: this warpgroup's 64 keys x BQ queries
    wgmma_fence();
    issue_kmajor_ss<DP, BQ>(st, ka, C::kKVSlabBytes, qt, C::kQSlabBytes);
    issue_kmajor_ss<DP, BQ>(dpt, va, C::kKVSlabBytes, dt, C::kQSlabBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    // p^T and dS^T; columns 8jj + c2 + {0, 1} are this thread's queries
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj) {
      const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * jj + c2);
      const float2 d2 = *reinterpret_cast<const float2*>(rows + BQ + 8 * jj + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(st[4 * jj + e], c, -((e & 1) ? l2.y : l2.x)));
        dpt[4 * jj + e] = pe * fmaf(dpt[4 * jj + e], p.scale, -((e & 1) ? d2.y : d2.x));
        st[4 * jj + e] = pe;
      }
    }
    to_fragments<BQ>(pf, st);
    to_fragments<BQ>(dsf, dpt);
    // dV += P^T.dO and dK += dS^T.Q
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    issue_mnmajor<DP, BQ>(dv, pf, dt, C::kQSlabBytes);
    issue_mnmajor<DP, BQ>(dk, dsf, qt, C::kQSlabBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    // the stage is free once this warp's share of the four products is done
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
  }

  if (p.split > 1) {
    consumers_sync();  // both warpgroups are done with the ring
    float* red = reinterpret_cast<float*>(gbase + (ring - base));
    cluster_reduce(dk, red, rank, p.split, ctid);
    cluster_reduce(dv, red, rank, p.split, ctid);
    if (rank != 0) return;
  }
  const int ra = key0 + wg * 64 + warp * 16 + (lane >> 2);
  __nv_bfloat16* dkrow[2];
  __nv_bfloat16* dvrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = ra + 8 * i;
    const bool ok = key < p.Lk;
    dkrow[i] = ok ? p.dk + b0 * p.dk_st[0] + h * p.dk_st[1] + key * p.dk_st[2] : nullptr;
    dvrow[i] = ok ? p.dv + b0 * p.dv_st[0] + h * p.dv_st[1] + key * p.dv_st[2] : nullptr;
  }
  store_rows<DP>(dkrow, dk, c2, p.D);
  store_rows<DP>(dvrow, dv, c2, p.D);
}

// ------------------------------------------------------------------ kernels

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap dmap, const Problem p) {
  dkv_block<DP>(&kmap, &vmap, &qmap, &dmap, p);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const Problem p) {
  dq_block<DP>(&kmap, &vmap, p);
}

// -------------------------------------------------------------------- host

// The tensor map of a bf16 (B0, B1, H, L, D) operand (q or dout), strides
// (b0, b1, h, l) in elements.
inline cudaError_t make_rows_map(CUtensorMap* map, const void* ptr, int B0, int B1, int H,
                                 int L, int D, const long long (&st)[4], int box_rows) {
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)B1, (cuuint64_t)H,
                              (cuuint64_t)B0};
  const long long elems[4] = {st[3], st[1], st[2], st[0]};
  return make_slab_map(map, ptr, dims, elems, box_rows);
}

// The dK/dV kernel over B0 (b0, h) problems: a cluster launch of p.split
// CTAs (1 .. 8) per 128-key block. k, v: bf16 (B0, H, Lk, D), strides (b0,
// h, l) in elements.
template <int DP>
cudaError_t launch_dkv(const Problem& p, int B0, const void* k, const long long (&k_st)[3],
                       const void* v, const long long (&v_st)[3], cudaStream_t stream) {
  using C = DkvConfig<DP>;
  CUtensorMap kmap, vmap, qmap, dmap;
  cudaError_t err = make_kv_map(&kmap, k, B0, p.H, p.Lk, p.D, k_st[0], k_st[1], k_st[2],
                                C::kKeys);
  if (err == cudaSuccess)
    err = make_kv_map(&vmap, v, B0, p.H, p.Lk, p.D, v_st[0], v_st[1], v_st[2], C::kKeys);
  if (err == cudaSuccess)
    err = make_rows_map(&qmap, p.q, B0, p.B1, p.H, p.Lq, p.D, p.q_st, C::kBQ);
  if (err == cudaSuccess)
    err = make_rows_map(&dmap, p.dout, B0, p.B1, p.H, p.Lq, p.D, p.do_st, C::kBQ);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.split, (unsigned)((p.Lk + C::kKeys - 1) / C::kKeys),
                     (unsigned)(B0 * p.H));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_wgmma_kernel<DP>, kmap, vmap, qmap, dmap, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The dQ kernel over B0 (b0, h) problems of B1 * Lq query rows each.
template <int DP>
cudaError_t launch_dq(const Problem& p, int B0, const void* k, const long long (&k_st)[3],
                      const void* v, const long long (&v_st)[3], cudaStream_t stream) {
  using C = DqConfig<DP>;
  CUtensorMap kmap, vmap;
  cudaError_t err = make_kv_map(&kmap, k, B0, p.H, p.Lk, p.D, k_st[0], k_st[1], k_st[2],
                                C::kBK);
  if (err == cudaSuccess)
    err = make_kv_map(&vmap, v, B0, p.H, p.Lk, p.D, v_st[0], v_st[1], v_st[2], C::kBK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long M = (long long)p.B1 * p.Lq;
  const dim3 grid((unsigned)((M + C::kBQ - 1) / C::kBQ), (unsigned)(B0 * p.H));
  flash_bwd_dq_wgmma_kernel<DP><<<grid, kThreads, C::kSmemBytes, stream>>>(kmap, vmap, p);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace sm90
