// The Hopper (sm_90a) warpgroup core of the bf16 frame-attention forward
// kernels, shared by frame_attention.cu (the fused kernel) and
// flash_attention.cu (the flash kernel behind the flash and flash_rect
// wrappers). Both compute the same function,
//
//   out[b,f,h,n,:] = softmax(q[b,f,h,n,:] . k[b,h,:,:]^T * scale) . v[b,h,:,:]
//
// every frame's (or query batch's) queries against one (b, h)'s keys and
// values. The frames fold into the query axis: one (b, h) has M = F*N query
// rows, and a query tile may straddle two frames, since all frames read the
// same K/V.
//
// One block per SM, warp-specialized (Config<DP> below):
//   * consumer warpgroups (three for a padded head dim DP <= 96, else two)
//     each own 64 query rows, held as the register A operand of wgmma (bf16
//     q loaded once from global memory, the head dim zero-padded to DP, a
//     multiple of 16: 40 -> 48, 80 stays);
//   * the last warpgroup produces: after setmaxnreg.dec one thread walks the
//     key tiles and issues the TMA loads of K and V into a ring of 3-4
//     shared-memory stages, each guarded by a "full" mbarrier (TMA
//     transaction bytes) and an "empty" one (one arrival per consumer warp).
// Per key tile of BK keys (128 at DP <= 48, else 64) a consumer warpgroup
// runs
//   S = Q.K^T      wgmma m64nBKk16, DP/16 steps, A = Q from registers,
//                  B = the K tile, K-major (the head dim contiguous);
//   softmax        in registers: the quad of threads that owns a row
//                  reduces its max with two shuffles; p = exp2(s*c - m*c)
//                  with c = scale*log2(e) (one FFMA and one ex2 a score);
//                  the f32 O accumulator is rescaled once per tile; each
//                  thread keeps a partial row sum, reduced across the quad
//                  once at the end;
//   O += P.V       P rounded to bf16 in registers (the stock kernels'
//                  p.astype(v.dtype)) and fed as the register A operand:
//                  the f32 S accumulator fragment of m64nBK is, pair by
//                  pair, the A fragment of BK/16 m64nDPk16 steps; B = the V
//                  tile, MN-major (stored (keys, D), D contiguous: tnspB).
// No score, probability or output tile passes through shared memory. The
// warpgroups overlap one another: while one waits on its products, another
// runs its softmax, which is the larger cost at these head dims (one ex2
// per score against 4*D tensor-core FLOPs per score).
//
// Shared-memory layout and swizzle. K and V tiles are loaded as slabs of 64
// head-dim columns x BK keys with CU_TENSOR_MAP_SWIZZLE_128B: a 64-column
// bf16 row is exactly the 128-byte swizzle span, and the wgmma operand reads
// of a 128B-swizzled tile are free of bank conflicts. A box 64 wide over a
// head dim of 40 (or the second slab over 80) lies partly past the tensor's
// extent, and TMA fills those columns with zeros without reading them: the
// padding costs shared memory, not L2 or HBM traffic. Q.K^T reads only the
// first DP/16 k-steps of a slab and P.V's N is DP, so no tensor-core work is
// spent past DP. The alternative, 16-column slabs with 32-byte swizzle,
// needs no padding past DP but reads each 8 x 16-byte core matrix with
// two-way bank conflicts.
//
// L2. The grid runs the query tiles of one (b, h) fastest, so the blocks in
// flight share one (b, h)'s K/V (655 KB at N = 4096, D = 40) in L2. A block
// reads the whole K/V of its (b, h) once for kBQ query rows: 4*kBQ*N*D
// FLOPs per 4*N*D bytes, kBQ FLOP per byte of K/V fetched (192 with three
// consumer warpgroups). At the 64x64 edit site that is ~1.8 TB/s of L2
// reads at 1.5 ms, well inside L2's bandwidth, so the kernel does not
// multicast K/V across a cluster.
//
// Ragged lengths: rows past M load zeros and are not stored; keys past Lk
// arrive as TMA's zero fill and score -inf before the max. Residuals: when
// the caller passes m and l, each row's final max of the scaled scores
// (natural-log units) and its f32 row sum are written, the layout the flash
// backward kernels read (rows of (b, f, h), N each).

#pragma once

#include "sm90_common.cuh"

namespace sm90 {

// DP: the head dim padded to the k16 depth (16 .. 128).
template <int DP>
struct Config {
  // consumer warpgroups of 64 query rows each: three up to DP = 96, else
  // two. setmaxnreg moves registers from the producer (kProducerRegs) to
  // the consumers (kConsumerRegs) at run time, but ptxas allocates under
  // the launch bound, 65536 / kThreads (128 with three consumer
  // warpgroups, 168 with two), so S, P, O and the Q fragments must fit
  // that: keys per tile 128 up to DP = 48, else 64 (the ptxas report shows
  // 24-48 bytes of spills at DP 48 and 96, none elsewhere)
  static constexpr int kConsumerWGs = DP <= 96 ? 3 : 2;
  static constexpr int kProducerRegs = kConsumerWGs == 3 ? 32 : 24;
  static constexpr int kConsumerRegs = kConsumerWGs == 3 ? 160 : 240;
  static constexpr int kBQ = 64 * kConsumerWGs;  // query rows per block
  static constexpr int kThreads = 128 * (kConsumerWGs + 1);
  static constexpr int kBK = DP <= 48 ? 128 : 64;
  static constexpr int kSlabs = (DP + kSlabCols - 1) / kSlabCols;
  static constexpr int kSlabBytes = kBK * kSlabCols * 2;       // one slab
  static constexpr int kStageBytes = 2 * kSlabs * kSlabBytes;  // K and V
  static constexpr int kStages = kStageBytes <= 32768 ? 4 : 3;
  // the 1024-byte alignment of a 128B-swizzled tile, the ring, 2 barriers
  // a stage
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kStages * 16;
};

// One attention problem: q, o (B, F, H, N, D) through strides (last stride
// 1); K/V (B, H, Lk, D) through the two tensor maps; m, l null or
// (B, F, H, N) f32 buffers.
struct Problem {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  float* m_out;
  float* l_out;
  long long q_b, q_f, q_h, q_n;
  long long o_b, o_f, o_h, o_n;
  int F, H, N, Lk, D;
  float scale;
};

// ------------------------------------------------------------------ kernel

// S = Q.K^T of one key tile (wgmma batch, not committed): k-step kk reads
// 32 bytes of each key row of slab kk / 4.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[Config<DP>::kBK / 2],
                                         const uint32_t (&qf)[DP / 16][4], uint32_t ktile) {
  using C = Config<DP>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t desc = make_desc(ktile + (kk / 4) * C::kSlabBytes + (kk % 4) * 32, 16, 1024);
    WgmmaRS<C::kBK>::template mma<0>(sc, qf[kk], desc, kk > 0);
  }
}

// O += P.V of one key tile (wgmma batch, not committed): k-step kk reads
// key rows 16kk .. 16kk + 15 (2048 bytes on); slabs of 64 head-dim columns
// lie kSlabBytes apart.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pf)[Config<DP>::kBK / 16][4],
                                         uint32_t vtile) {
  using C = Config<DP>;
#pragma unroll
  for (int kk = 0; kk < C::kBK / 16; ++kk) {
    const uint64_t desc = make_desc(vtile + kk * 2048, C::kSlabBytes, 1024);
    WgmmaRS<DP>::template mma<1>(o, pf[kk], desc, 1);
  }
}

// The online softmax of one tile of scores, in place: sc[4j + {0,1}] hold
// row ra's keys key0 + 8j + c2 + {0,1}, sc[4j + {2,3}] row ra + 8's. Keys
// past Lk score -inf; m (raw q.k units) and this thread's partial sums l
// are updated; returns in alpha the factor that rescales O.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int key0, int c2, int Lk,
                                             float c) {
  if (key0 + BK > Lk) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int key = key0 + 8 * j + c2;
      if (key >= Lk) sc[4 * j] = sc[4 * j + 2] = -CUDART_INF_F;
      if (key + 1 >= Lk) sc[4 * j + 1] = sc[4 * j + 3] = -CUDART_INF_F;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float neg_mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // key 0 of the first tile is never masked, so mx is finite here and
    // the first tile's alpha is exp2(-inf) = 0
    alpha[i] = ex2((m[i] - mx[i]) * c);
    neg_mc[i] = -mx[i] * c;
    m[i] = mx[i];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], c, neg_mc[e >> 1]));
      sum[e >> 1] += sc[4 * j + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// The body of one block: query rows [blockIdx.x * kBQ, + kBQ) of the
// (b, h) = divmod(blockIdx.y, H) problem. Launched with Config<DP>::kThreads
// threads and Config<DP>::kSmemBytes of dynamic shared memory.
template <int DP>
__device__ __forceinline__ void attention_block(const CUtensorMap* kmap,
                                                const CUtensorMap* vmap, const Problem& p) {
  using C = Config<DP>;
  constexpr int BK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // stage s holds its K slabs at base + s * kStageBytes, then its V slabs;
  // the barriers follow the ring: full[s], then empty[s]
  const uint32_t bars = base + C::kStages * C::kStageBytes;
  const int M = p.F * p.N;
  const int h = blockIdx.y % p.H;
  const int b = blockIdx.y / p.H;
  const int n_tiles = (p.Lk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (C::kStages + s), C::kConsumerWGs * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::kConsumerWGs) {
    // ---- producer: one thread keeps the ring of K/V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::kProducerRegs) : "memory");
    if (threadIdx.x == C::kConsumerWGs * 128) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::kStages;
        const int round = t / C::kStages;
        if (round > 0) mbar_wait(bars + 8 * (C::kStages + s), (round - 1) & 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, C::kStageBytes);
        const uint32_t kdst = base + s * C::kStageBytes;
        const uint32_t vdst = kdst + C::kSlabs * C::kSlabBytes;
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl) {
          tma_load_4d(kdst + sl * C::kSlabBytes, kmap, full, sl * kSlabCols, t * BK, h, b);
          tma_load_4d(vdst + sl * C::kSlabBytes, vmap, full, sl * kSlabCols, t * BK, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::kConsumerRegs) : "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c2 = (lane & 3) * 2;
    // this thread's two rows of the accumulator fragments: ra and ra + 8
    const int ra = blockIdx.x * C::kBQ + wg * 64 + warp * 16 + (lane >> 2);
    const int rows[2] = {ra, ra + 8};
    const __nv_bfloat16* qrow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qrow[i] = nullptr;
      if (rows[i] < M) {
        const int f = rows[i] / p.N;
        const int n = rows[i] - f * p.N;
        qrow[i] = p.q + b * p.q_b + f * p.q_f + h * p.q_h + n * p.q_n;
      }
    }
    uint32_t qf[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int col = kk * 16 + c2;
      qf[kk][0] = load_pair(qrow[0], col, p.D);
      qf[kk][1] = load_pair(qrow[1], col, p.D);
      qf[kk][2] = load_pair(qrow[0], col + 8, p.D);
      qf[kk][3] = load_pair(qrow[1], col + 8, p.D);
    }

    const float c = p.scale * 1.4426950408889634f;  // scores -> log2 units
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};      // running max, raw q.k
    float l[2] = {0.f, 0.f};                          // this thread's partial sums
    float alpha[2];
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float sc[BK / 2];
    uint32_t pf[BK / 16][4];
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(bars + 8 * (t % C::kStages), (t / C::kStages) & 1);
      const uint32_t ktile = base + (t % C::kStages) * C::kStageBytes;
      wgmma_fence();
      issue_qk<DP>(sc, qf, ktile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile<BK>(sc, m, l, alpha, t * BK, c2, p.Lk, c);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      // P in bf16: the accumulator pairs of keys 16kk .. 16kk + 15 are the
      // A fragment of P.V's k-step kk
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pf[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      }
      fence_regs(o);
      wgmma_fence();
      issue_pv<DP>(o, pf, ktile + C::kSlabs * C::kSlabBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      // the stage is free once this warp's share of both products is done
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (C::kStages + t % C::kStages));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= M) continue;
      const int f = rows[i] / p.N;
      const int n = rows[i] - f * p.N;
      __nv_bfloat16* orow = p.o + b * p.o_b + f * p.o_f + h * p.o_h + n * p.o_n;
      const float inv = 1.f / l[i];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        store_pair(orow, 8 * j + c2, p.D, o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if (p.m_out != nullptr && (lane & 3) == 0) {
        const long long r = ((long long)(b * p.F + f) * p.H + h) * p.N + n;
        p.m_out[r] = m[i] * p.scale;  // natural-log units of the scaled scores
        p.l_out[r] = l[i];
      }
    }
  }
}

// -------------------------------------------------------------------- host

typedef void (*KernelFn)(const CUtensorMap, const CUtensorMap, const Problem);

// One launch of `kernel` (a __global__ wrapper of attention_block<DP>) over
// B (b, h) problems of p.F * p.N query rows. k, v: bf16 (B, H, Lk, D) with
// the strides (b, h, l) in elements.
template <int DP>
cudaError_t launch(KernelFn kernel, const Problem& p, int B, const void* k,
                   const long long (&k_st)[3], const void* v, const long long (&v_st)[3],
                   cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  constexpr int BK = Config<DP>::kBK;
  cudaError_t err = make_kv_map(&kmap, k, B, p.H, p.Lk, p.D, k_st[0], k_st[1], k_st[2], BK);
  if (err != cudaSuccess) return err;
  err = make_kv_map(&vmap, v, B, p.H, p.Lk, p.D, v_st[0], v_st[1], v_st[2], BK);
  if (err != cudaSuccess) return err;
  using C = Config<DP>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long M = (long long)p.F * p.N;
  const dim3 grid((unsigned)((M + C::kBQ - 1) / C::kBQ), (unsigned)(B * p.H));
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(kmap, vmap, p);
  return cudaGetLastError();
}

}  // namespace sm90
