// GroupNorm (+ optional SiLU) for Hopper (sm_90a) over x of shape
// (N, rows, C), channels last.
//
// Replaces the TPU kernel videop2p_tpu/ops/groupnorm.py:
// fused_group_norm -> _fused_gn -> _gn_kernel (pl.pallas_call).
//
//   mean, var over (rows x C/G) per (sample n, group g), f32,
//   var = E[x^2] - E[x]^2 (biased; the JAX kernel's formula),
//   y = x*a + c with a = rsqrt(var + eps)*scale, c = bias - mean*a,
//   optionally y*sigmoid(y), stored in x's dtype.
//
// Bound on this card: bytes. One read of x and one write of y,
// 2*N*rows*C*itemsize bytes, at a few operations per element. The TPU
// kernel keeps one sample's slab in VMEM and reads it once. Here the
// statistics need every row of a sample before its first output, and a
// frame-pooled resnet slab reaches 3 x 32768 x 960 fp32 = 377 MB.
//
// Design: one persistent, cooperative launch a call (gn_persistent_kernel).
//   - The grid is one block per SM. Block b owns the flat rows
//     [b*R/P, (b+1)*R/P) of the R = N*rows rows (ops/groupnorm.py:plan
//     mirrors this split). A thread owns one column of VEC channels (16
//     bytes: 4 fp32 or 8 bf16; 1 channel when a row is not a whole number of
//     16-byte vectors or x is not 16-byte aligned) and a row lane: lanes x
//     columns tile the block's threads.
//   - Phase 1, sample segment by sample segment: the first smem_rows rows of
//     the block's range go to shared memory by cp.async, every one of a
//     thread's copies in flight at once (up to 227 KB a block, 26-28 MB over
//     the card; L2 evict-first, so that the L2 keeps the rows read last);
//     meanwhile the rest streams through registers in predicated batches of
//     8 loads. Each thread sums x and x^2 of its channels in f32 (the rows
//     off chip in order, then the rows on chip); row lanes, then channels,
//     fold into groups in a fixed order (shared memory, then a warp
//     butterfly); the block writes one (sum, sum of squares) per (sample,
//     its slot among the blocks that hold the sample, group) to a scratch
//     buffer the wrapper allocates once and reuses.
//   - A grid barrier: each block takes a ticket from a 64-bit counter in the
//     scratch (the kernel's one atomic; it orders nothing that is summed)
//     and waits until the counter reaches the end of this launch's tickets.
//     The counter is never reset: every launch has the same grid, so a
//     launch's tickets are one whole multiple of the grid.
//   - Phase 2: each block reads the partials of the samples its range
//     touches (coalesced: warp w takes slots w, w + warps, ..., lane = group)
//     and sums them in a fixed order, so every block that needs a sample's
//     statistics computes the same bits; then it applies its range in the
//     reverse order of phase 1: the rows off chip first (the last of them
//     read are still in the 50 MB L2), then the rows in shared memory.
//     Coefficients (a, c) live in registers (a thread's channels never
//     change); y is stored with st.global.cs so that it does not push x out
//     of the L2.
// Where a call's x fits in the grid's shared memory, x crosses HBM once.
// No float atomics: repeats are bit-identical.
//
// Staged entry (group_norm_staged), for a slab whose rows are split over
// several GPUs (the frame-pooled resnet norms when frames are sharded):
//   - kStats runs phase 1, the barrier and phase 2a with the fused launch's
//     geometry, so its per-(sample, group) sums are the fused launch's bits,
//     and writes them as (sum, sum of squares) to sums[N][G] (the first
//     block of each sample writes them) instead of applying;
//   - the caller all-reduces sums over the shards;
//   - kApply reads the reduced sums, takes mean and variance over
//     rows x C/G x shards elements (the same E[x^2] - E[x]^2) and runs
//     phase 2b over the whole range from global memory (no slab, no
//     barrier).
// With one shard the two launches give the fused launch's bits.

#include <atomic>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kUnroll = 8;
// dynamic shared memory one block may use on sm_90
constexpr int kSmemLimit = 232448;
// polls of the grid barrier before the kernel traps instead of hanging
constexpr long long kMaxPolls = 1LL << 30;

template <typename T, int VEC> struct RawOf;
template <> struct RawOf<float, 4> { using type = uint4; };
template <> struct RawOf<__nv_bfloat16, 8> { using type = uint4; };
template <> struct RawOf<float, 1> { using type = unsigned int; };
template <> struct RawOf<__nv_bfloat16, 1> { using type = unsigned short; };

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const typename RawOf<T, VEC>::type& r, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) f[0] = __uint_as_float(r);
    else f[0] = __uint_as_float(static_cast<unsigned>(r) << 16);
  } else {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        f[i] = __uint_as_float(w[i]);
      } else {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ typename RawOf<T, VEC>::type pack(const float (&f)[VEC]) {
  typename RawOf<T, VEC>::type r;
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) r = __float_as_uint(f[0]);
    else r = __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(f[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&h);
      }
    }
    r = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return r;
}

__device__ __forceinline__ float load_param(const void* p, int c, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

__device__ __forceinline__ void warp_sum2(float& s, float& q) {
  // xor butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    q += __shfl_xor_sync(0xffffffffu, q, m);
  }
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, uint64_t policy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "l"(policy) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}


// what one launch does: the whole norm, the statistics alone, or the apply
// of statistics summed elsewhere
constexpr int kFused = 0;
constexpr int kStats = 1;
constexpr int kApply = 2;

struct GnArgs {
  const void* x;
  void* y;
  const void* scale;
  const void* bias;
  unsigned long long* ticket;  // grid barrier counter (scratch[0:8])
  float2* partial;             // [N][S][G] (sum, sum of squares) (scratch[16:])
  float2* sums;                // [N][G] (sum, sum of squares): kStats out, kApply in
  int total;                   // N * rows
  int rows, C, G, K, S;
  int lanes, colsets, smem_rows;
  int param_bf16, silu;
  int mode, shards;            // kFused / kStats / kApply; slabs the sums span
  float eps;
};

// first flat row of block b (of P) over R rows
__device__ __forceinline__ int block_start(int b, int P, int R) {
  return static_cast<int>(static_cast<long long>(b) * R / P);
}

// the block (of P) whose range holds flat row r: the largest b with
// block_start(b) <= r
__device__ __forceinline__ int block_of(int r, int P, int R) {
  return static_cast<int>((static_cast<long long>(r + 1) * P - 1) / R);
}

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const typename RawOf<T, VEC>::type& v,
                                           float (&s)[VEC], float (&q)[VEC]) {
  float f[VEC];
  unpack<T, VEC>(v, f);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s[i] += f[i];
    q[i] = fmaf(f[i], f[i], q[i]);
  }
}

// Phase 1 over rows [a, b) of one column through registers, in order, in
// predicated batches of kUnroll loads; kToSmem also stores each row to the
// slab (rows [r0, r0 + smem_rows) of the block's range).
template <typename T, int VEC, bool kToSmem>
__device__ __forceinline__ void stats_rows(const typename RawOf<T, VEC>::type* __restrict__ xv,
                                           typename RawOf<T, VEC>::type* slab, int a, int b,
                                           int r0, int L, int rl, int col, int CV,
                                           float (&s)[VEC], float (&q)[VEC]) {
  using Raw = typename RawOf<T, VEC>::type;
  for (int r = a + rl; r < b; r += kUnroll * L) {
    Raw v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r + u * L;
      v[u] = ru < b ? __ldg(xv + static_cast<long long>(ru) * CV + col) : Raw();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r + u * L;
      if (ru < b) {
        if (kToSmem) slab[(ru - r0) * CV + col] = v[u];
        accumulate<T, VEC>(v[u], s, q);
      }
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void apply_vec(const typename RawOf<T, VEC>::type& v,
                                          typename RawOf<T, VEC>::type* out,
                                          const float (&A)[VEC], const float (&B)[VEC],
                                          int silu) {
  float f[VEC];
  unpack<T, VEC>(v, f);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float val = fmaf(f[i], A[i], B[i]);
    if (silu) {
      if constexpr (sizeof(T) == 2) {
        // x*sigmoid(x) = h*tanh(h) + h, h = x/2: one MUFU op (tanh.approx,
        // ~2^-11 relative) where the output rounds to 2^-9
        float th;
        const float h = 0.5f * val;
        asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(h));
        val = fmaf(h, th, h);
      } else {
        val = __fdividef(val, 1.f + __expf(-val));
      }
    }
    f[i] = val;
  }
  __stcs(out, pack<T, VEC>(f));
}

// Phase 2 over rows [a, b) of one column, walked from b - 1 down in
// predicated batches: from the slab when kFromSmem, else re-read from
// global memory (last use).
template <typename T, int VEC, bool kFromSmem>
__device__ __forceinline__ void apply_rows(const typename RawOf<T, VEC>::type* __restrict__ xv,
                                           typename RawOf<T, VEC>::type* __restrict__ yv,
                                           const typename RawOf<T, VEC>::type* slab, int a,
                                           int b, int r0, int L, int rl, int col, int CV,
                                           const float (&A)[VEC], const float (&B)[VEC],
                                           int silu) {
  using Raw = typename RawOf<T, VEC>::type;
  for (int r = b - 1 - rl; r >= a; r -= kUnroll * L) {
    Raw v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r - u * L;
      if (ru >= a)
        v[u] = kFromSmem ? slab[(ru - r0) * CV + col]
                         : __ldcs(xv + static_cast<long long>(ru) * CV + col);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r - u * L;
      if (ru >= a)
        apply_vec<T, VEC>(v[u], yv + static_cast<long long>(ru) * CV + col, A, B, silu);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 1) gn_persistent_kernel(const GnArgs args) {
  using Raw = typename RawOf<T, VEC>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = gridDim.x;
  const int R = args.total;
  const int rows = args.rows, C = args.C, G = args.G, S = args.S;
  const int CV = C / VEC;
  const int cpg = C / G;
  const int L = args.lanes;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31, warps = blockDim.x >> 5;
  // thread -> (row lane, first column); colsets > 1 only when lanes == 1
  const int col0 = args.colsets == 1 ? t % CV : t;
  const int rl = args.colsets == 1 ? t / CV : 0;
  const bool active = rl < L;

  const Raw* xv = static_cast<const Raw*>(args.x);
  Raw* yv = static_cast<Raw*>(args.y);
  Raw* slab = reinterpret_cast<Raw*>(smem);
  const size_t slab_bytes =
      (static_cast<size_t>(args.smem_rows) * CV * sizeof(Raw) + 15) & ~static_cast<size_t>(15);
  float* red_s = reinterpret_cast<float*>(smem + slab_bytes);  // [L][C]
  float* red_q = red_s + L * C;                                 // [L][C]
  float* stats = red_q + L * C;                                 // [K][G][2]
  float2* xsum = reinterpret_cast<float2*>(stats + args.K * G * 2);  // [warps][G]

  const int r0 = block_start(blockIdx.x, P, R);
  const int r1 = block_start(blockIdx.x + 1, P, R);
  const int on_end = r0 + min(r1 - r0, args.smem_rows);  // rows [r0, on_end) on chip
  const int n_first = r0 / rows;
  const int n_last = r1 > r0 ? (r1 - 1) / rows : n_first - 1;

  const float cnt = static_cast<float>(rows) * static_cast<float>(cpg) *
                    static_cast<float>(args.shards);
  if (args.mode == kApply) {
    // ---- the sums of every shard, reduced by the caller
    for (int i = t; i < (n_last - n_first + 1) * G; i += blockDim.x) {
      const float2 v = args.sums[static_cast<long long>(n_first) * G + i];
      const float mean = v.x / cnt;
      const float var = __fsub_rn(v.y / cnt, __fmul_rn(mean, mean));
      stats[2 * i] = mean;
      stats[2 * i + 1] = rsqrtf(var + args.eps);
    }
    __syncthreads();
  } else {
    // ---- phase 1: per-channel sums, then this block's per-group partials
    for (int n = n_first; n <= n_last; ++n) {
      const int s0 = max(r0, n * rows), s1 = min(r1, (n + 1) * rows);
      const int on_lo = s0, on_hi = min(s1, on_end);   // on chip
      const int off_lo = max(s0, on_end), off_hi = s1;  // streamed
      for (int j = 0; j < args.colsets; ++j) {
        const int col = col0 + j * blockDim.x;
        if (!active || col >= CV) continue;
        float s[VEC], q[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
        if constexpr (VEC * sizeof(T) == 16) {
          // every on-chip row of this thread in flight at once, then the rest
          // through registers while they land
          const uint64_t policy = evict_first_policy();
          for (int r = on_lo + rl; r < on_hi; r += L)
            cp_async16(slab + (r - r0) * CV + col, xv + static_cast<long long>(r) * CV + col,
                       policy);
          stats_rows<T, VEC, false>(xv, slab, off_lo, off_hi, r0, L, rl, col, CV, s, q);
          cp_async_wait_all();
          for (int r = on_lo + rl; r < on_hi; r += L)
            accumulate<T, VEC>(slab[(r - r0) * CV + col], s, q);
        } else {
          stats_rows<T, VEC, false>(xv, slab, off_lo, off_hi, r0, L, rl, col, CV, s, q);
          stats_rows<T, VEC, true>(xv, slab, on_lo, on_hi, r0, L, rl, col, CV, s, q);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          red_s[rl * C + col * VEC + i] = s[i];
          red_q[rl * C + col * VEC + i] = q[i];
        }
      }
      __syncthreads();
      const int slot = blockIdx.x - block_of(n * rows, P, R);
      for (int g = warp; g < G; g += warps) {
        float ss = 0.f, qq = 0.f;
        for (int cc = lane; cc < cpg; cc += 32) {
          for (int l = 0; l < L; ++l) {
            ss += red_s[l * C + g * cpg + cc];
            qq += red_q[l * C + g * cpg + cc];
          }
        }
        warp_sum2(ss, qq);
        if (lane == 0)
          args.partial[(static_cast<long long>(n) * S + slot) * G + g] = make_float2(ss, qq);
      }
      __syncthreads();
    }
    // an empty range that starts inside a sample holds a slot of it: zeros
    if (r1 == r0 && r0 < R && r0 % rows != 0) {
      const int n = r0 / rows;
      const int slot = blockIdx.x - block_of(n * rows, P, R);
      for (int g = t; g < G; g += blockDim.x)
        args.partial[(static_cast<long long>(n) * S + slot) * G + g] = make_float2(0.f, 0.f);
    }

    // ---- grid barrier (the one atomic: a ticket; nothing summed depends on it)
    __threadfence();
    __syncthreads();
    if (t == 0) {
      const unsigned long long ticket = atomicAdd(args.ticket, 1ULL);
      const unsigned long long target = (ticket / P + 1) * P;
      unsigned long long seen;
      long long polls = 0;
      for (;;) {
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(seen) : "l"(args.ticket) : "memory");
        if (seen >= target) break;
        if (++polls > kMaxPolls) __trap();
        __nanosleep(32);
      }
      __threadfence();
    }
    __syncthreads();
    if (r1 == r0) return;

    // ---- phase 2a: statistics of the samples this block touches: warp w sums
    // slots w, w + warps, ... (lane = group), then each group its warps, in
    // order; the same bits in every block that holds the sample
    for (int n = n_first; n <= n_last; ++n) {
      const int nb = block_of((n + 1) * rows - 1, P, R) - block_of(n * rows, P, R) + 1;
      const float2* ps = args.partial + static_cast<long long>(n) * S * G;
      for (int g = lane; g < G; g += 32) {
        float ss = 0.f, qq = 0.f;
        for (int base = warp; base < nb; base += kUnroll * warps) {
          float2 v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int slot = base + u * warps;
            v[u] = slot < nb ? __ldcg(ps + static_cast<long long>(slot) * G + g)
                             : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (base + u * warps < nb) {
              ss += v[u].x;
              qq += v[u].y;
            }
          }
        }
        xsum[warp * G + g] = make_float2(ss, qq);
      }
      __syncthreads();
      const bool first = blockIdx.x == block_of(n * rows, P, R);
      for (int g = t; g < G; g += blockDim.x) {
        float ss = 0.f, qq = 0.f;
        for (int w = 0; w < warps; ++w) {
          ss += xsum[w * G + g].x;
          qq += xsum[w * G + g].y;
        }
        if (args.mode == kStats) {
          if (first) args.sums[static_cast<long long>(n) * G + g] = make_float2(ss, qq);
          continue;
        }
        const float mean = ss / cnt;
        const float var = __fsub_rn(qq / cnt, __fmul_rn(mean, mean));
        stats[((n - n_first) * G + g) * 2] = mean;
        stats[((n - n_first) * G + g) * 2 + 1] = rsqrtf(var + args.eps);
      }
      __syncthreads();
    }
  }
  if (args.mode == kStats || r1 == r0) return;

  // ---- phase 2b: apply, in the reverse order of phase 1
  for (int n = n_last; n >= n_first; --n) {
    const int s0 = max(r0, n * rows), s1 = min(r1, (n + 1) * rows);
    const float* st = stats + (n - n_first) * G * 2;
    for (int j = args.colsets - 1; j >= 0; --j) {
      const int col = col0 + j * blockDim.x;
      if (!active || col >= CV) continue;
      float A[VEC], B[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = col * VEC + i;
        const int g = c / cpg;
        const float a = st[2 * g + 1] * load_param(args.scale, c, args.param_bf16);
        A[i] = a;
        B[i] = load_param(args.bias, c, args.param_bf16) - st[2 * g] * a;
      }
      apply_rows<T, VEC, false>(xv, yv, slab, max(s0, on_end), s1, r0, L, rl, col, CV, A, B,
                                args.silu);
      apply_rows<T, VEC, true>(xv, yv, slab, s0, min(s1, on_end), r0, L, rl, col, CV, A, B,
                               args.silu);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const GnArgs& args, int grid, int threads, int smem_bytes,
                   cudaStream_t stream) {
  auto kernel = gn_persistent_kernel<T, VEC>;
  // the shared-memory attribute belongs to a device: set it once on each
  // device this process launches on (a data mesh launches on several)
  static std::atomic<unsigned long long> attr_set{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (device > 63 || !(attr_set.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit);
  }
  void* params[] = {const_cast<GnArgs*>(&args)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(threads), params, static_cast<size_t>(smem_bytes),
                                     stream);
}

int run(const void* x, const void* scale, const void* bias, void* y, void* scratch,
        void* sums, int mode, int dtype, int param_bf16, int N, int rows, int C, int G,
        int vec, int threads, int lanes, int colsets, int grid, int K, int S, int smem_rows,
        int smem_bytes, float eps, int silu, int shards, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const long long total = static_cast<long long>(N) * rows;
  if (dtype < 0 || dtype > 1 || N < 1 || rows < 1 || C < 1 || G < 1 || C % G != 0 ||
      total > 0x7fffffffLL || grid < 1 || K < 1 || S < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || lanes < 1 || colsets < 1 ||
      smem_rows < 0 || smem_bytes < 0 || smem_bytes > kSmemLimit || mode < kFused ||
      mode > kApply || shards < 1 || (mode != kFused && sums == nullptr) ||
      (mode == kApply && smem_rows != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec != 1 && vec * itemsize != 16) return static_cast<int>(cudaErrorInvalidValue);
  if (C % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int CV = C / vec;
  // the thread tiling: lanes x CV <= threads, or lanes 1 and colsets x threads >= CV
  const bool tiled = colsets == 1 ? static_cast<long long>(lanes) * CV <= threads
                                  : lanes == 1 && static_cast<long long>(colsets) * threads >= CV;
  const long long slab = (static_cast<long long>(smem_rows) * C * itemsize + 15) / 16 * 16;
  const long long need = slab + (2LL * lanes * C + 2LL * K * G + 2LL * (threads / 32) * G) * 4;
  if (!tiled || need > smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  // every block's range touches at most K samples, every sample at most S blocks
  for (int b = 0; b < grid; ++b) {
    const long long r0 = b * total / grid, r1 = (b + 1) * total / grid;
    if (r1 > r0 && (r1 - 1) / rows - r0 / rows + 1 > K)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (long long n = 0; n < N; ++n) {
    const long long b_lo = ((n * rows + 1) * grid - 1) / total;
    const long long b_hi = (((n + 1) * rows) * grid - 1) / total;
    if (b_hi - b_lo + 1 > S) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec > 1 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);

  GnArgs args;
  args.x = x;
  args.y = y;
  args.scale = scale;
  args.bias = bias;
  args.ticket = static_cast<unsigned long long*>(scratch);
  args.partial = reinterpret_cast<float2*>(static_cast<unsigned char*>(scratch) + 16);
  args.sums = static_cast<float2*>(sums);
  args.total = static_cast<int>(total);
  args.rows = rows;
  args.C = C;
  args.G = G;
  args.K = K;
  args.S = S;
  args.lanes = lanes;
  args.colsets = colsets;
  args.smem_rows = smem_rows;
  args.param_bf16 = param_bf16;
  args.silu = silu;
  args.mode = mode;
  args.shards = shards;
  args.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec == 1 ? launch<float, 1>(args, grid, threads, smem_bytes, s)
                   : launch<float, 4>(args, grid, threads, smem_bytes, s);
  else
    err = vec == 1 ? launch<__nv_bfloat16, 1>(args, grid, threads, smem_bytes, s)
                   : launch<__nv_bfloat16, 8>(args, grid, threads, smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y); param_bf16: scale and bias
// are bfloat16 (else float32). scratch: 16 bytes (the barrier's 64-bit
// counter, zero when first allocated, never reset) then N*S*G (sum, sum of
// squares) float pairs. The launch geometry (vec, threads, lanes, colsets,
// grid, K samples a block at most, S blocks a sample at most, smem_rows,
// smem_bytes) is ops/groupnorm.py:plan's. Returns the first cudaError_t
// raised; a refused cooperative launch (grid not co-resident) is returned,
// never run.
extern "C" int group_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                              void* scratch, int dtype, int param_bf16, int N, int rows, int C,
                              int G, int vec, int threads, int lanes, int colsets, int grid,
                              int K, int S, int smem_rows, int smem_bytes, float eps, int silu,
                              void* stream) {
  return run(x, scale, bias, y, scratch, nullptr, kFused, dtype, param_bf16, N, rows, C, G,
             vec, threads, lanes, colsets, grid, K, S, smem_rows, smem_bytes, eps, silu, 1,
             stream);
}

// One launch of the staged norm (the header's "Staged entry"): mode 1
// writes sums[N][G] = (sum, sum of squares) of x in f32 and touches neither
// y, scale nor bias; mode 2 reads sums (every shard's, reduced) and writes
// y, over rows x C/G x shards elements a (sample, group), with smem_rows 0.
// The other arguments are group_norm_fwd's.
extern "C" int group_norm_staged(const void* x, const void* scale, const void* bias, void* y,
                                 void* scratch, void* sums, int mode, int dtype, int param_bf16,
                                 int N, int rows, int C, int G, int vec, int threads, int lanes,
                                 int colsets, int grid, int K, int S, int smem_rows,
                                 int smem_bytes, float eps, int silu, int shards, void* stream) {
  if (mode != kStats && mode != kApply) return static_cast<int>(cudaErrorInvalidValue);
  return run(x, scale, bias, y, scratch, sums, mode, dtype, param_bf16, N, rows, C, G, vec,
             threads, lanes, colsets, grid, K, S, smem_rows, smem_bytes, eps, silu, shards,
             stream);
}

extern "C" const char* groupnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
