// The pieces of the Hopper (sm_90a) 3xTF32 warpgroup cores, shared by the
// float32 flash-attention backward (flash_attention_bwd_tf32_sm90.cuh: the
// dQ and dK/dV kernels) and the float32 frame-attention forward
// (frame_attention_tf32_sm90.cuh: the fused and flash forward kernels):
//   * the TF32 split of an f32 value (cvt.rna) and the 3xTF32 products as
//     wgmma m64nNk8 .tf32 passes, A from shared memory or from registers;
//   * the no-swizzle K-major shared-memory tile layout, its descriptor, and
//     the map from a tile image's floats to the (row, column) they hold,
//     with the sigma permutation of a D x rows tile;
//   * the ring of streamed tiles: bulk copies (cp.async.bulk) issued by one
//     producer thread, full / empty mbarriers per stage.
// Both cores run a block of kWGs consumer warpgroups and one producer warp,
// and read tiles that a prep kernel wrote as their exact shared-memory
// images, so a stage is one bulk copy and no tensor map exists.
//
// Precision: every product a.b runs as a_hi.b_hi + a_hi.b_lo + a_lo.b_hi
// with a_hi = tf32(a), a_lo = tf32(a - a_hi) (cvt.rna: round to nearest,
// ties away from zero), f32 accumulation, the cross terms issued before
// hi.hi. Every operand handed to the tensor core is a TF32 value (its low
// 13 mantissa bits are zero), so whether the hardware rounds or truncates a
// raw f32 operand does not matter. Each product then carries about 2^-21 of
// relative error (one TF32 pass: 2^-11); tests/test_torch_tf32x3.py emulates
// the arithmetic. PyTorch's own products and convolutions keep TF32 off.
//
// What Hopper asks of 32-bit operands:
//   * wgmma transposes only 16-bit operands: a .tf32 operand in shared
//     memory is K-major (the reduction axis contiguous).
//   * The register A fragment of m64nNk8.tf32 puts, per 8-wide k step,
//     columns t and t + 4 in a thread (t = lane % 4), where the f32
//     accumulator of the previous product holds columns 2t and 2t + 1. The
//     accumulator is used as the A fragment as it is, which permutes the
//     reduction index within each group of 8 by sigma = (0 2 4 6 1 3 5 7)
//     (fragment position p holds accumulator column sigma(p)); a D x rows
//     tile that such a fragment multiplies holds its rows in the same
//     permutation within each group of 8, so the sums are unchanged.
//   * Shared-memory tiles use the no-swizzle (interleaved) K-major layout:
//     8 rows x 16 bytes per core matrix, the K-adjacent core matrix 128
//     bytes on (LBO), the next 8 rows 32 * K bytes on (SBO). A tile of rows
//     starting at a multiple of 8 is one contiguous range, and D pads only
//     to the next of the instantiated widths DP = 16, 32, 40, 48, 64, 80,
//     96, 128 (40 and 80 not at all; padded columns hold 0).

#pragma once

#include "sm90_common.cuh"

namespace sm90 {
namespace tf32 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWGs = 2;                    // consumer warpgroups
constexpr int kThreads = 128 * kWGs + 32;  // and one producer warp
constexpr int kPrepThreads = 256;
constexpr int kSmemMax = 232448;           // shared memory a block can use

// Stages of a ring of `stage` bytes beside `resident` bytes (at most 4),
// and the dynamic shared memory of such a block: alignment slack, the
// resident tiles, the ring, full[s], empty[s] and the resident tiles' barrier.
constexpr int ring_stages(int resident, int stage) {
  return (kSmemMax - 256 - resident) / stage < 4 ? (kSmemMax - 256 - resident) / stage : 4;
}
constexpr int smem_bytes(int resident, int stage) {
  return 128 + resident + ring_stages(resident, stage) * stage +
         (2 * ring_stages(resident, stage) + 1) * 8;
}

// Position p of a group of 8 along a D x rows tile's reduction axis holds
// row sigma(p) of the group: the order in which an f32 accumulator, used as
// the register A fragment as it is, presents its columns.
__host__ __device__ constexpr int sigma(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }

// ------------------------------------------------------------- PTX extras

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// a = hi + lo, both TF32 values.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
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

// A barrier among the consumer warpgroups alone.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kWGs) : "memory");
}

// The descriptor of a no-swizzle K-major operand at `addr`: K-adjacent core
// matrices 128 bytes apart, 8-row groups `sbo` bytes apart.
__device__ __forceinline__ uint64_t desc_ns(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// wgmma m64nNk8, f32 += tf32 x tf32: A (64 x 8) from four registers, or both
// operands from shared memory; B K-major.
template <int N> struct WgmmaRS;
template <int N> struct WgmmaSS;

template <> struct WgmmaRS<8> {
  static __device__ __forceinline__ void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  }
};

template <> struct WgmmaRS<16> {
  static __device__ __forceinline__ void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  }
};

template <> struct WgmmaRS<32> {
  static __device__ __forceinline__ void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  }
};

template <> struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  }
};

template <> struct WgmmaSS<8> {
  static __device__ __forceinline__ void mma(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// ------------------------------------------------------------ products

// acc (64 x N) (+)= A (64 x DP) . B (N x DP)^T, one pass: both operands
// K-major tiles of DP columns in shared memory (a, b); the first pass of a
// product overwrites acc.
template <int DP, int N>
__device__ __forceinline__ void ss_pass(float (&acc)[N / 2], uint32_t a, uint32_t b,
                                        bool first) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
    WgmmaSS<N>::mma(acc, desc_ns(a + 256 * kk, 32 * DP), desc_ns(b + 256 * kk, 32 * DP),
                    (first && kk == 0) ? 0 : 1);
}

// The 3xTF32 product from the hi and lo tiles: the cross terms, then hi.hi.
template <int DP, int N>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                           uint32_t b_hi, uint32_t b_lo) {
  ss_pass<DP, N>(acc, a_lo, b_hi, true);
  ss_pass<DP, N>(acc, a_hi, b_lo, false);
  ss_pass<DP, N>(acc, a_hi, b_hi, false);
}

// Columns [C0, DP) of acc (64 x DP) += one k step of A (four fragment
// registers) . B, where b is the k step's start in a DP x K tile (rows of B's
// N axis, K columns): wgmma's N in pieces of 64, 32, 16 and 8.
template <int DP, int K, int C0>
__device__ __forceinline__ void rs_step(float* acc, uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b) {
  if constexpr (C0 < DP) {
    constexpr int W = DP - C0 >= 64 ? 64 : DP - C0 >= 32 ? 32 : DP - C0 >= 16 ? 16 : 8;
    WgmmaRS<W>::mma(acc + C0 / 2, a0, a1, a2, a3, desc_ns(b + (C0 / 8) * 32 * K, 32 * K));
    rs_step<DP, K, C0 + W>(acc, a0, a1, a2, a3, b);
  }
}

// acc (64 x DP) += F (64 x K) . B (K x DP), one pass. F is an f32
// accumulator's layout rounded to TF32 (f[4kk + e]: rows g, g, g + 8, g + 8
// and columns 8kk + 2t, 2t + 1, 2t, 2t + 1); as fragments its columns 2t and
// 2t + 1 land at k positions t and t + 4 (sigma), as the D x K tile b holds
// them.
template <int DP, int K>
__device__ __forceinline__ void rs_pass(float (&acc)[DP / 2], const uint32_t (&f)[K / 2],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    rs_step<DP, K, 0>(acc, f[4 * kk], f[4 * kk + 2], f[4 * kk + 1], f[4 * kk + 3],
                      b + 256 * kk);
}

template <int DP, int K>
__device__ __forceinline__ void rs_product(float (&acc)[DP / 2], const uint32_t (&hi)[K / 2],
                                           const uint32_t (&lo)[K / 2], uint32_t b_hi,
                                           uint32_t b_lo) {
  rs_pass<DP, K>(acc, lo, b_hi);
  rs_pass<DP, K>(acc, hi, b_lo);
  rs_pass<DP, K>(acc, hi, b_hi);
}

// Rows ra and ra + 8 of an m64nDP accumulator to an f32 (rows, D) output
// (row pointers null past the end).
template <int DP>
__device__ __forceinline__ void store_rows(float* (&row)[2], const float (&acc)[DP / 2], int c2,
                                           int D) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c2;
      if (col < D) row[i][col] = acc[4 * j + 2 * i];
      if (col + 1 < D) row[i][col + 1] = acc[4 * j + 2 * i + 1];
    }
  }
}

// ------------------------------------------------------------ tile images

// The float of a T x DP tile (natural: row r, column c) or of a DP x T tile
// (transposed: row c, column p at position p, holding row r = 8 (p / 8) +
// sigma(p % 8)) that sits at index o of the tile's no-swizzle image.
template <int DP, int T>
__device__ __forceinline__ void tile_source(int o, bool transposed, int& r, int& c) {
  const int cols = transposed ? T : DP;
  const int g = o / (8 * cols);
  const int rem = o - g * 8 * cols;
  const int row = 8 * g + ((rem & 31) >> 2);
  const int col = 4 * (rem >> 5) + (rem & 3);
  if (transposed) {
    r = (col & ~7) + sigma(col & 7);
    c = row;
  } else {
    r = row;
    c = col;
  }
}

// The inverse for a natural tile of K = DP columns: the image index of
// row r, column c (c a multiple of 4 starts 16 aligned bytes).
template <int DP>
__host__ __device__ constexpr int tile_offset(int r, int c) {
  return (r >> 3) * 8 * DP + (c >> 2) * 32 + (r & 7) * 4 + (c & 3);
}

// ------------------------------------------------------------ the ring

// Barrier setup of a block: full[s] (the producer's arrival and the bytes),
// empty[s] (one arrival per consumer warp that reads the stage), and one
// more barrier at bars + 16 * S (the backward's resident tiles).
template <int S>
__device__ __forceinline__ void init_barriers(uint32_t bars, uint32_t consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), consumers);
    }
    mbar_init(bars + 16 * S, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer thread's walk: the n tiles of `stream` (stage_bytes each,
// back to back) through the S-stage ring, each stage reused once every
// consumer warp has arrived on its empty barrier.
template <int S>
__device__ __forceinline__ void stream_tiles(uint32_t ring, uint32_t bars, const uint8_t* stream,
                                             int stage_bytes, int n) {
  for (int t = 0; t < n; ++t) {
    const int s = t % S;
    if (t >= S) mbar_wait(bars + 8 * (S + s), (t / S - 1) & 1);
    const uint32_t full = bars + 8 * s;
    mbar_expect_tx(full, stage_bytes);
    bulk_load(ring + s * stage_bytes, stream + (long long)t * stage_bytes, stage_bytes, full);
  }
}

// -------------------------------------------------------------------- host

// Calls launch_dp(std::integral_constant<int, DP>) with DP the head dim D
// (1 .. 128) rounded up to one of the instantiated widths.
template <typename LaunchDP>
cudaError_t dispatch_dp(int D, LaunchDP&& launch_dp) {
  if (D < 1) return cudaErrorInvalidValue;
  if (D <= 16) return launch_dp(std::integral_constant<int, 16>{});
  if (D <= 32) return launch_dp(std::integral_constant<int, 32>{});
  if (D <= 40) return launch_dp(std::integral_constant<int, 40>{});
  if (D <= 48) return launch_dp(std::integral_constant<int, 48>{});
  if (D <= 64) return launch_dp(std::integral_constant<int, 64>{});
  if (D <= 80) return launch_dp(std::integral_constant<int, 80>{});
  if (D <= 96) return launch_dp(std::integral_constant<int, 96>{});
  if (D <= 128) return launch_dp(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}

}  // namespace tf32
}  // namespace sm90
