// y = x W^T + b in f32 accuracy on the tensor cores: a persistent 3xTF32
// GEMM for Hopper (wgmma), the bias added in its epilogue.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA
// (jnp.dot at Precision.HIGHEST in audiotoken_tpu/nn/conformer.py), and the
// port ran them as cuBLAS's IEEE SGEMM, which is held to the 67 TFLOP/s of
// f32 FMAs. Split precision gets f32 accuracy from the TF32 tensor cores:
// each operand is split into two TF32 parts, hi = tf32(v) and lo = tf32(v -
// hi) (to nearest, ties away from zero: (bits + 0x1000) & 0xffffe000, as
// ops/flash_attention.py:tf32_round and cvt.rna give), and
//
//   x w ~ x_lo w_hi + x_hi w_lo + x_hi w_hi,
//
// three TF32 products with exact multiplies (the parts have 11 significant
// bits) and f32 sums; x_lo w_lo, about 2^-22 of x w, is left out.
//
// What bounds it on this card: operations, 2 M N K a product in three TF32
// passes at 495 TFLOP/s (165 TFLOP/s of f32 work; the semantic_m encoder's
// 191 linears a call, 11.0 TFLOP, in 66.7 ms); x, the split weights and y
// move in a few percent of that. On the H100 it runs at 65-71 % of that
// bound at the encoder's four large shapes (chip_smoke 4h). The design:
//   1. The weights are split and laid out once a call by a small kernel
//      (split_weight_kernel): hi and lo tiles of 128 rows x 32 columns,
//      each K-major in the 128-byte swizzle that wgmma's descriptor reads,
//      the two side by side, so one bulk copy (cp.async.bulk on an
//      mbarrier, TMA without a tensor map) brings a stage's B operand.
//      Splitting every call reads the weight and writes 2x its bytes (5.5
//      GB, about 2 ms of a semantic_m call); no cache of split weights can
//      go stale.
//   2. x is split in registers: it is the A operand of wgmma, which may
//      come from registers (m64n128k8 TF32, A in registers, B from shared
//      memory). Splitting it in device memory would move about 39 GB a
//      call. The producer warpgroup copies x's tiles raw (cp.async, 16
//      bytes a thread, rows past M zero-filled, completing on the stage's
//      mbarrier); a consumer thread reads its fragments as float4s and
//      splits them. The columns of each 32-wide K tile are permuted (in
//      the weights' layout, see split_weight_kernel) so that a thread's
//      fragments of two k-steps are 4 neighbouring floats of one row: k-step
//      ks slot j takes column 8 (j % 4) + 4 (ks / 2) + 2 (ks % 2) + j / 4.
//      With x's rows in the same 128-byte XOR swizzle, the 8 threads of
//      each shared-memory phase read 8 distinct chunks: no bank conflicts.
//   3. One block an SM walks the output tiles of 128 x 128 (M x N) in
//      groups of 8 row tiles, so the blocks running together share their
//      x rows and weight columns in the L2. Warps 0-7 are two consumer
//      warpgroups of 64 rows each, warps 8-11 the producer; setmaxnreg
//      moves registers from the producer (40) to the consumers (232). A
//      ring of 4 stages of 48 KB (x 16 KB, w hi and lo 16 KB each) keeps
//      three K tiles in flight while one is consumed; the producer runs
//      ahead into the next tile during a consumer's epilogue.
//   4. The tensor cores' sums truncate (round toward zero), so a sum kept
//      in the wgmma accumulator over all of K drifts one way: at K = 4096
//      that read 12 times cuBLAS's error at M = 11,992 and 117 times at
//      M = 1 (PERF.md §6). So each 32-wide K tile's twelve products go
//      into an accumulator of their own, the eight small ones (x_lo w_hi,
//      x_hi w_lo) first while it is small, then the four x_hi w_hi; it is
//      added to the running sum in IEEE f32 once they are done (64 + 64
//      accumulator registers a thread). The other warpgroup's products
//      keep the tensor cores busy meanwhile.
// With 128 x 128 tiles a K tile moves 16 KB of x and 32 KB of split
// weights from the L2 for 3.1 MFLOP of tensor work (64 FLOP a byte); wgmma
// reads 64 bytes a clock of B from shared memory, half of its rate.
// Rows of y past M are not written. Inputs must be finite: an x or w near
// FLT_MAX rounds its hi part to infinity.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_async.cuh"

namespace {

constexpr int BM = 128;  // rows of x a tile: two consumer warpgroups of 64
constexpr int BN = 128;  // columns of y a tile: rows of w
constexpr int BK = 32;   // columns of a K tile: 128 bytes, one swizzle atom wide
constexpr int STAGES = 4;
constexpr int GROUP_M = 8;  // row tiles a group; a group's tiles run column by column
constexpr int NT = 384;     // warps 0-7 the consumers, 8-11 the producer
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65536
constexpr uint32_t A_BYTES = BM * BK * 4;               // x's tile, 16 KB
constexpr uint32_t B_BYTES = BN * BK * 4;               // w's hi or lo tile, 16 KB
constexpr uint32_t STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr uint32_t BAR_OFF = STAGES * STAGE_BYTES;
enum { FULL = 0, EMPTY = STAGES, NBARS = 2 * STAGES };
constexpr size_t SMEM_BYTES = 1024 + BAR_OFF + NBARS * 8;  // 1024: the base's alignment

// 16 bytes from global to shared memory, the first `src_bytes` (16 or 0) of
// them read and the rest zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// one arrival on `bar` once this thread's cp.asyncs so far have landed (the
// arrival is counted in the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// wgmma's descriptor of a K-major tile at shared address a (1024-aligned) in
// the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused (1).
// k-step ks of the tile starts 32 ks bytes in: add 2 ks
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define D4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define D16(c, i) D4(c, i), D4(c, i + 4), D4(c, i + 8), D4(c, i + 12)
#define D64(c) D16(c, 0), D16(c, 16), D16(c, 32), D16(c, 48)
#define R64                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (=, or += with acc) a b for a 64 x 128 x 8 TF32 product: a (64 x 8) in
// registers, a[0] (row g, slot t), a[1] (g + 8, t), a[2] (g, t + 4), a[3]
// (g + 8, t + 4), as mma.sync's A fragment, the warps of the warpgroup on
// rows 16w..16w+15; b (128 x 8, K-major) in shared memory. d: columns 8n +
// 2t, + 1 of rows g (d[4n], d[4n + 1]) and g + 8 (d[4n + 2], d[4n + 3])
__device__ __forceinline__ void mma128(float (&d)[64], const uint32_t* a, uint64_t b,
                                       int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// The weights w [N, K] split into the B operand's tiles: for row tile nt
// (128 rows) and K tile kt, the hi tile then the lo tile, 16 KB each, at
// ((nt * K / 32 + kt) * 2) * 16 KB. A tile is K-major in the 128-byte
// swizzle: row r's 128 bytes at (r / 8) 1024 + (r % 8) 128, its 16-byte
// chunk c at position c ^ (r % 8). Physical column 8 ks + j holds the K
// tile's column 8 (j % 4) + 4 (ks / 2) + 2 (ks % 2) + j / 4 (design point
// 2), so chunk c holds columns c, c + 8, c + 16 and c + 24. One thread a
// chunk, the 8 chunks of a row on neighbouring threads: a warp reads one
// 32-byte sector of each of its 4 rows a load and writes 4 whole rows.
__global__ void __launch_bounds__(256) split_weight_kernel(const float* __restrict__ w,
                                                           float* __restrict__ wp, int N,
                                                           int K) {
  const int KT = K / BK;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)N * KT * 8) return;
  const int c = (int)(i & 7), n = (int)((i >> 3) % N), kt = (int)((i >> 3) / N), r = n % BN;
  const float* src = w + (size_t)n * K + (size_t)kt * BK + c;
  float4 hi, lo;
  hi.x = tf32(__ldg(src));
  hi.y = tf32(__ldg(src + 8));
  hi.z = tf32(__ldg(src + 16));
  hi.w = tf32(__ldg(src + 24));
  lo.x = tf32(__ldg(src) - hi.x);
  lo.y = tf32(__ldg(src + 8) - hi.y);
  lo.z = tf32(__ldg(src + 16) - hi.z);
  lo.w = tf32(__ldg(src + 24) - hi.w);
  unsigned char* tile = reinterpret_cast<unsigned char*>(
      wp + ((size_t)(n / BN) * KT + kt) * 2 * (BN * BK));
  const uint32_t off = (r >> 3) * 1024 + (r & 7) * 128 + (((c ^ r) & 7) << 4);
  *reinterpret_cast<float4*>(tile + off) = hi;
  *reinterpret_cast<float4*>(tile + B_BYTES + off) = lo;
}

// the row tile and column tile of output tile `tile`: groups of GROUP_M row
// tiles (fewer in the last), each walked row tile first, then column
__device__ __forceinline__ void tile_coords(int tile, int MT, int NTN, int& mt, int& nt) {
  const int group = tile / (GROUP_M * NTN), first = group * GROUP_M;
  const int rows = min(GROUP_M, MT - first), r = tile - group * GROUP_M * NTN;
  mt = first + r % rows;
  nt = r / rows;
}

__global__ void __launch_bounds__(NT, 1)
linear_3xtf32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                     const float* __restrict__ bias, float* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  const unsigned char* sm = smem_raw + (base - raw_base);
  auto bar = [&](int i) { return base + BAR_OFF + 8 * i; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int MT = (M + BM - 1) / BM, NTN = N / BN, KT = K / BK, tiles = MT * NTN;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(FULL + s), 128 + 1);  // the producer's cp.async arrivals, the bulk copy's
      mbar_init(bar(EMPTY + s), 8);       // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- the producer: x's rows raw by cp.async, the split weights by one
    // bulk copy, into the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = tid & 127, c = pt & 7, r0 = pt >> 3;  // chunk c of rows r0 + 16i
    const uint32_t dst0 = r0 * 128 + ((c ^ (r0 & 7)) << 4);
    int s = 0, phase = 0, it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int mt, nt;
      tile_coords(tile, MT, NTN, mt, nt);
      const int rows = min(BM, M - mt * BM);
      const float* xa = x + ((size_t)mt * BM + r0) * K + 4 * c;
      const float* wt = wp + (size_t)nt * KT * 2 * (BN * BK);
      for (int kt = 0; kt < KT; ++kt, ++it) {
        if (it >= STAGES) mbar_wait(bar(EMPTY + s), phase ^ 1);
        const uint32_t st = base + s * STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < BM / 16; ++i) {
          const bool in = r0 + 16 * i < rows;
          cp_async16(st + dst0 + 16 * i * 128, in ? xa + (size_t)16 * i * K + kt * BK : x,
                     in ? 16 : 0);
        }
        cp_async_arrive(bar(FULL + s));
        if (pt == 0) {
          mbar_expect(bar(FULL + s), 2 * B_BYTES);
          bulk_copy(st + A_BYTES, wt + (size_t)kt * 2 * (BN * BK), 2 * B_BYTES, bar(FULL + s));
        }
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- the consumers: 64 rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
    // this thread's rows g and g + 8, at their 16-byte chunks 2t (k-steps 0,
    // 1) and 2t + 1 (k-steps 2, 3) in the swizzle
    const uint32_t arow = (wg * 64 + 16 * w4 + g) * 128;
    const uint32_t chunk0 = ((2 * t) ^ g) << 4, chunk1 = ((2 * t + 1) ^ g) << 4;
    float acc[64], part[64];  // the sum so far; one K tile's products, by wgmma (point 4)
    uint32_t ahi[16], alo[16];  // the K tile's A fragments: k-step ks in [4ks, 4ks + 4)
    int s = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int mt, nt;
      tile_coords(tile, MT, NTN, mt, nt);
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(bar(FULL + s), phase);
        const unsigned char* a = sm + s * STAGE_BYTES + arow;
        const float4 u0 = *reinterpret_cast<const float4*>(a + chunk0);
        const float4 v0 = *reinterpret_cast<const float4*>(a + 8 * 128 + chunk0);
        const float4 u1 = *reinterpret_cast<const float4*>(a + chunk1);
        const float4 v1 = *reinterpret_cast<const float4*>(a + 8 * 128 + chunk1);
        // k-step 2kp + h: (row g, slot t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        // = columns 8t + 4kp + 2h and + 1 of rows g and g + 8
        const float f[16] = {u0.x, v0.x, u0.y, v0.y, u0.z, v0.z, u0.w, v0.w,
                             u1.x, v1.x, u1.y, v1.y, u1.z, v1.z, u1.w, v1.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          ahi[e] = tf32_bits(f[e]);
          alo[e] = tf32_bits(f[e] - __uint_as_float(ahi[e]));
        }
        const uint64_t dhi = desc(base + s * STAGE_BYTES + A_BYTES);
        const uint64_t dlo = desc(base + s * STAGE_BYTES + A_BYTES + B_BYTES);
        keep(part);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {  // the small products first
          mma128(part, &alo[4 * ks], dhi + 2 * ks, ks != 0);
          mma128(part, &ahi[4 * ks], dlo + 2 * ks);
        }
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) mma128(part, &ahi[4 * ks], dhi + 2 * ks);
        wg_commit();
        keep(part);
        keep(ahi);
        keep(alo);
        wg_wait<0>();
        keep(part);
        if (lane == 0) mbar_arrive(bar(EMPTY + s));
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = kt ? acc[i] + part[i] : part[i];
      }

      // the epilogue: + bias, rows past M not written
      const int row0 = mt * BM + wg * 64 + 16 * w4 + g, col0 = nt * BN + 2 * t;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float2 b = bias ? __ldg(reinterpret_cast<const float2*>(bias + col0 + 8 * n))
                              : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row0 + 8 * h < M)
            *reinterpret_cast<float2*>(y + (size_t)(row0 + 8 * h) * N + col0 + 8 * n) =
                make_float2(acc[4 * n + 2 * h] + b.x, acc[4 * n + 2 * h + 1] + b.y);
      }
    }
  }
}

}  // namespace

// y [M, N] = x [M, K] w^T + b, f32, at 3xTF32. x, w [N, K] and y contiguous
// and 16-byte aligned; b [N] or null; wp a scratch of 2 N K floats for the
// split weights; K a multiple of 32 and N of 128, M >= 1.
extern "C" int linear_3xtf32_f32(const float* x, const float* w, const float* b, float* wp,
                                 float* y, int M, int N, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long chunks = (long)N * (K / BK) * 8;
  split_weight_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(w, wp, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaFuncSetAttribute(linear_3xtf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (M + BM - 1) / BM * (N / BN);
  linear_3xtf32_kernel<<<tiles < sms ? tiles : sms, NT, SMEM_BYTES, st>>>(x, wp, b, y, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
