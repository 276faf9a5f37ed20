// K3: residual vector quantization, encode side, all codebooks in one pass.
//
// Replaces audiotoken_tpu/ops/rvq_pallas.py:rvq_encode_pallas (Pallas
// kernel `_rvq_kernel`). For each of num_q codebooks E_k [C, D], in order:
//
//   code_k[n]  = first argmax_c  -(|r_n|^2 - 2 r_n . e_c + |e_c|^2)
//   r_n       -= e_{code_k[n]}
//
// with r starting at the encoder's latents. The distance expression is the
// one nn/rvq.py and the TPU kernel use, with |e|^2 precomputed by the
// caller, and ties go to the first index.
//
// What bounds it on this card: 2 x N x C x D FLOPs per codebook, about 75
// GFLOP for 8 x 30 s at 16 codebooks, which must come out f32-accurate
// (token parity; the TPU kernel's dots run at Precision.HIGHEST). IEEE f32
// FMAs cap that at 67 TFLOP/s. The products r . e are a [N x 128] x [128 x C]
// matrix product per codebook, so they run on the tensor cores in 3xTF32,
// as K4's do (csrc/flash_attention.cu): each f32 operand x becomes hi =
// tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), and a product
// is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b with f32 accumulation, three
// passes at the 495 TFLOP/s TF32 rate (mma.sync reaches about half of it:
// scripts/profile_mma_rate_torch.py). The design:
//   * a warp owns 16 residual rows, the B operand of mma.sync.m16n8k8 (TF32
//     in, f32 accumulators; two n-tiles of 8 rows). The rows stay in f32 in
//     registers, in the fragment layout (16 k-steps x 2 n-tiles x 2, 64
//     registers), and are split into hi and lo as each k-step reads them.
//     That keeps a thread at 161 registers, so three blocks of 4 warps fit an
//     SM (12 warps): holding the split rows (128 registers), or the f32 rows
//     in shared or global memory, kept it at 8 warps and measured slower;
//   * the codewords are the A operand, 16 a tile. A block of 4 warps
//     streams each codebook through shared memory 64 codewords at a time,
//     double-buffered with 16-byte cp.async (the next chunk, of this codebook
//     or the next, in flight during the math), one barrier a chunk. Each warp
//     splits its A fragments in registers as it reads them, with integer
//     operations that give cvt.rna's result (splitting each chunk once in
//     shared memory for all warps measured slower: it adds a pass and a
//     barrier in which the tensor cores idle).
//     The k index of a fragment is only a summation index, so a lane's two k
//     slots (t, t + 4) are mapped to adjacent dims: one float2 read gives
//     both, and rows padded to 136 floats make the reads conflict-free;
//   * a chunk is 4 codeword tiles x 2 row tiles, 8 independent accumulators;
//     the three terms of a k-step are each issued across all 8 before the
//     next term (the small terms first), so consecutive mma.sync do not wait
//     on one another's accumulator (a first design with 4 a warp was slower);
//   * the argmax runs in the epilogue of each chunk: nd = -(x2 - 2 xe + e2)
//     in f32 from the C fragments and the chunk's |e|^2 (copied into shared
//     memory with the chunk), a running best value and index per row in
//     registers, then merged across the lanes that share a row: the larger
//     value wins, the smaller index on a tie, so the first index wins in any
//     order of the chunks. The blocks walk the chunks from different starting
//     points, so that they do not all read the same lines of L2 at once;
//   * the residual update is exact f32, in the fragment layout: each lane
//     gathers its dims of the chosen codeword from global memory (the
//     codebooks stay in L2) and subtracts them, as the plain version does;
//     |r|^2 is summed from the same registers across the quad;
//   * filling the card: the wrapper (ops/rvq.py:rvq_plan) splits the
//     codewords over a cluster of `split` blocks where that spreads the work
//     more evenly over the SMs; each block of a cluster keeps its own copy of
//     the residual, and the blocks merge their per-row best through
//     distributed shared memory each codebook, in rank order.
//
// Mimi's split RVQ runs the same kernel at D = 256 (rvq_encode_d256_f32,
// C = 2048: once with its semantic codebook, once with its 31 acoustic
// ones); the Shape below says what changes there.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;

// The kernel's shape for one codeword dimension D. At D = 128 (EnCodec) a
// block is 4 warps, 64 codewords a chunk, the rows in registers, three
// blocks an SM at <= 168 registers. At D = 256 (Mimi) the rows would take
// 128 registers a thread, so they live in shared memory instead (SROWS,
// rows of D + 8 floats: the fragment reads are conflict-free as the
// chunk's are), read as each k-step needs them; a lane reads and writes
// only its own elements there, so they need no barrier. The rows (132 KB
// for 8 warps) and 32-codeword chunks fill one block an SM, of 8 warps, so
// that a chunk serves 128 rows.
template <int D_, int WARPS_, int CH_, int MINB_, bool SROWS_>
struct Shape {
  static constexpr int D = D_;          // codeword dimension
  static constexpr int KSTEPS = D / 8;  // k-steps of m16n8k8
  static constexpr int CH = CH_;        // codewords a chunk
  static constexpr int MT = CH / 16;    // m-tiles (16 codewords) a chunk
  static constexpr int LDE = D + 8;     // row of a chunk, floats: conflict-free float2 reads
  static constexpr int WARPS = WARPS_;  // a block
  static constexpr int MINB = MINB_;    // blocks an SM
  static constexpr int ROWS = WARPS * 16;  // residual rows a block
  static constexpr bool SROWS = SROWS_;    // the rows in shared memory
  static constexpr int LDR = D + 8;        // a row there, floats
  // chunks [2][CH][LDE] and their |e|^2 [2][CH]; best value and index
  // [2][ROWS] each (a cluster's merge, double-buffered); the rows [ROWS][LDR]
  static constexpr size_t SMEM_BYTES = (size_t)2 * CH * (LDE + 1) * sizeof(float) +
                                       (size_t)2 * 2 * ROWS * 4 +
                                       (SROWS ? (size_t)ROWS * LDR * sizeof(float) : 0);
};
using D128 = Shape<128, 4, 64, 3, false>;
using D256 = Shape<256, 8, 32, 1, true>;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes (nothing read)
// where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// what cvt.rna.tf32.f32 gives for a finite x, in two integer operations
// (the integer units issue more of them a clock than the conversion unit)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile: TF32 a (16 x 8) and b (8 x 8), f32 d
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v, i) becomes the better of (v, i) and (ov, oi): the larger value, the
// smaller index on a tie
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// grid: (row tiles of ROWS rows) x nsplit, clusters of nsplit blocks along
// x; cpb codewords a block (rank r takes [r cpb, (r + 1) cpb) of C)
template <class S>
__global__ void __launch_bounds__(S::WARPS * 32, S::MINB)
rvq_encode_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ e2, int* __restrict__ codes, int N, int num_q,
                  int C, int nsplit, int cpb) {
  constexpr int D = S::D, KSTEPS = S::KSTEPS, CH = S::CH, MT = S::MT, LDE = S::LDE;
  constexpr int WARPS = S::WARPS, LDR = S::LDR;
  extern __shared__ __align__(16) float smem[];
  constexpr int rows = S::ROWS;
  float* eb = smem;                                 // [2][CH][LDE] codeword chunks
  float* e2s = eb + 2 * CH * LDE;                   // [2][CH] the chunks' |e|^2
  float* bv = e2s + 2 * CH;                         // [2][rows] best value
  int* bi = reinterpret_cast<int*>(bv + 2 * rows);  // [2][rows] best index

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % nsplit;
  const int n0 = (blockIdx.x / nsplit) * rows + warp * 16;  // the warp's first row
  const int c_lo = rank * cpb, c_hi = min(C, c_lo + cpb);
  const int nch = (cpb + CH - 1) / CH;  // the same for every rank
  const int total = num_q * nch;
  const int nrows = max(0, min(16, N - n0));

  // the blocks walk a codebook's chunks from different starting points, so
  // that they do not all read the same lines of L2 at once
  const int rot = (blockIdx.x / nsplit) % nch;
  // the chunk of flat index gc (codebook gc / nch) into buffer gc & 1
  auto issue = [&](int gc) {
    const int k = gc / nch, c0 = c_lo + (gc % nch + rot) % nch * CH;
    const float* src = cb + (size_t)k * C * D;
    float* dst = eb + (gc & 1) * CH * LDE;
    for (int e = tid; e < CH * (D / 4); e += WARPS * 32) {
      const int j = e / (D / 4), d4 = (e % (D / 4)) * 4;
      const bool valid = c0 + j < c_hi;
      cp_async16(dst + j * LDE + d4, src + (size_t)(valid ? c0 + j : 0) * D + d4, valid);
    }
    if (tid < CH / 4) {  // C % 16 == 0: every rank's range starts 16-byte aligned
      const bool valid = c0 + 4 * tid < c_hi;
      cp_async16(e2s + (gc & 1) * CH + 4 * tid, e2 + (size_t)k * C + (valid ? c0 + 4 * tid : 0),
                 valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  issue(0);
  // the residual rows in f32: rows g + 8n, dims ks * 8 + 2t, + 1; in
  // registers, or (SROWS) at rs[(g + 8n) * LDR + ks * 8 + 2t]
  float rf[S::SROWS ? 1 : KSTEPS][2][2];
  float* rs = reinterpret_cast<float*>(bi + 2 * rows) + warp * 16 * LDR;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int r = g + 8 * n;
      const float2 p = r < nrows
          ? __ldg(reinterpret_cast<const float2*>(x + (size_t)(n0 + r) * D + ks * 8 + 2 * t))
          : make_float2(0.f, 0.f);
      if constexpr (S::SROWS) {
        *reinterpret_cast<float2*>(rs + r * LDR + ks * 8 + 2 * t) = p;
      } else {
        rf[ks][n][0] = p.x;
        rf[ks][n][1] = p.y;
      }
    }
  float x2[4];  // |r|^2 of the lane's C rows 2t, 2t + 1, 8 + 2t, 9 + 2t
  float best[4];
  int bidx[4];
  cg::cluster_group cluster = cg::this_cluster();

  for (int gc = 0; gc < total; ++gc) {
    const int k = gc / nch, c = gc % nch;  // the codebook's c-th chunk in this block's order
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the chunk has landed; every warp is done with the other buffer
    if (gc + 1 < total) issue(gc + 1);  // in flight during this chunk's math
    const float* es = eb + (gc & 1) * CH * LDE;

    if (c == 0) {  // a new codebook: |r|^2, reset the best
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        if constexpr (S::SROWS) {
          const float2 a = *reinterpret_cast<const float2*>(rs + g * LDR + ks * 8 + 2 * t);
          const float2 b = *reinterpret_cast<const float2*>(rs + (g + 8) * LDR + ks * 8 + 2 * t);
          s0 = fmaf(a.x, a.x, s0);
          s0 = fmaf(a.y, a.y, s0);
          s1 = fmaf(b.x, b.x, s1);
          s1 = fmaf(b.y, b.y, s1);
        } else {
          s0 = fmaf(rf[ks][0][0], rf[ks][0][0], s0);
          s0 = fmaf(rf[ks][0][1], rf[ks][0][1], s0);
          s1 = fmaf(rf[ks][1][0], rf[ks][1][0], s1);
          s1 = fmaf(rf[ks][1][1], rf[ks][1][1], s1);
        }
      }
      s0 += __shfl_xor_sync(FULL, s0, 1);
      s0 += __shfl_xor_sync(FULL, s0, 2);
      s1 += __shfl_xor_sync(FULL, s1, 1);
      s1 += __shfl_xor_sync(FULL, s1, 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x2[i] = __shfl_sync(FULL, (i >> 1) ? s1 : s0, (2 * t + (i & 1)) * 4);
        best[i] = -CUDART_INF_F;
        bidx[i] = 0;
      }
    }

    // xe: m-tile m holds codewords m * 16 + g (C rows), + 8; n-tile n the
    // rows n * 8 + 2t, + 1 (C columns)
    float acc[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      // the small terms first, each across the 8 tiles: lo_e hi_r, hi_e lo_r,
      // then hi_e hi_r
      const int o = g * LDE + ks * 8 + 2 * t;
      uint32_t rh[2][2], rl[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if constexpr (S::SROWS) {
          const float2 p = *reinterpret_cast<const float2*>(rs + (g + 8 * n) * LDR + ks * 8 + 2 * t);
          split(p.x, rh[n][0], rl[n][0]);
          split(p.y, rh[n][1], rl[n][1]);
        } else {
          split(rf[ks][n][0], rh[n][0], rl[n][0]);
          split(rf[ks][n][1], rh[n][1], rl[n][1]);
        }
      }
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float2 p = *reinterpret_cast<const float2*>(es + m * 16 * LDE + o);
        const float2 q = *reinterpret_cast<const float2*>(es + (m * 16 + 8) * LDE + o);
        split(p.x, ah[m][0], al[m][0]);
        split(q.x, ah[m][1], al[m][1]);
        split(p.y, ah[m][2], al[m][2]);
        split(q.y, ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_tf32(acc[m][n], al[m], rh[n][0], rh[n][1]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_tf32(acc[m][n], ah[m], rl[n][0], rl[n][1]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_tf32(acc[m][n], ah[m], rh[n][0], rh[n][1]);
    }
    // nd = -(x2 - 2 xe + e2); codewords in increasing order per row
    const int cw0 = c_lo + (c + rot) % nch * CH;
    const float* e2c = e2s + (gc & 1) * CH;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cw = cw0 + m * 16 + g + 8 * h;
        if (cw < c_hi) {
          const float ev = e2c[m * 16 + g + 8 * h];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int i = 2 * n + j;
              const float nd = -(__fsub_rn(x2[i], 2.f * acc[m][n][2 * h + j]) + ev);
              better(best[i], bidx[i], nd, cw);
            }
        }
      }

    if (c == nch - 1) {  // the codebook's codes, then the residual update
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int off = 4; off <= 16; off <<= 1)  // the 8 lanes of a row, g = 0..7
          better(best[i], bidx[i], __shfl_xor_sync(FULL, best[i], off),
                 __shfl_xor_sync(FULL, bidx[i], off));
      if (nsplit > 1) {  // the ranks' best, in rank order, through DSMEM
        const int buf = (k & 1) * rows + warp * 16;
        if (g == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = (i >> 1) * 8 + 2 * t + (i & 1);
            bv[buf + r] = best[i];
            bi[buf + r] = bidx[i];
          }
        }
        cluster.sync();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (i >> 1) * 8 + 2 * t + (i & 1);
          float v = cluster.map_shared_rank(bv, 0)[buf + r];
          int ix = cluster.map_shared_rank(bi, 0)[buf + r];
          for (int q = 1; q < nsplit; ++q)
            better(v, ix, cluster.map_shared_rank(bv, q)[buf + r],
                   cluster.map_shared_rank(bi, q)[buf + r]);
          bidx[i] = ix;
        }
      }
      if (rank == 0 && g == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (i >> 1) * 8 + 2 * t + (i & 1);
          if (r < nrows) codes[(size_t)k * N + n0 + r] = bidx[i];
        }
      }
      // r -= e[code] in f32, in the fragment layout of rf
      const float* cbk = cb + (size_t)k * C * D;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int v0 = __shfl_sync(FULL, bidx[2 * n], g >> 1);
        const int v1 = __shfl_sync(FULL, bidx[2 * n + 1], g >> 1);
        const float* er = cbk + (size_t)((g & 1) ? v1 : v0) * D + 2 * t;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const float2 ev = __ldg(reinterpret_cast<const float2*>(er + ks * 8));
          if constexpr (S::SROWS) {
            float2* p = reinterpret_cast<float2*>(rs + (g + 8 * n) * LDR + ks * 8 + 2 * t);
            *p = make_float2(p->x - ev.x, p->y - ev.y);
          } else {
            rf[ks][n][0] -= ev.x;
            rf[ks][n][1] -= ev.y;
          }
        }
      }
    }
  }
  if (nsplit > 1) cluster.sync();  // the others may still read this block's best
}

template <class S>
int launch(const float* x, const float* cb, const float* e2, int* codes, int N, int num_q, int C,
           int split, void* stream) {
  if ((split != 1 && split != 2 && split != 4) || C % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rvq_encode_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + S::ROWS - 1) / S::ROWS;
  const int cpb = (C + split - 1) / split;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split);
  cfg.blockDim = dim3(S::WARPS * 32);
  cfg.dynamicSmemBytes = S::SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, rvq_encode_kernel<S>, x, cb, e2, codes, N, num_q, C, split, cpb);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x [N, 128] f32 latents, cb [>= num_q, C, 128] f32 codebooks, e2 [num_q, C]
// f32 squared codeword norms -> codes [num_q, N] int32. A block takes 64
// rows; `split` (1, 2 or 4) blocks, a cluster, share a row tile and split
// the C codewords (C % 16 == 0) between them.
extern "C" int rvq_encode_f32(const float* x, const float* cb, const float* e2, int* codes,
                              int N, int num_q, int C, int split, void* stream) {
  return launch<D128>(x, cb, e2, codes, N, num_q, C, split, stream);
}

// As rvq_encode_f32 at D = 256 (x [N, 256], cb [>= num_q, C, 256]): a block
// takes 128 rows.
extern "C" int rvq_encode_d256_f32(const float* x, const float* cb, const float* e2, int* codes,
                                   int N, int num_q, int C, int split, void* stream) {
  return launch<D256>(x, cb, e2, codes, N, num_q, C, split, stream);
}
