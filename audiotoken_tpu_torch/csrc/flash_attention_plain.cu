// K5: non-causal attention with no bias and no mask, q pre-scaled.
//
// Replaces audiotoken_tpu/ops/flash_attention.py:_flash_attention_plain
// (Pallas kernels `_kernel_onepass`, reached through the pallas_call at
// :287 for T <= 1024, and `_kernel_plain`, the tiled form at :309; both
// compute the same function). For one (batch, head), with dh = 64:
//
//   s = q . k (f32), p = exp(s - max_k s) (f32), l = sum_k p (f32),
//   out[q] = (sum_k round(p) v[k]) / max(l, 1e-30)      (q already times dh^-0.5)
//
// where `round` is the rounding to the element type (identity in f32): both
// Pallas bodies cast p to v's type before the value product. The output is
// written in the input's type. Bark-fine calls it at [B, 16, 1024, 64] bf16,
// 24 layers x 6 codebook passes per window; the f32 parity path (the decode
// goldens) at the same shape in f32.
//
// This file holds the bf16 path. The f32 path, the IEEE parity path (the
// decode goldens), is K4's 3xTF32 kernel with no rel term and no mask and q
// pre-scaled: its entry flash_attention_plain_f32 is in
// csrc/flash_attention.cu. The tensor cores cannot compute IEEE f32, and
// f32 FMAs would cap it at 0.513 ms a layer (67 TFLOP/s); in split
// precision the products are bound at 0.208 ms.
//
// bf16, on the tensor cores (flash_attention_plain_bf16_kernel). What bounds
// it on this card: 4 x T^2 x dh FLOPs per (batch, head), 34.4 GFLOP a layer
// at [8, 16, 1024, 64], 0.0347 ms at the 989 TFLOP/s of the bf16 tensor
// cores; its bytes (q, k, v, out: 64 MB, 0.0200 ms at 3.35 TB/s) are below
// that. The design, FlashAttention-2's:
//   * one block per (batch*head, 128 query rows), 8 warps; each warp owns
//     16 query rows, whose Q tile it loads once with ldmatrix into the A
//     fragments of mma.sync.m16n8k16 (bf16 in, f32 accumulators). 128 rows
//     a block read each head's K and V from L2 half as often as 64 rows and
//     4 warps, and measured a little faster on the H100 (PERF.md). At
//     128 registers a thread two blocks share an SM; one register more
//     leaves one, which measured slower, so the launch bounds hold it;
//   * K and V stream through shared memory 64 keys at a time, double
//     buffered with 16-byte cp.async, so the next tile's copy overlaps this
//     tile's math. Rows are padded to 144 bytes: the eight 16-byte rows an
//     ldmatrix phase reads fall on distinct banks (plain ldmatrix for K,
//     .trans for V);
//   * S = Q K^T is 8 n-tiles x 4 k-steps of mma.sync a warp a tile, into 32
//     f32 registers a thread. The online softmax runs in those registers:
//     a row's maximum combines across the 4 threads of a quad with
//     __shfl_xor_sync; keys >= T are -inf before it. p = exp2f(s * log2e -
//     m * log2e), the argument one fmaf: against f32 exp(s - m) that is a
//     relative error of about (|s| + |m|) x 2^-24 plus exp2f's 2 ulp, under
//     1e-5 for scores below 64, against the 2^-9 of p's rounding to bf16.
//     l sums the unrounded f32 p, per thread, combined across the quad once
//     at the end;
//   * p is rounded to bf16 pairs in registers and is the A operand of PV
//     directly: the m16n8 C fragment of S has the layout of the m16n8k16 A
//     fragment, so P never touches shared memory. PV is 8 n-tiles (dh) x 4
//     k-steps (keys);
//   * the epilogue multiplies by 1/l, rounds to bf16 and stores; rows >= T
//     are not written, and keys >= T (zero-filled in shared memory) leave the
//     softmax.
// wgmma with TMA loads and warp specialisation is the next step.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 64;        // head size
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;                       // warps a block, 16 query rows each
constexpr int NT = WARPS * 32;                 // threads a block
constexpr int BQ = 16 * WARPS;                 // query rows a block
constexpr int BK = 64;                         // keys per shared-memory tile
constexpr int LDS = DH + 8;                    // padded row: 144 bytes
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes (nothing read)
// where `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for one m16n8k16 tile: bf16 a (16 x 16) and b (16 x 8), f32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + ROWS) of a [T, 64] bf16 matrix into a padded shared tile,
// rows >= T as zeros
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int T_len) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * (DH / 8); c += NT) {
    const int r = c / (DH / 8), col = (c % (DH / 8)) * 8;
    const bool valid = r0 + r < T_len;
    cp_async16(smem_addr(dst + r * LDS + col), src + (size_t)(valid ? r0 + r : 0) * DH + col,
               valid);
  }
}

constexpr size_t TC_SMEM_BYTES = (size_t)(BQ + 4 * BK) * LDS * sizeof(bf16);  // Q, K and V twice

__global__ void __launch_bounds__(NT, 2)
flash_attention_plain_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, bf16* __restrict__ out,
                                  int T_len) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* sq = reinterpret_cast<bf16*>(tc_smem);  // [BQ][LDS]
  bf16* sk = sq + BQ * LDS;                     // [2][BK][LDS]
  bf16* sv = sk + 2 * BK * LDS;                 // [2][BK][LDS]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3;  // the 8 x 8 matrix of an ldmatrix.x4 whose row this lane addresses
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * T_len * DH;
  const int ntiles = (T_len + BK - 1) / BK;

  load_tile<BQ>(sq, q + base, q0, T_len);
  load_tile<BK>(sk, k + base, 0, T_len);
  load_tile<BK>(sv, v + base, 0, T_len);
  cp_async_commit();

  uint32_t qa[4][4];  // A fragments of the warp's 16 query rows, 4 k-steps of 16 dims
  float o[8][4];      // output: 8 n-tiles of 8 dims; [0..1] row g, [2..3] row g + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g = lane / 4 and g + 8
  float l[2] = {0.f, 0.f};                      // this thread's share of the row sums
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const bf16* kt = sk + (j & 1) * BK * LDS;
    const bf16* vt = sv + (j & 1) * BK * LDS;
    if (j + 1 < ntiles) {  // the next tile's copy overlaps this tile's math
      load_tile<BK>(sk + ((j + 1) & 1) * BK * LDS, k + base, (j + 1) * BK, T_len);
      load_tile<BK>(sv + ((j + 1) & 1) * BK * LDS, v + base, (j + 1) * BK, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qa[kk], smem_addr(sq + (warp * 16 + (mat & 1) * 8 + (lane & 7)) * LDS +
                                      kk * 16 + (mat >> 1) * 8));
    }

    // S = Q K^T over the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // two n-tiles of 8 keys
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(kt + (np * 16 + (mat >> 1) * 8 + (lane & 7)) * LDS + kk * 16 +
                                 (mat & 1) * 8));
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }
    if ((j + 1) * BK > T_len) {  // the ragged last tile: keys >= T leave the softmax
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * BK + n * 8 + (lane & 3) * 2 + (e & 1) >= T_len) s[n][e] = -CUDART_INF_F;
    }

    // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      // finite: every tile holds a key < T
      const float alpha = exp2f((m[i] - mx[i]) * LOG2E);
      m[i] = mx[i];
      mb[i] = mx[i] * LOG2E;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
    uint32_t pa[4][4];  // P as the A fragments of PV: 4 k-steps of 16 keys
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(fmaf(s[n][0], LOG2E, -mb[0]));
      const float p1 = exp2f(fmaf(s[n][1], LOG2E, -mb[0]));
      const float p2 = exp2f(fmaf(s[n][2], LOG2E, -mb[1]));
      const float p3 = exp2f(fmaf(s[n][3], LOG2E, -mb[1]));
      l[0] += p0 + p1;  // the unrounded p
      l[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {  // two n-tiles of 8 dims
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vt + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * LDS +
                                       dp * 16 + (mat >> 1) * 8));
        mma_bf16(o[2 * dp], pa[kk], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const int r = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (r + 8 * i < T_len) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + base + (size_t)(r + 8 * i) * DH +
                                                  (lane & 3) * 2);
#pragma unroll
      for (int n = 0; n < 8; ++n) dst[n * 4] = pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int T_len,
                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_plain_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TC_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + BQ - 1) / BQ, BH);
  flash_attention_plain_bf16_kernel<<<grid, NT, TC_SMEM_BYTES,
                                      static_cast<cudaStream_t>(stream)>>>(q, k, v, out, T_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (pre-scaled), k, v, out [BH, T, 64] bf16, contiguous.
extern "C" int flash_attention_plain_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                          int BH, int T, void* stream) {
  return launch_bf16(q, k, v, out, BH, T, stream);
}
