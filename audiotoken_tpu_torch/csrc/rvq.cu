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
// What bounds it on this card: 2 x N x C x D FLOPs per codebook at IEEE f32
// (no TF32: token parity), about 75 GFLOP for 8 x 30 s at 16 codebooks, so
// it is bound by the f32 FMA rate. The codebooks (8 MB) stay in L2. The
// design:
//   * one block per tile of 64 rows; the residual tile stays in shared
//     memory across all codebooks, transposed so that a thread reads its
//     4 rows as one float4;
//   * codewords are streamed through shared memory 64 at a time; each
//     thread computes a 4 x 4 register tile of dot products (16 FMAs per
//     two float4 reads) and keeps, per row, the first best index it saw;
//   * the 16 threads that share rows merge their candidates with warp
//     shuffles (larger value wins, the smaller index on a tie);
//   * the chosen codeword is subtracted by a gather, not a one-hot product.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int D = 128;        // codeword dimension
constexpr int TN = 64;        // rows per block
constexpr int CC = 64;        // codewords per shared-memory chunk
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 rows, tx owns 4 codewords
constexpr int LD = TN + 4;    // padded leading dimension, a multiple of 4
constexpr unsigned FULL = 0xffffffffu;

constexpr size_t kSmemBytes = (2 * D * LD + TN + CC + TN) * sizeof(float);

__global__ void __launch_bounds__(THREADS)
rvq_encode_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ e2, int* __restrict__ codes,
                  int N, int num_q, int C) {
  extern __shared__ __align__(16) float smem[];
  float* rT = smem;                 // [D][LD] residual tile, transposed
  float* eT = rT + D * LD;          // [D][LD] codeword chunk, transposed
  float* x2s = eT + D * LD;         // [TN]
  float* e2s = x2s + TN;            // [CC]
  int* idx_s = reinterpret_cast<int*>(e2s + CC);  // [TN]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n0 = blockIdx.x * TN;
  const int rows = min(TN, N - n0);

  for (int e = tid; e < TN * D; e += THREADS) {
    const int row = e / D, d = e % D;
    rT[d * LD + row] = row < rows ? x[(size_t)(n0 + row) * D + d] : 0.f;
  }
  __syncthreads();

  for (int k = 0; k < num_q; ++k) {
    const float* cbk = cb + (size_t)k * C * D;
    if (tid < TN) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) {
        const float r = rT[d * LD + tid];
        s = fmaf(r, r, s);
      }
      x2s[tid] = s;
    }

    float best[4];
    int bidx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = -CUDART_INF_F;
      bidx[i] = 0;
    }

    for (int c0 = 0; c0 < C; c0 += CC) {
      __syncthreads();  // the previous chunk is consumed; x2s is ready
      for (int e = tid; e < CC * (D / 4); e += THREADS) {
        const int cw = e % CC, d4 = e / CC;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + cw < C)
          v = __ldg(reinterpret_cast<const float4*>(cbk + (size_t)(c0 + cw) * D) + d4);
        eT[(d4 * 4 + 0) * LD + cw] = v.x;
        eT[(d4 * 4 + 1) * LD + cw] = v.y;
        eT[(d4 * 4 + 2) * LD + cw] = v.z;
        eT[(d4 * 4 + 3) * LD + cw] = v.w;
      }
      if (tid < CC) e2s[tid] = c0 + tid < C ? e2[(size_t)k * C + c0 + tid] : 0.f;
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 r = *reinterpret_cast<const float4*>(rT + d * LD + ty * 4);
        const float4 e = *reinterpret_cast<const float4*>(eT + d * LD + tx * 4);
        const float rv[4] = {r.x, r.y, r.z, r.w};
        const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(rv[i], ev[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x2 = x2s[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cw = c0 + tx * 4 + j;
          const float nd = -(x2 - 2.f * acc[i][j] + e2s[tx * 4 + j]);
          if (cw < C && nd > best[i]) {
            best[i] = nd;
            bidx[i] = cw;
          }
        }
      }
    }

    // The 16 lanes with the same ty form one half warp.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = best[i];
      int ix = bidx[i];
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, v, off);
        const int oi = __shfl_xor_sync(FULL, ix, off);
        if (ov > v || (ov == v && oi < ix)) {
          v = ov;
          ix = oi;
        }
      }
      if (tx == 0) idx_s[ty * 4 + i] = ix;
    }
    __syncthreads();

    if (tid < rows) codes[(size_t)k * N + n0 + tid] = idx_s[tid];
    for (int e = tid; e < TN * D; e += THREADS) {
      const int row = e / D, d = e % D;
      rT[d * LD + row] -= __ldg(cbk + (size_t)idx_s[row] * D + d);
    }
    __syncthreads();
  }
}

}  // namespace

// x [N, 128] f32 latents, cb [>= num_q, C, 128] f32 codebooks, e2 [num_q, C]
// f32 squared codeword norms -> codes [num_q, N] int32.
extern "C" int rvq_encode_f32(const float* x, const float* cb, const float* e2,
                              int* codes, int N, int num_q, int C, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rvq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + TN - 1) / TN;
  rvq_encode_kernel<<<blocks, THREADS, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, cb, e2, codes, N, num_q, C);
  return static_cast<int>(cudaGetLastError());
}
