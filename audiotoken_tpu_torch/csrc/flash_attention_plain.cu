// K5: non-causal attention with no bias and no mask, q pre-scaled.
//
// Replaces audiotoken_tpu/ops/flash_attention.py:_flash_attention_plain
// (Pallas kernels `_kernel_onepass`, reached through the pallas_call at
// :287 for T <= 1024, and `_kernel_plain`, the tiled form at :309; both
// compute the same function). For one (batch, head), with dh = 64:
//
//   out[q] = sum_k softmax_k(q . k) v[k]       (q already times dh^-0.5)
//
// in f32 whatever the element type, with the output written in the input's
// type (bf16 or f32). Bark-fine calls it at [B, 16, 1024, 64] bf16, 24
// layers x 6 codebook passes per window.
//
// What bounds it on this card: 4 x T^2 x dh FLOPs per (batch, head), 34.4
// GFLOP per layer at [8, 16, 1024, 64]. This first kernel computes them
// as f32 FMAs (the f32 parity path needs IEEE f32, and one code path
// serves both types), so the f32 FMA rate bounds it: about 0.5 ms a layer
// at 67 TFLOP/s. bf16 tensor cores (mma.sync / wgmma) are the later step
// for the bf16 path. q, k and v are 16 MB each in bf16; a head's K and V
// are read by its 16 query-tile blocks, mostly from L2.
// The design is K4's (csrc/flash_attention.cu) without the rel term and
// the padding bias:
//   * one block per (batch*head, tile of 64 query rows), 256 threads; the
//     query tile stays in shared memory as f32, transposed;
//   * keys and values stream through shared memory 64 at a time, converted
//     to f32 on load; each thread computes a 4 x 4 register tile of scores,
//     then a 4 x 4 tile of the output from the probabilities;
//   * online softmax per row, reduced across the 16 threads that share the
//     rows with warp shuffles; no score reaches device memory;
//   * T is not padded: keys past T leave the softmax, rows past T are not
//     written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 64;        // head size
constexpr int TQ = 64;        // query rows per block
constexpr int TK = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 query rows; tx 4 keys, then 4 of dh
constexpr int LD = TQ + 4;    // padded leading dimension of the transposed tiles
constexpr unsigned FULL = 0xffffffffu;

static_assert(TQ == TK, "the transposed tiles share LD");

constexpr size_t SMEM_BYTES = (size_t)(2 * DH * LD + TK * LD + TK * DH) * sizeof(float);

// four consecutive elements of row `r` (dims 4*d4 .. 4*d4+3) as floats
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_plain_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, int T_len) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;          // [DH][LD] query tile, transposed
  float* kT = qT + DH * LD;  // [DH][LD] key tile, transposed
  float* pT = kT + DH * LD;  // [TK][LD] probabilities, transposed
  float* vs = pT + TK * LD;  // [TK][DH] value tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * TQ;
  const size_t base = (size_t)blockIdx.y * T_len * DH;

  for (int e = tid; e < TQ * (DH / 4); e += THREADS) {
    const int r = e % TQ, d4 = e / TQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T_len) x = load4(q + base + (size_t)(q0 + r) * DH + d4 * 4);
    qT[(d4 * 4 + 0) * LD + r] = x.x;
    qT[(d4 * 4 + 1) * LD + r] = x.y;
    qT[(d4 * 4 + 2) * LD + r] = x.z;
    qT[(d4 * 4 + 3) * LD + r] = x.w;
  }

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < T_len; k0 += TK) {
    __syncthreads();  // the previous tile is consumed; qT is written
    for (int e = tid; e < TK * (DH / 4); e += THREADS) {
      const int c = e % TK, d4 = e / TK;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < T_len) x = load4(k + base + (size_t)(k0 + c) * DH + d4 * 4);
      kT[(d4 * 4 + 0) * LD + c] = x.x;
      kT[(d4 * 4 + 1) * LD + c] = x.y;
      kT[(d4 * 4 + 2) * LD + c] = x.z;
      kT[(d4 * 4 + 3) * LD + c] = x.w;
      const int cv = e / (DH / 4), dv = e % (DH / 4);
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + cv < T_len) y = load4(v + base + (size_t)(k0 + cv) * DH + dv * 4);
      *reinterpret_cast<float4*>(vs + cv * DH + dv * 4) = y;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * LD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kT + d * LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx * 4 + j >= T_len) s[i][j] = -CUDART_INF_F;

    // Online softmax. The 16 lanes with the same ty form one half warp.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: every tile has a key < T
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) rs += __shfl_xor_sync(FULL, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < TK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pT + c * LD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(vs + c * DH + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(av[i], bv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty * 4 + i;
    if (qg < T_len) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      store4(out + base + (size_t)qg * DH + tx * 4,
             make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv));
    }
  }
}

template <typename T>
int launch_plain(const T* q, const T* k, const T* v, T* out, int BH, int T_len, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_plain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + TQ - 1) / TQ, BH);
  flash_attention_plain_kernel<T><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, T_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (pre-scaled), k, v, out [BH, T, 64] contiguous, one element type.
extern "C" int flash_attention_plain_f32(const float* q, const float* k, const float* v,
                                         float* out, int BH, int T, void* stream) {
  return launch_plain(q, k, v, out, BH, T, stream);
}

extern "C" int flash_attention_plain_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, __nv_bfloat16* out,
                                          int BH, int T, void* stream) {
  return launch_plain(q, k, v, out, BH, T, stream);
}
