// K7: the GPT decode step's products around the attention, for one token
// per row: decode_qkv (LN1 -> x Wqkv + b) and decode_ffn (x + a Wo + bo ->
// LN2 -> exact-GELU(h Win + bi) Wout2 + b2 + residual).
//
// Replaces audiotoken_tpu/ops/decode_step_fused.py:decode_qkv (Pallas
// kernel `_qkv_kernel`, pallas_call at :108) and decode_ffn (`_ffn_kernel`,
// :131). Both are built here from one kernel, a weight-streaming GEMV over
// B <= 32 rows with an optional LayerNorm prologue and a bias / GELU /
// residual epilogue:
//
//   y[b, o] = epi( sum_k pro(x)[b, k] W[o, k] )       W [N, K], torch layout
//
// decode_qkv is one launch (LN prologue, bias); decode_ffn is three from
// one C call (bias + residual; LN prologue, bias, GELU; bias + residual),
// because LN2 needs the whole x1 row. The numerics follow the Pallas
// kernels' staging: LN statistics in f32; the normalised row, the scale
// and the shift rounded
// to T in turn; each product accumulated in f32 and rounded to T, then the
// bias added in T, GELU (erff, exact) in f32 rounded to T, and the residual
// added in T. For T = f32 every rounding is the identity.
//
// What bounds it on this card: reading the weights. At 768 wide a layer's
// four matrices are 14.2 MB in bf16, 4.2 us at 3.35 TB/s, against 2 x B x
// 7.1 M FLOPs (0.45 GFLOP at B = 32), far below the ratio where FLOPs bound.
// The design reads each weight once for all rows:
//   * a warp owns two output columns; lane i reads 8 contiguous weights of
//     each (16 or 32 bytes) per 256-wide chunk of k, so a warp streams two
//     rows of W coalesced;
//   * the block's 256 threads stage the rows' chunk of x (after the LN
//     prologue) in shared memory; each lane keeps 2 x B accumulators in
//     registers (B <= 32);
//   * the accumulators are summed across the warp with shuffles, and lane b
//     applies row b's epilogue;
//   * B > 32 runs as several launches of 32 rows.
// 16 columns per block: 48 blocks for the 768-wide outputs, 144 for qkv,
// 192 for the MLP's input product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPW = 2;                  // output columns per warp
constexpr int COLS = WARPS * CPW;       // output columns per block
constexpr int KC = 256;                 // k per chunk: 32 lanes x 8
constexpr int MAXB = 32;                // rows per launch
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// round a float to T and back: the staging of the T-typed reference
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_gemv_kernel(const T* __restrict__ x, const T* __restrict__ ln_w,
                   const T* __restrict__ ln_b, const T* __restrict__ W,
                   const T* __restrict__ bias, const T* __restrict__ resid, T* __restrict__ y,
                   int B, int K, int N, bool do_ln, int gelu, float eps) {
  __shared__ __align__(16) unsigned char xs_raw[MAXB * KC * sizeof(T)];
  __shared__ float mu[MAXB], rstd[MAXB];
  T* xs = reinterpret_cast<T*>(xs_raw);  // [B][KC] chunk of pro(x)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (do_ln) {  // per-row statistics in f32, two passes over the row
    for (int b = warp; b < B; b += WARPS) {
      const T* xr = x + (size_t)b * K;
      float sum = 0.f;
      for (int k = lane; k < K; k += 32) sum += to_f(xr[k]);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
      const float mean = sum / K;
      float sq = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float dv = to_f(xr[k]) - mean;
        sq = fmaf(dv, dv, sq);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) sq += __shfl_xor_sync(FULL, sq, off);
      if (lane == 0) {
        mu[b] = mean;
        rstd[b] = rsqrtf(sq / K + eps);
      }
    }
  }

  int cols[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) cols[c] = blockIdx.x * COLS + warp * CPW + c;
  float acc[CPW][MAXB];
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc[c][b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed; the statistics are written
    for (int e = tid; e < B * KC; e += THREADS) {
      const int b = e / KC, kk = e % KC, k = k0 + kk;
      float v = 0.f;
      if (k < K) {
        v = to_f(x[(size_t)b * K + k]);
        if (do_ln) {
          v = rnd<T>((v - mu[b]) * rstd[b]);
          v = rnd<T>(v * to_f(ln_w[k]));
          if (ln_b) v = rnd<T>(v + to_f(ln_b[k]));
        }
      }
      xs[b * KC + kk] = from_f<T>(v);
    }
    __syncthreads();

    const int kk = lane * 8;
    if (k0 + kk < K) {  // K % 8 == 0: the lane's 8 are all in range
      float w[CPW][8];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        if (cols[c] < N) {
          load8(W + (size_t)cols[c] * K + k0 + kk, w[c]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) w[c][i] = 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) {
          float xv[8];
          load8(xs + b * KC + kk, xv);
#pragma unroll
          for (int c = 0; c < CPW; ++c)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[c][b] = fmaf(w[c][i], xv[i], acc[c][b]);
        }
      }
    }
  }

  // sum across the warp; lane b keeps row b's sums
  float mine[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    mine[c] = 0.f;
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) {
        float v = acc[c][b];
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
        if (lane == b) mine[c] = v;
      }
    }
  }
  if (lane < B) {
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      const int o = cols[c];
      if (o < N) {
        float t = rnd<T>(mine[c]);
        if (bias) t = rnd<T>(t + to_f(bias[o]));
        if (gelu) t = rnd<T>(0.5f * t * (1.f + erff(t * 0.70710678118654752f)));
        if (resid) t = rnd<T>(to_f(resid[(size_t)lane * N + o]) + t);
        y[(size_t)lane * N + o] = from_f<T>(t);
      }
    }
  }
}

// y = epi(pro(x) W^T), B > 32 as several launches of 32 rows
template <typename T>
cudaError_t gemv(const T* x, const T* ln_w, const T* ln_b, const T* W, const T* bias,
                 const T* resid, T* y, int B, int K, int N, int gelu, float eps,
                 cudaStream_t stream) {
  const dim3 grid((N + COLS - 1) / COLS);
  for (int r0 = 0; r0 < B; r0 += MAXB) {
    const int rows = B - r0 < MAXB ? B - r0 : MAXB;
    decode_gemv_kernel<T><<<grid, THREADS, 0, stream>>>(
        x + (size_t)r0 * K, ln_w, ln_b, W, bias, resid ? resid + (size_t)r0 * N : nullptr,
        y + (size_t)r0 * N, rows, K, N, ln_w != nullptr, gelu, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// qkv [B, N] = LN(x) W^T + b
template <typename T>
int qkv(const T* x, const T* ln_w, const T* ln_b, const T* W, const T* b, T* y, int B, int C,
        int N, float eps, void* stream) {
  return static_cast<int>(gemv(x, ln_w, ln_b, W, b, (const T*)nullptr, y, B, C, N, 0, eps,
                               static_cast<cudaStream_t>(stream)));
}

// x1 = x + a Wo^T + bo;  h = GELU(LN(x1) Wi^T + bi);  out = x1 + h W2^T + b2
template <typename T>
int ffn(const T* x, const T* a, const T* wo, const T* bo, const T* ln_w, const T* ln_b,
        const T* wi, const T* bi, const T* w2, const T* b2, T* x1, T* h, T* out, int B, int C,
        int H, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* none = nullptr;
  cudaError_t err = gemv(a, none, none, wo, bo, x, x1, B, C, C, 0, eps, st);
  if (err == cudaSuccess) err = gemv((const T*)x1, ln_w, ln_b, wi, bi, none, h, B, C, H, 1, eps, st);
  if (err == cudaSuccess) err = gemv((const T*)h, none, none, w2, b2, (const T*)x1, out, B, H, C, 0,
                                     eps, st);
  return static_cast<int>(err);
}

}  // namespace

// decode_qkv: x [B, C]; ln_w, ln_b [C] (ln_b may be null); W [N, C]; b [N]
// or null; y [B, N]. C % 8 == 0.
extern "C" int decode_qkv_f32(const float* x, const float* ln_w, const float* ln_b,
                              const float* W, const float* b, float* y, int B, int C, int N,
                              float eps, void* stream) {
  return qkv(x, ln_w, ln_b, W, b, y, B, C, N, eps, stream);
}

extern "C" int decode_qkv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* ln_w,
                               const __nv_bfloat16* ln_b, const __nv_bfloat16* W,
                               const __nv_bfloat16* b, __nv_bfloat16* y, int B, int C, int N,
                               float eps, void* stream) {
  return qkv(x, ln_w, ln_b, W, b, y, B, C, N, eps, stream);
}

// decode_ffn: x, a [B, C]; wo [C, C]; wi [H, C]; w2 [C, H]; biases or null;
// ln_b may be null; x1 [B, C] and h [B, H] scratch; out [B, C]. C, H % 8 == 0.
extern "C" int decode_ffn_f32(const float* x, const float* a, const float* wo, const float* bo,
                              const float* ln_w, const float* ln_b, const float* wi,
                              const float* bi, const float* w2, const float* b2, float* x1,
                              float* h, float* out, int B, int C, int H, float eps, void* stream) {
  return ffn(x, a, wo, bo, ln_w, ln_b, wi, bi, w2, b2, x1, h, out, B, C, H, eps, stream);
}

extern "C" int decode_ffn_bf16(const __nv_bfloat16* x, const __nv_bfloat16* a,
                               const __nv_bfloat16* wo, const __nv_bfloat16* bo,
                               const __nv_bfloat16* ln_w, const __nv_bfloat16* ln_b,
                               const __nv_bfloat16* wi, const __nv_bfloat16* bi,
                               const __nv_bfloat16* w2, const __nv_bfloat16* b2,
                               __nv_bfloat16* x1, __nv_bfloat16* h, __nv_bfloat16* out, int B,
                               int C, int H, float eps, void* stream) {
  return ffn(x, a, wo, bo, ln_w, ln_b, wi, bi, w2, b2, x1, h, out, B, C, H, eps, stream);
}
