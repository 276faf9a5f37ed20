// K6: one query token's attention over the GPT's KV cache plus its own key
// and value (the self term), normalised; the new key and value are then
// appended to the cache at slot `pos`.
//
// Replaces audiotoken_tpu/ops/decode_attention.py:decode_attention_fused
// (Pallas kernel `_kernel_fused`, reached through the pallas_call at :142)
// and its partials form decode_attention (`_kernel`, :186), which returned
// (acc, m, l) only so that XLA could fold in the self term. For one
// (batch row b, head h), with dh = 64 and q already times dh^-0.5:
//
//   slots  j in [start[b], pos) of the cache, then the self term (k_new, v_new)
//   s_j    = q . k_j;   p_j = exp(s_j - max s) / sum exp(s - max s)
//   out    = sum_j p_j v_j                                  (f32, stored in T)
//
// A row with no valid slot attends to itself alone and returns v_new, as
// the Pallas kernel does. Validity comes from `start` and `pos`: there is
// no [B, L] mask tensor, and slots past `pos` are never read.
//
// What bounds it on this card: reading the valid part of the cache,
// 2 x n x 64 elements per (b, h); at B = 32, 12 heads and 1024 slots in
// bf16 that is 100 MB per layer, 30 us at 3.35 TB/s. FLOPs are 4 per
// element read, far below the card's ratio. The TPU kernel streamed the
// whole static cache through VMEM with a block-diagonal Q so that the MXU
// saw (8, 128) tiles; here the cache is [B, nh, slots, 64] (the port's own
// layout), and the design is the direct one:
//   * one block per (b, h), 256 threads;
//   * scores: 8 lanes share a slot, each holding 8 of q's 64 dims in
//     registers and reading 16 (bf16) or 32 (f32) contiguous bytes of the
//     key; three shuffles sum the dot product; the n scores go to shared
//     memory (n <= slots + 1 floats, 4 KB at 1024 slots);
//   * a block reduction gives the max, a second pass the exponentials and
//     their sum;
//   * values: the same 8-lane groups, each lane accumulating 8 dims of 32
//     slots apart in registers from one 16- or 32-byte load per slot; the
//     32 groups' sums meet in shared memory;
//   * both slot loops keep four slots' loads in flight per lane;
//   * last, the block writes k_new and v_new into slot `pos` of its (b, h):
//     no other block reads that slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = THREADS / 8;  // 8 lanes per slot, 8 of the 64 dims each
constexpr int UNROLL = 4;            // slots in flight per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
decode_attention_kernel(const T* __restrict__ q, T* kc, T* vc, const int* __restrict__ start,
                        const T* __restrict__ k_new, const T* __restrict__ v_new,
                        T* __restrict__ out, int nh, int L, int pos, int kv_stride) {
  extern __shared__ float s[];  // [n] scores, then probabilities
  __shared__ float red[WARPS];
  __shared__ __align__(16) float part[GROUPS][DH];

  const int bh = blockIdx.x;
  const int b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / 8, sub = tid % 8;
  const int st = min(max(start[b], 0), pos);
  const int n = pos - st + 1;  // cached slots st..pos-1, then the self term at n-1
  const T* kb = kc + ((size_t)bh * L + st) * DH + sub * 8;
  const T* vb = vc + ((size_t)bh * L + st) * DH + sub * 8;
  const T* kn = k_new + (size_t)b * kv_stride + h * DH;
  const T* vn = v_new + (size_t)b * kv_stride + h * DH;

  // scores: slot j = j0 + g + GROUPS * u; j0 is uniform across the block,
  // so every lane of a warp runs the same shuffles
  float qv[8];
  load8(q + (size_t)bh * DH + sub * 8, qv);
  float mloc = -CUDART_INF_F;
  for (int j0 = 0; j0 < n; j0 += GROUPS * UNROLL) {
    float kv[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + g + GROUPS * u;
      if (j < n) load8(j < n - 1 ? kb + (size_t)j * DH : kn + sub * 8, kv[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + g + GROUPS * u;
      float acc = 0.f;
      if (j < n) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(qv[i], kv[u][i], acc);
      }
      acc += __shfl_xor_sync(FULL, acc, 4);
      acc += __shfl_xor_sync(FULL, acc, 2);
      acc += __shfl_xor_sync(FULL, acc, 1);
      if (j < n) {
        if (sub == 0) s[j] = acc;
        mloc = fmaxf(mloc, acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) mloc = fmaxf(mloc, __shfl_xor_sync(FULL, mloc, off));
  if (lane == 0) red[warp] = mloc;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // everyone has read red; s is complete

  float lsum = 0.f;
  for (int j = tid; j < n; j += THREADS) {
    const float p = expf(s[j] - m);
    s[j] = p;
    lsum += p;
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) lsum += __shfl_xor_sync(FULL, lsum, off);
  if (lane == 0) red[warp] = lsum;
  __syncthreads();  // red and the probabilities are complete
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) l += red[w];

  // values: lane (g, sub) sums p_j v_j[sub*8 .. sub*8+7] over its slots
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < n; j0 += GROUPS * UNROLL) {
    float vv[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + g + GROUPS * u;
      if (j < n) load8(j < n - 1 ? vb + (size_t)j * DH : vn + sub * 8, vv[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + g + GROUPS * u;
      if (j < n) {
        const float p = s[j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vv[u][i], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[g][sub * 8 + i] = acc[i];
  __syncthreads();
  if (tid < DH) {
    float o = 0.f;
#pragma unroll 8
    for (int i = 0; i < GROUPS; ++i) o += part[i][tid];
    out[(size_t)b * nh * DH + h * DH + tid] = from_f<T>(o / l);
  } else if (tid < 2 * DH) {
    kc[((size_t)bh * L + pos) * DH + tid - DH] = kn[tid - DH];
  } else if (tid < 3 * DH) {
    vc[((size_t)bh * L + pos) * DH + tid - 2 * DH] = vn[tid - 2 * DH];
  }
}

template <typename T>
int launch(const T* q, T* kc, T* vc, const int* start, const T* k_new, const T* v_new, T* out,
           int B, int nh, int L, int pos, int kv_stride, void* stream) {
  const size_t smem = (size_t)(pos + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attention_kernel<T><<<B * nh, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, kc, vc, start, k_new, v_new, out, nh, L, pos, kv_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, nh, 64] pre-scaled; k/v caches [B, nh, L, 64] (one layer), read at
// slots [start[b], pos) and written at slot pos; start [B] int32; k_new,
// v_new [B, nh*64] rows kv_stride elements apart; out [B, nh*64].
extern "C" int decode_attention_f32(const float* q, float* kc, float* vc, const int* start,
                                    const float* k_new, const float* v_new, float* out,
                                    int B, int nh, int L, int pos, int kv_stride, void* stream) {
  return launch(q, kc, vc, start, k_new, v_new, out, B, nh, L, pos, kv_stride, stream);
}

extern "C" int decode_attention_bf16(const __nv_bfloat16* q, __nv_bfloat16* kc,
                                     __nv_bfloat16* vc, const int* start,
                                     const __nv_bfloat16* k_new, const __nv_bfloat16* v_new,
                                     __nv_bfloat16* out, int B, int nh, int L, int pos,
                                     int kv_stride, void* stream) {
  return launch(q, kc, vc, start, k_new, v_new, out, B, nh, L, pos, kv_stride, stream);
}
