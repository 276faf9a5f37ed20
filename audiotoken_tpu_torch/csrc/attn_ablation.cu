// K8: cost-attribution ablations of K5 (not valid attention).
//
// Replaces the two Pallas kernels of scripts/profile_attn_micro.py: the
// ablation kernel (`ablation_kernel`, launched by `run_ablation`, the
// pallas_call at :108) and the one-pass kernel (`onepass_kernel`, launched
// by `run_onepass` at :157). They split the time of a non-causal attention
// between its two dot products and its online softmax by taking parts of
// the softmax out. Here they ablate K5's first design, which its f32 path
// keeps (csrc/flash_attention_plain.cu: 64 query rows a block, 256
// threads, f32 FMAs on tiles converted to f32 in shared memory), not the TPU
// kernel's 256/512 tiles and head groups, which Hopper's shared memory does
// not hold. The `full` mode is that design whole, valid attention: an
// ablation's time is subtracted from full's, never from K5's bf16 kernel on
// the tensor cores, which is another design.
//
// Modes, for q (pre-scaled), k, v [BH, T, 64] bf16 or f32, with
// s = q . k in f32 and `round` the rounding to the element type:
//   noexp     per key tile: m' = max(m, rowmax(s)), alpha = exp(m - m'),
//             p = s - m' (no exp), l = l * alpha + rowsum(p), and the
//             accumulator is NOT rescaled by alpha; acc += round(p) v
//   dotsonly  per key tile: p = round(s * 1e-6), l += 1; acc += p v
//   full      per key tile: the online softmax whole, m' as in noexp,
//             p = exp(s - m'), l = l * alpha + rowsum(p), acc = acc * alpha
//             + round(p) v: the function of K5 and of the Pallas
//             `_kernel_plain` (audiotoken_tpu/ops/flash_attention.py:218)
//   onepass   exact softmax over the whole key row in one pass (no m/l
//             recurrence): the T scores of each query row sit in shared
//             memory, then p = exp(s - max), l = sum(p), acc = round(p) v
// and every mode writes round(acc / max(l, 1e-30)), as the Pallas bodies do.
// noexp and dotsonly take a key tile of 64 or 128 (the result depends on
// it), full a key tile of 64; onepass takes 16 or 32 query rows a block (the
// result does not).
//
// What bounds it: the two dot products, 4 T^2 dh FLOPs per (batch, head),
// 68.7 GFLOP at [16, 16, 1024, 64]; as f32 FMAs the f32 rate bounds it
// (about 1 ms at 67 TFLOP/s), against 0.07 ms for bf16 tensor cores. The
// modes share one design, so that full's time minus a mode's is the cost of
// what the mode took out. onepass keeps a whole score row per query row in shared
// memory (16 rows x 1024 keys x 4 B = 64 KB), and so reads each head's K and
// V once per 16 or 32 rows, mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 64;        // head size
constexpr int TQ = 64;        // query rows per block (tiled modes)
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDQ = TQ + 4;   // padded leading dimension of qT and pT
constexpr int KT = 64;        // keys per shared-memory tile (onepass)
constexpr unsigned FULL = 0xffffffffu;

enum Mode { NOEXP = 0, DOTSONLY = 1, ONEPASS = 2, FULL_SOFTMAX = 3 };

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

// x rounded to the element type, back in f32 (the Pallas `p.astype(v.dtype)`)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int TK>
constexpr size_t tiled_smem_bytes() {
  return (size_t)(DH * LDQ + DH * (TK + 4) + TK * LDQ + TK * DH) * sizeof(float);
}

// noexp / dotsonly / full over key tiles of TK (64 or 128). ty owns 4 query rows;
// for the scores tx owns TK / 16 keys (tx*4 .. tx*4+3 of each 64-key half),
// for the output 4 of the 64 dims.
template <int MODE, int TK, typename T>
__global__ void __launch_bounds__(THREADS)
attn_ablation_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int T_len) {
  constexpr int KPT = TK / 16;  // keys per thread
  constexpr int LDK = TK + 4;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;           // [DH][LDQ] query tile, transposed
  float* kT = qT + DH * LDQ;  // [DH][LDK] key tile, transposed
  float* pT = kT + DH * LDK;  // [TK][LDQ] p, transposed
  float* vs = pT + TK * LDQ;  // [TK][DH] value tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * TQ;
  const size_t base = (size_t)blockIdx.y * T_len * DH;

  for (int e = tid; e < TQ * (DH / 4); e += THREADS) {
    const int r = e % TQ, d4 = e / TQ;
    const float4 x = load4(q + base + (size_t)(q0 + r) * DH + d4 * 4);
    qT[(d4 * 4 + 0) * LDQ + r] = x.x;
    qT[(d4 * 4 + 1) * LDQ + r] = x.y;
    qT[(d4 * 4 + 2) * LDQ + r] = x.z;
    qT[(d4 * 4 + 3) * LDQ + r] = x.w;
  }

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < T_len; k0 += TK) {  // T_len % TK == 0 (the wrapper checks)
    __syncthreads();  // the previous tile is consumed; qT is written
    for (int e = tid; e < TK * (DH / 4); e += THREADS) {
      const int c = e % TK, d4 = e / TK;
      const float4 x = load4(k + base + (size_t)(k0 + c) * DH + d4 * 4);
      kT[(d4 * 4 + 0) * LDK + c] = x.x;
      kT[(d4 * 4 + 1) * LDK + c] = x.y;
      kT[(d4 * 4 + 2) * LDK + c] = x.z;
      kT[(d4 * 4 + 3) * LDK + c] = x.w;
      const int cv = e / (DH / 4), dv = e % (DH / 4);
      store4(vs + cv * DH + dv * 4, load4(v + base + (size_t)(k0 + cv) * DH + dv * 4));
    }
    __syncthreads();

    float s[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * LDQ + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < KPT / 4; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(kT + d * LDK + g * 64 + tx * 4);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][g * 4 + j] = fmaf(av[i], bv[j], s[i][g * 4 + j]);
      }
    }

    // The 16 lanes with the same ty form one half warp and share the rows.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (MODE == DOTSONLY) {
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = round_to(s[i][j] * 1e-6f, q);
        l[i] += 1.f;
      } else {  // NOEXP, FULL_SOFTMAX
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          // noexp: the identity in place of exp
          s[i][j] = MODE == FULL_SOFTMAX ? expf(s[i][j] - m_new) : s[i][j] - m_new;
          rs += s[i][j];
          s[i][j] = round_to(s[i][j], q);
        }
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1) rs += __shfl_xor_sync(FULL, rs, off);
        l[i] = l[i] * alpha + rs;
        if (MODE == FULL_SOFTMAX) {  // noexp: the accumulator keeps its scale
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
        }
        m[i] = m_new;
      }
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      store4(pT + ((j / 4) * 64 + tx * 4 + (j % 4)) * LDQ + ty * 4,
             make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < TK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pT + c * LDQ + ty * 4);
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
    const float den = fmaxf(l[i], 1e-30f);
    store4(out + base + (size_t)(q0 + ty * 4 + i) * DH + tx * 4,
           make_float4(o[i][0] / den, o[i][1] / den, o[i][2] / den, o[i][3] / den));
  }
}

__host__ __device__ constexpr int onepass_ld(int T_len) { return T_len + 4; }

size_t onepass_smem_bytes(int R, int T_len) {
  return (size_t)(R * onepass_ld(T_len) + DH * R + KT * (KT + 4) + R) * sizeof(float);
}

// onepass: R (16 or 32) query rows a block. Scores: ty owns R/16 rows, tx
// 4 keys of each 64-key tile. Softmax: 256/R consecutive lanes a row.
// Output: ty's R/16 rows, tx's 4 dims.
template <int R, typename T>
__global__ void __launch_bounds__(THREADS)
attn_onepass_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int T_len) {
  constexpr int RPT = R / 16;         // rows per ty
  constexpr int NT = THREADS / R;     // lanes per row in the softmax
  extern __shared__ __align__(16) float smem[];
  const int LDS = onepass_ld(T_len);
  float* S = smem;                    // [R][LDS] scores, then p
  float* qT = S + R * LDS;            // [DH][R] query rows, transposed
  float* tile = qT + DH * R;          // [DH][KT+4] keys (transposed), then [KT][DH] values
  float* lrow = tile + KT * (KT + 4); // [R] row sums

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int r0 = blockIdx.x * R;
  const size_t base = (size_t)blockIdx.y * T_len * DH;

  for (int e = tid; e < R * (DH / 4); e += THREADS) {
    const int r = e % R, d4 = e / R;
    const float4 x = load4(q + base + (size_t)(r0 + r) * DH + d4 * 4);
    qT[(d4 * 4 + 0) * R + r] = x.x;
    qT[(d4 * 4 + 1) * R + r] = x.y;
    qT[(d4 * 4 + 2) * R + r] = x.z;
    qT[(d4 * 4 + 3) * R + r] = x.w;
  }

  // 1. all T scores of the block's rows
  for (int k0 = 0; k0 < T_len; k0 += KT) {
    __syncthreads();
    for (int e = tid; e < KT * (DH / 4); e += THREADS) {
      const int c = e % KT, d4 = e / KT;
      const float4 x = load4(k + base + (size_t)(k0 + c) * DH + d4 * 4);
      tile[(d4 * 4 + 0) * (KT + 4) + c] = x.x;
      tile[(d4 * 4 + 1) * (KT + 4) + c] = x.y;
      tile[(d4 * 4 + 2) * (KT + 4) + c] = x.z;
      tile[(d4 * 4 + 3) * (KT + 4) + c] = x.w;
    }
    __syncthreads();
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 b = *reinterpret_cast<const float4*>(tile + d * (KT + 4) + tx * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = qT[d * R + ty * RPT + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a, bv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      store4(S + (ty * RPT + i) * LDS + k0 + tx * 4, make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
  }
  __syncthreads();

  // 2. exact softmax of each row: max, p = exp(s - max), l = sum(p) in f32,
  //    p kept rounded to the element type for the second product
  {
    const int r = tid / NT, u = tid % NT;
    float* row = S + r * LDS;
    float mx = -CUDART_INF_F;
    for (int c = u * 4; c < T_len; c += NT * 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + c);
      mx = fmaxf(mx, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    }
#pragma unroll
    for (int off = NT / 2; off >= 1; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float sum = 0.f;
    for (int c = u * 4; c < T_len; c += NT * 4) {
      float4 x = *reinterpret_cast<const float4*>(row + c);
      x.x = expf(x.x - mx);
      x.y = expf(x.y - mx);
      x.z = expf(x.z - mx);
      x.w = expf(x.w - mx);
      sum += (x.x + x.y) + (x.z + x.w);
      store4(row + c, make_float4(round_to(x.x, q), round_to(x.y, q), round_to(x.z, q),
                                  round_to(x.w, q)));
    }
#pragma unroll
    for (int off = NT / 2; off >= 1; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
    if (u == 0) lrow[r] = sum;
  }

  // 3. acc = p v over value tiles
  float o[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += KT) {
    __syncthreads();
    for (int e = tid; e < KT * (DH / 4); e += THREADS) {
      const int cv = e / (DH / 4), dv = e % (DH / 4);
      store4(tile + cv * DH + dv * 4, load4(v + base + (size_t)(k0 + cv) * DH + dv * 4));
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < KT; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(tile + c * DH + tx * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = S[(ty * RPT + i) * LDS + k0 + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a, bv[j], o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const float den = fmaxf(lrow[r], 1e-30f);
    store4(out + base + (size_t)(r0 + r) * DH + tx * 4,
           make_float4(o[i][0] / den, o[i][1] / den, o[i][2] / den, o[i][3] / den));
  }
}

template <int MODE, int TK, typename T>
int launch_tiled(const T* q, const T* k, const T* v, T* out, int BH, int T_len, void* stream) {
  auto kernel = attn_ablation_tiled_kernel<MODE, TK, T>;
  constexpr size_t smem = tiled_smem_bytes<TK>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(T_len / TQ, BH), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, out,
                                                                                   T_len);
  return static_cast<int>(cudaGetLastError());
}

template <int R, typename T>
int launch_onepass(const T* q, const T* k, const T* v, T* out, int BH, int T_len, void* stream) {
  auto kernel = attn_onepass_kernel<R, T>;
  const size_t smem = onepass_smem_bytes(R, T_len);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(T_len / R, BH), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, out,
                                                                                  T_len);
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 noexp, 1 dotsonly (tile = keys per tile, 64 or 128), 2 onepass
// (tile = query rows per block, 16 or 32), 3 full (tile = 64 keys). T must be a multiple of the key
// tile for the tiled modes and of 64, at most 1024, for onepass (the wrapper
// checks).
template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* out, int BH, int T_len, int mode, int tile,
             void* stream) {
  if (mode == NOEXP && tile == 64) return launch_tiled<NOEXP, 64>(q, k, v, out, BH, T_len, stream);
  if (mode == NOEXP && tile == 128) return launch_tiled<NOEXP, 128>(q, k, v, out, BH, T_len, stream);
  if (mode == DOTSONLY && tile == 64)
    return launch_tiled<DOTSONLY, 64>(q, k, v, out, BH, T_len, stream);
  if (mode == DOTSONLY && tile == 128)
    return launch_tiled<DOTSONLY, 128>(q, k, v, out, BH, T_len, stream);
  if (mode == FULL_SOFTMAX && tile == 64)
    return launch_tiled<FULL_SOFTMAX, 64>(q, k, v, out, BH, T_len, stream);
  if (mode == ONEPASS && tile == 16) return launch_onepass<16>(q, k, v, out, BH, T_len, stream);
  if (mode == ONEPASS && tile == 32) return launch_onepass<32>(q, k, v, out, BH, T_len, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (pre-scaled), k, v, out [BH, T, 64] contiguous, one element type.
extern "C" int attn_ablation_f32(const float* q, const float* k, const float* v, float* out,
                                 int BH, int T, int mode, int tile, void* stream) {
  return dispatch(q, k, v, out, BH, T, mode, tile, stream);
}

extern "C" int attn_ablation_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, __nv_bfloat16* out, int BH, int T,
                                  int mode, int tile, void* stream) {
  return dispatch(q, k, v, out, BH, T, mode, tile, stream);
}
