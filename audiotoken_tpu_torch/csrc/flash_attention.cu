// K4: attention with the relative_key position bias and the key-padding bias.
//
// Replaces audiotoken_tpu/ops/flash_attention.py:flash_attention_relkey
// (Pallas kernel `_kernel`, reached through the pallas_call at :519; the
// 2-head-packed branch at :464 computes the same function). For one
// (batch, head), with dh = 64:
//
//   s[q, k]   = (q . k + rel[q, k]) * dh^-0.5 + (1 - mask[k]) * (-FLT_MAX)
//   rel[q, k] = pos[q, clamp(k - q + left, 0, P - 1)],   pos = q E^T
//   out[q]    = sum_k softmax_k(s[q, :]) v[k]
//
// The rel term is dropped when E is null (P = 0), the padding term when the
// mask is null: that is the HuBERT form of the same function.
//
// What bounds it on this card: 4 x T^2 x dh FLOPs per (batch, head), 73.7
// GFLOP per conformer layer at [8, 16, 1500, 64], in IEEE f32 FMAs (token
// parity), so the f32 FMA rate bounds it: about 1.1 ms per layer at 67
// TFLOP/s. q, k and v are 49 MB each; a head's K and V (768 KB) are read
// by its 24 query-tile blocks, mostly from L2, well below its bandwidth.
// The design:
//   * one block per (batch*head, tile of 64 query rows), 256 threads; the
//     query tile stays in shared memory, transposed, so that a thread reads
//     its 4 rows as one float4;
//   * pos = q_tile E^T [64, P] is computed once per block into shared
//     memory, and the rel term is read from it at the clamped distance. No
//     shear and no band masks: those were the TPU's way round a missing
//     lane gather;
//   * keys and values stream through shared memory 64 at a time. Each
//     thread computes a 4 x 4 register tile of scores (16 FMAs per two
//     float4 reads), then accumulates a 4 x 4 tile of the output (its 4 rows
//     x 4 of dh) from the probabilities, which go through shared memory;
//   * the running max and denominator are per row, reduced across the 16
//     threads that share the rows with warp shuffles, and the output is
//     divided by max(l, 1e-30) at the end;
//   * T is not padded to a tile multiple: keys past T are left out of the
//     softmax, and query rows past T are not written.
// A fully masked row gets -FLT_MAX on every key, as in the plain version,
// and so the same uniform average over the row's T keys.

#include <cfloat>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 64;           // head size
constexpr int TQ = 64;           // query rows per block
constexpr int TK = 64;           // keys per shared-memory tile
constexpr int THREADS = 256;     // 16 x 16: ty owns 4 query rows; tx 4 keys, then 4 of dh
constexpr int LD = TQ + 4;       // padded leading dimension of the transposed tiles
constexpr float SCALE = 0.125f;  // dh^-0.5, exact
constexpr unsigned FULL = 0xffffffffu;

static_assert(TQ == TK, "the transposed tiles share LD");

size_t smem_bytes(int pos_ld) {
  // qT, kT [DH][LD]; pT [TK][LD]; vs [TK][DH]; kbias [TK]; pos [TQ][pos_ld]
  return (size_t)(2 * DH * LD + TK * LD + TK * DH + TK + TQ * pos_ld) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS, 2)
flash_attention_relkey_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ E,
                              const float* __restrict__ mask, float* __restrict__ out,
                              int H, int T, int P, int left, int pos_ld) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;              // [DH][LD] query tile, transposed
  float* kT = qT + DH * LD;      // [DH][LD] key tile, transposed
  float* pT = kT + DH * LD;      // [TK][LD] probabilities, transposed
  float* vs = pT + TK * LD;      // [TK][DH] value tile
  float* kbias = vs + TK * DH;   // [TK] padding bias of the tile's keys
  float* pos = kbias + TK;       // [TQ][pos_ld] q_tile E^T

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * TQ;
  const size_t base = (size_t)blockIdx.y * T * DH;
  const float* mrow = mask ? mask + (size_t)(blockIdx.y / H) * T : nullptr;

  for (int e = tid; e < TQ * (DH / 4); e += THREADS) {
    const int r = e % TQ, d4 = e / TQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) x = __ldg(reinterpret_cast<const float4*>(q + base + (size_t)(q0 + r) * DH) + d4);
    qT[(d4 * 4 + 0) * LD + r] = x.x;
    qT[(d4 * 4 + 1) * LD + r] = x.y;
    qT[(d4 * 4 + 2) * LD + r] = x.z;
    qT[(d4 * 4 + 3) * LD + r] = x.w;
  }
  __syncthreads();
  for (int e = tid; e < TQ * P; e += THREADS) {
    const int r = e % TQ, p = e / TQ;
    const float* ep = E + (size_t)p * DH;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) acc = fmaf(qT[d * LD + r], __ldg(ep + d), acc);
    pos[r * pos_ld + p] = acc;
  }

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += TK) {
    __syncthreads();  // the previous tile is consumed; pos is written
    for (int e = tid; e < TK * (DH / 4); e += THREADS) {
      const int c = e % TK, d4 = e / TK;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < T) x = __ldg(reinterpret_cast<const float4*>(k + base + (size_t)(k0 + c) * DH) + d4);
      kT[(d4 * 4 + 0) * LD + c] = x.x;
      kT[(d4 * 4 + 1) * LD + c] = x.y;
      kT[(d4 * 4 + 2) * LD + c] = x.z;
      kT[(d4 * 4 + 3) * LD + c] = x.w;
      const int cv = e / (DH / 4), dv = e % (DH / 4);
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + cv < T) y = __ldg(reinterpret_cast<const float4*>(v + base + (size_t)(k0 + cv) * DH) + dv);
      *reinterpret_cast<float4*>(vs + cv * DH + dv * 4) = y;
    }
    if (tid < TK) {
      const int kg = k0 + tid;
      kbias[tid] = (mrow && kg < T) ? (1.f - mrow[kg]) * -FLT_MAX : 0.f;
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
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        float x = s[i][j];
        if (P > 0) x += pos[r * pos_ld + min(max(k0 + c - (q0 + r) + left, 0), P - 1)];
        x = x * SCALE + kbias[c];
        s[i][j] = k0 + c < T ? x : -CUDART_INF_F;
      }
    }

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
    if (qg < T) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      *reinterpret_cast<float4*>(out + base + (size_t)qg * DH + tx * 4) =
          make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
    }
  }
}

}  // namespace

// q, k, v, out [BH, T, 64] f32 (BH = batch x H heads); E [P, 64] f32 with
// P = left + right + 1, or null with P = 0 (no rel term); mask [batch, T]
// f32, or null (no padding bias).
extern "C" int flash_attention_relkey_f32(const float* q, const float* k, const float* v,
                                          const float* E, const float* mask, float* out,
                                          int BH, int H, int T, int P, int left,
                                          void* stream) {
  const int pos_ld = P > 0 ? (P | 1) : 0;  // odd: the pos stores do not conflict
  const size_t smem = smem_bytes(pos_ld);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_relkey_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TQ - 1) / TQ, BH);
  flash_attention_relkey_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, E, mask, out, H, T, P, left, pos_ld);
  return static_cast<int>(cudaGetLastError());
}
