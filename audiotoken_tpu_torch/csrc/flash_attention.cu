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
// mask is null: that is the HuBERT form of the same function. Keys past T
// leave the softmax, rows past T are not written, and the output is divided
// by max(l, 1e-30). A fully masked row gets -FLT_MAX on every key, as in the
// plain version, and so the same uniform average over the row's T keys.
//
// K5's f32 path (flash_attention_plain_f32, the counterpart of
// `_flash_attention_plain` in f32) is the same kernel with neither term and
// q pre-scaled: the template parameter PRESCALED leaves the scores unscaled,
// and K4's instantiation keeps the constant 0.125.
//
// What bounds it on this card: 4 x T^2 x dh FLOPs per (batch, head), 73.7
// GFLOP per conformer layer at [8, 16, 1500, 64] (55.2 at HuBERT's [8, 12,
// 1499, 64]), which under the "highest" policy must come out f32-accurate:
// the TPU kernel's dots then run at Precision.HIGHEST, multi-pass bf16 on
// its matrix unit. IEEE f32 FMAs cap
// that at 67 TFLOP/s. Hopper's counterpart of the TPU's multi-pass products
// is split precision on the tensor cores, 3xTF32: each f32 operand x becomes
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), and a
// product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b with f32
// accumulation; only lo_a lo_b (about 2^-22 relative) is dropped. Three
// passes at the 495 TFLOP/s TF32 rate bound it at 165 TFLOP/s of f32-accurate
// products, 2.5x the FMA ceiling. The design, FlashAttention-2's:
//   * one block per (batch*head, 128 query rows), 8 warps of 16 rows. A warp
//     splits its Q rows once into hi and lo and holds both as the A
//     fragments of mma.sync.m16n8k8 (TF32 in, f32 accumulators);
//   * K and V stream through shared memory 64 keys at a time, double
//     buffered with 16-byte cp.async.cg, so the next tile's copy overlaps
//     this tile's math; rows past T are zero-filled (source size 0). The Q
//     tile is first staged in the second buffer, which tile 1 overwrites;
//   * the k index of an m16n8k8 fragment is only a summation index, so each
//     lane's two k slots (t, t + 4) are mapped to adjacent dims: a lane reads
//     its K operands of a k-step as one float2 (rows padded to 80 floats),
//     and in P V they are the keys 2t and 2t + 1, which is where the C
//     fragment of S = Q K^T holds them. So P goes from the softmax's
//     registers into the second product without shared memory or shuffles,
//     and V is read as V[2t][g], V[2t + 1][g] (rows padded to 68 floats: no
//     bank conflict). K, V and P are split in registers;
//   * the three terms of a k-step are each issued across all 8 n-tiles (of
//     S, or of the output for P V) before the next term, so that
//     consecutive mma.sync do not wait on one another's accumulator: that
//     measured faster on the H100 than the three terms of one tile back to
//     back. At 223 registers a thread one block of 8 warps fits an SM; a
//     variant that split Q anew every tile to fit two blocks measured slower,
//     and so did 64 query rows and 4 warps a block;
//   * the rel term: pos = q_tile E^T [128, P] is computed once per block
//     (f32 FMAs) into shared memory. A key tile wholly left of a warp's band
//     (k - q + left <= 0 for every pair) takes the per-row constant pos[r][0],
//     one wholly right of it (k - q + left >= P - 1) pos[r][P - 1], both held
//     in registers; only the tiles that cross the band gather from shared
//     memory at the clamped distance. No shear and no band masks: those were
//     the TPU's way round a missing lane gather;
//   * the online softmax runs in the accumulator registers (expf, as the
//     plain version's softmax), a row's maximum combined across its quad with
//     shuffles; the row sums are per thread until the end.
//
// The one-pass form, at JAX's Precision.DEFAULT (and HIGH, which the TPU
// kernel lowers to DEFAULT), is a kernel of its own for Hopper:
// csrc/flash_attention_tf32.cu.
//
// flash_attention_window_kernel: causal attention within a band of W keys
// (Mimi's encoder transformer, W = 250 frames at 25 Hz), no rel term, no
// padding bias, in 3xTF32 with K4's fragments and online softmax:
//
//   s[q, k] = (q . k) * dh^-0.5  if q - W < k <= q,  else -inf
//
// It replaces no TPU kernel (the JAX package runs no windowed attention);
// it was added because no kernel of the port computed causal or banded
// attention at "highest". What bounds it: 4 x dh FLOPs a (query, key) pair
// in the band, 156,375 pairs a (row, head) at T = 750 and W = 250, 80 GFLOP
// for Mimi's 8 layers at B = 32; at W << T the work is linear in T. The
// design: a block of 128 queries walks only the key tiles that reach its
// band ([q0 - W + 1, q0 + 127]); a warp skips the math of a tile that lies
// wholly outside its own 16 rows' band, and masks only the tiles that cut
// the band's edges. A row may see no key of a tile it takes part in, so
// the running maximum starts at -inf and the softmax shifts by 0 while it
// is -inf. It shares K4's Q fragments, tile products, online softmax and
// epilogue (q_fragments, tile_scores, softmax_step, pv_products,
// store_rows).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 64;            // head size
constexpr int WARPS = 8;          // warps a block, 16 query rows each
constexpr int NT = WARPS * 32;    // threads a block
constexpr int BQ = 16 * WARPS;    // query rows a block
constexpr int BK = 64;            // keys a tile
constexpr int LDK = DH + 16;      // K row: float4 fragment reads hit distinct banks
constexpr int LDV = DH + 4;       // V row: the scalar fragment reads hit distinct banks
constexpr int LDQ = DH + 4;       // staged Q row
constexpr int TILE = BK * (LDK + LDV);  // floats of one K and V buffer
constexpr unsigned FULL = 0xffffffffu;

static_assert(BQ * LDQ <= TILE, "the Q tile is staged in the second K/V buffer");

size_t smem_bytes(int pos_ld) {
  // K/V [2][TILE]; kbias [2][BK]; pos [BQ][pos_ld]
  return (size_t)(2 * TILE + 2 * BK + BQ * pos_ld) * sizeof(float);
}

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

// rows [r0, r0 + ROWS) of a [T, 64] f32 matrix into shared rows of LD
// floats, rows >= T as zeros
template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int T) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * (DH / 4); c += NT) {
    const int r = c / (DH / 4), col = (c % (DH / 4)) * 4;
    const bool valid = r0 + r < T;
    cp_async16(smem_addr(dst + r * LD + col), src + (size_t)(valid ? r0 + r : 0) * DH + col, valid);
  }
}

// x rounded to a TF32 value (round to nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo
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

// The Q tile's rows of a warp as A fragments, split once into hi and lo:
// k-step 2j + h takes dims 16j + 4t + 2h (slot t) and 16j + 4t + 2h + 1
// (slot t + 4) of rows g and g + 8
__device__ __forceinline__ void q_fragments(const float* qs, int warp, int g, int t,
                                            uint32_t (&qh)[8][4], uint32_t (&ql)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(qs + (warp * 16 + g) * LDQ + 16 * j + 4 * t);
    const float4 y =
        *reinterpret_cast<const float4*>(qs + (warp * 16 + g + 8) * LDQ + 16 * j + 4 * t);
    split(x.x, qh[2 * j][0], ql[2 * j][0]);
    split(y.x, qh[2 * j][1], ql[2 * j][1]);
    split(x.y, qh[2 * j][2], ql[2 * j][2]);
    split(y.y, qh[2 * j][3], ql[2 * j][3]);
    split(x.z, qh[2 * j + 1][0], ql[2 * j + 1][0]);
    split(y.z, qh[2 * j + 1][1], ql[2 * j + 1][1]);
    split(x.w, qh[2 * j + 1][2], ql[2 * j + 1][2]);
    split(y.w, qh[2 * j + 1][3], ql[2 * j + 1][3]);
  }
}

// s = Q K^T over a tile's 64 keys (K rows in shared memory, LDK apart):
// n-tile n holds keys n*8 + 2t, + 1
__device__ __forceinline__ void tile_scores(const float* ks, int g, int t,
                                            const uint32_t (&qh)[8][4],
                                            const uint32_t (&ql)[8][4], float (&s)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    // each term across the 8 n-tiles before the next: consecutive mma.sync
    // are independent
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 b = *reinterpret_cast<const float2*>(ks + (n * 8 + g) * LDK + 16 * jj + 4 * t + 2 * h);
        split(b.x, bh[n][0], bl[n][0]);
        split(b.y, bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) mma_tf32(s[n], ql[2 * jj + h], bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < 8; ++n) mma_tf32(s[n], qh[2 * jj + h], bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < 8; ++n) mma_tf32(s[n], qh[2 * jj + h], bh[n][0], bh[n][1]);
    }
  }
}

// One step of the online softmax over rows g (e = 0, 1) and g + 8 (e = 2,
// 3): the rows' maxima across the quad, l and o rescaled, and the shift
// that the tile's probabilities take. EMPTY: a row may have seen no key
// yet (its maximum -inf); it then shifts by 0.
template <bool EMPTY>
__device__ __forceinline__ void softmax_step(const float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&o)[8][4], float (&shift)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    shift[i] = (EMPTY && mx[i] == -CUDART_INF_F) ? 0.f : mx[i];
    const float alpha = expf(m[i] - shift[i]);
    m[i] = mx[i];
    l[i] *= alpha;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][2 * i] *= alpha;
      o[n][2 * i + 1] *= alpha;
    }
  }
}

// o += P V with P = exp(s - shift), and P's row sums into this thread's l:
// k-step n takes keys n*8 + 2t (slot t) and n*8 + 2t + 1 (slot t + 4), the
// C fragment's columns (V rows in shared memory, LDV apart)
__device__ __forceinline__ void pv_products(const float* vs, int g, int t, const float (&s)[8][4],
                                            const float (&shift)[2], float (&l)[2],
                                            float (&o)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float p0 = expf(s[n][0] - shift[0]), p1 = expf(s[n][1] - shift[0]);
    const float p2 = expf(s[n][2] - shift[1]), p3 = expf(s[n][3] - shift[1]);
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    uint32_t ph[4], pl[4];
    split(p0, ph[0], pl[0]);
    split(p2, ph[1], pl[1]);
    split(p1, ph[2], pl[2]);
    split(p3, ph[3], pl[3]);
    const float* v0 = vs + (n * 8 + 2 * t) * LDV + g;
    uint32_t vh[8][2], vl[8][2];
#pragma unroll
    for (int dd = 0; dd < 8; ++dd) {
      split(v0[dd * 8], vh[dd][0], vl[dd][0]);
      split(v0[LDV + dd * 8], vh[dd][1], vl[dd][1]);
    }
#pragma unroll
    for (int dd = 0; dd < 8; ++dd) mma_tf32(o[dd], pl, vh[dd][0], vh[dd][1]);
#pragma unroll
    for (int dd = 0; dd < 8; ++dd) mma_tf32(o[dd], ph, vl[dd][0], vl[dd][1]);
#pragma unroll
    for (int dd = 0; dd < 8; ++dd) mma_tf32(o[dd], ph, vh[dd][0], vh[dd][1]);
  }
}

// The epilogue: the row sums across the quad, o / max(l, 1e-30) written
// for rows r and r + 8 below T
__device__ __forceinline__ void store_rows(float* dst_rows, int r, int T, int t, float (&l)[2],
                                           const float (&o)[8][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (r + 8 * i < T) {
      float* dst = dst_rows + (size_t)(r + 8 * i) * DH + 2 * t;
#pragma unroll
      for (int dd = 0; dd < 8; ++dd)
        *reinterpret_cast<float2*>(dst + dd * 8) =
            make_float2(o[dd][2 * i] * inv, o[dd][2 * i + 1] * inv);
    }
  }
}

// PRESCALED: q comes multiplied by dh^-0.5 already (K5's f32 path), and the
// scores are not scaled again; else they are scaled by 0.125, exactly.
template <bool PRESCALED>
__global__ void __launch_bounds__(WARPS * 32, 1)
flash_attention_relkey_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ E,
                              const float* __restrict__ mask, float* __restrict__ out,
                              int H, int T, int P, int left, int pos_ld) {
  extern __shared__ __align__(16) float smem[];
  float* kv = smem;                 // [2][TILE]: K [BK][LDK], then V [BK][LDV]
  float* kbias = kv + 2 * TILE;     // [2][BK] padding bias of the tile's keys
  float* pos = kbias + 2 * BK;      // [BQ][pos_ld] q_tile E^T
  float* qs = kv + TILE;            // [BQ][LDQ] the Q tile, until tile 1 arrives

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int qw = q0 + warp * 16;    // the warp's first row
  const size_t base = (size_t)blockIdx.y * T * DH;
  const float* mrow = mask ? mask + (size_t)(blockIdx.y / H) * T : nullptr;
  const int ntiles = (T + BK - 1) / BK;

  auto load_tile = [&](int j) {
    float* kt = kv + (j & 1) * TILE;
    load_rows<BK, LDK>(kt, k + base, j * BK, T);
    load_rows<BK, LDV>(kt + BK * LDK, v + base, j * BK, T);
    if (tid < BK) {
      const int kg = j * BK + tid;
      kbias[(j & 1) * BK + tid] = (mrow && kg < T) ? (1.f - mrow[kg]) * -FLT_MAX : 0.f;
    }
  };

  load_rows<BQ, LDQ>(qs, q + base, q0, T);
  load_tile(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int e = tid; e < BQ * P; e += NT) {  // pos = q_tile E^T in f32 FMAs
    const int r = e % BQ, p = e / BQ;
    const float* ep = E + (size_t)p * DH;
    const float4* qr = reinterpret_cast<const float4*>(qs + r * LDQ);
    float acc = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 a = qr[d4];
      acc = fmaf(a.x, __ldg(ep + 4 * d4), acc);
      acc = fmaf(a.y, __ldg(ep + 4 * d4 + 1), acc);
      acc = fmaf(a.z, __ldg(ep + 4 * d4 + 2), acc);
      acc = fmaf(a.w, __ldg(ep + 4 * d4 + 3), acc);
    }
    pos[r * pos_ld + p] = acc;
  }

  uint32_t qh[8][4], ql[8][4];
  q_fragments(qs, warp, g, t, qh, ql);
  __syncthreads();  // pos is written; every warp has read Q out of buffer 1

  float pos_l[2] = {0.f, 0.f}, pos_r[2] = {0.f, 0.f};  // rows g and g + 8
  if (P > 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pos_l[i] = pos[(warp * 16 + g + 8 * i) * pos_ld];
      pos_r[i] = pos[(warp * 16 + g + 8 * i) * pos_ld + P - 1];
    }
  }

  float o[8][4];  // output: 8 n-tiles of 8 dims; [0..1] row g, [2..3] row g + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < ntiles) {  // the next tile's copy overlaps this tile's math
      load_tile(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kv + (j & 1) * TILE;
    const float* vs = ks + BK * LDK;
    const float* kb = kbias + (j & 1) * BK;

    float s[8][4];
    tile_scores(ks, g, t, qh, ql, s);

    if (P > 0) {
      // the band is k - q + left in [0, P - 1]; d covers the warp's pairs
      const int d_lo = k0 - (qw + 15) + left, d_hi = k0 + BK - 1 - qw + left;
      if (d_hi <= 0 || d_lo >= P - 1) {
        const float c0 = d_hi <= 0 ? pos_l[0] : pos_r[0];
        const float c1 = d_hi <= 0 ? pos_l[1] : pos_r[1];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[n][0] += c0;
          s[n][1] += c0;
          s[n][2] += c1;
          s[n][3] += c1;
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = warp * 16 + g + 8 * (e >> 1);
            const int d = k0 + n * 8 + 2 * t + (e & 1) - (q0 + r) + left;
            s[n][e] += pos[r * pos_ld + min(max(d, 0), P - 1)];
          }
      }
    }
    constexpr float scale = PRESCALED ? 1.f : 0.125f;  // dh^-0.5
    const bool ragged = k0 + BK > T;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bias = *reinterpret_cast<const float2*>(kb + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e] * scale + ((e & 1) ? bias.y : bias.x);
        s[n][e] = (ragged && k0 + n * 8 + 2 * t + (e & 1) >= T) ? -CUDART_INF_F : x;
      }
    }

    float shift[2];  // the new maximum: finite, since every tile has a key < T
    softmax_step<false>(s, m, l, o, shift);
    pv_products(vs, g, t, s, shift, l, o);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  store_rows(out + base, qw + g, T, t, l, o);
}

// Mimi's window: causal, key k visible to query q iff q - W < k <= q.
// grid (query tiles of BQ, BH); q unscaled, the scores scaled by 0.125
__global__ void __launch_bounds__(WARPS * 32, 1)
flash_attention_window_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out, int T,
                              int W) {
  extern __shared__ __align__(16) float smem[];
  float* kv = smem;        // [2][TILE]: K [BK][LDK], then V [BK][LDV]
  float* qs = kv + TILE;   // [BQ][LDQ] the Q tile, until the second key tile arrives

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int qw = q0 + warp * 16;  // the warp's first row
  const size_t base = (size_t)blockIdx.y * T * DH;
  // the key tiles that reach the block's band, and the warp's own keys
  const int j0 = max(0, q0 - W + 1) / BK, j1 = (min(T, q0 + BQ) - 1) / BK;
  const int wlo = qw - W + 1, whi = qw + 15;

  auto load_tile = [&](int j) {
    float* kt = kv + ((j - j0) & 1) * TILE;
    load_rows<BK, LDK>(kt, k + base, j * BK, T);
    load_rows<BK, LDV>(kt + BK * LDK, v + base, j * BK, T);
  };

  load_rows<BQ, LDQ>(qs, q + base, q0, T);
  load_tile(j0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qh[8][4], ql[8][4];
  q_fragments(qs, warp, g, t, qh, ql);
  __syncthreads();  // every warp has read Q out of buffer 1

  float o[8][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = j0; j <= j1; ++j) {
    const int k0 = j * BK;
    if (j < j1) {
      load_tile(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (k0 <= whi && k0 + BK - 1 >= wlo) {  // the tile reaches the warp's band
      const float* ks = kv + ((j - j0) & 1) * TILE;
      const float* vs = ks + BK * LDK;

      float s[8][4];
      tile_scores(ks, g, t, qh, ql, s);

      // every key of the tile inside every row's band, or a mask a pair
      const bool edge = !(k0 + BK - 1 <= qw && k0 > whi - W);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1), row = qw + g + 8 * (e >> 1);
          const float x = s[n][e] * 0.125f;  // dh^-0.5
          s[n][e] = (edge && (key > row || key <= row - W)) ? -CUDART_INF_F : x;
        }

      float shift[2];  // 0 while a row has seen no key
      softmax_step<true>(s, m, l, o, shift);
      pv_products(vs, g, t, s, shift, l, o);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  store_rows(out + base, qw + g, T, t, l, o);
}

template <bool PRESCALED>
int launch(const float* q, const float* k, const float* v, const float* E, const float* mask,
           float* out, int BH, int H, int T, int P, int left, void* stream) {
  const int pos_ld = P > 0 ? (P | 1) : 0;  // odd: the pos stores do not conflict
  const size_t smem = smem_bytes(pos_ld);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_relkey_kernel<PRESCALED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, BH);
  flash_attention_relkey_kernel<PRESCALED>
      <<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, E, mask, out, H, T, P,
                                                              left, pos_ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out [BH, T, 64] f32 (BH = batch x H heads); E [P, 64] f32 with
// P = left + right + 1, or null with P = 0 (no rel term); mask [batch, T]
// f32, or null (no padding bias).
extern "C" int flash_attention_relkey_f32(const float* q, const float* k, const float* v,
                                          const float* E, const float* mask, float* out,
                                          int BH, int H, int T, int P, int left,
                                          void* stream) {
  return launch<false>(q, k, v, E, mask, out, BH, H, T, P, left, stream);
}

// K5's f32 path (csrc/flash_attention_bf16.cu has its bf16 path): the same
// kernel with no rel term, no mask and q pre-scaled, softmax(q k^T) v.
// q, k, v, out [BH, T, 64] f32.
extern "C" int flash_attention_plain_f32(const float* q, const float* k, const float* v,
                                         float* out, int BH, int T, void* stream) {
  return launch<true>(q, k, v, nullptr, nullptr, out, BH, 1, T, 0, 0, stream);
}

// Mimi's windowed causal attention: q, k, v, out [BH, T, 64] f32, q
// unscaled; key k visible to query q iff q - W < k <= q (W >= 1).
extern "C" int flash_attention_window_f32(const float* q, const float* k, const float* v,
                                          float* out, int BH, int T, int W, void* stream) {
  if (BH < 1 || T < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)2 * TILE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_window_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, BH);
  flash_attention_window_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, out,
                                                                                     T, W);
  return static_cast<int>(cudaGetLastError());
}
