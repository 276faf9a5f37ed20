// K5 and K4 in bf16: non-causal attention on the bf16 tensor cores, one
// kernel in two instantiations.
//
// K5 (flash_attention_plain_bf16, TERMS = false) replaces
// audiotoken_tpu/ops/flash_attention.py:_flash_attention_plain (Pallas
// kernels `_kernel_onepass`, reached through the pallas_call at :287 for
// T <= 1024, and `_kernel_plain`, the tiled form at :309; both compute the
// same function) for bf16 inputs. No bias, no mask, q pre-scaled:
//
//   s = q . k (f32), p = exp(s - max_k s) (f32), l = sum_k p (f32),
//   out[q] = bf16((sum_k bf16(p) v[k]) / max(l, 1e-30))
//
// Bark-fine calls it at [B, 16, 1024, 64] bf16, 24 layers x 6 codebook
// passes per window. K5's f32 path, the IEEE parity path of the decode
// goldens, is K4's 3xTF32 kernel with neither term (flash_attention_plain_f32
// in csrc/flash_attention.cu).
//
// K4 in bf16 (flash_attention_relkey_bf16, TERMS = true) replaces
// audiotoken_tpu/ops/flash_attention.py:flash_attention_relkey (Pallas
// kernel `_kernel`, the pallas_call at :519) for bf16 q, k and v: there the
// compute type follows the input, so q k^T and q E^T take bf16 operands (E
// rounded to bf16) with f32 accumulation, the scores, the softmax and the
// row sums stay f32, and p is rounded to bf16 before the value product:
//
//   s[q, k]   = (q . k + rel[q, k]) * dh^-0.5 + (1 - mask[k]) * (-FLT_MAX)
//   rel[q, k] = pos[q, clamp(k - q + left, 0, P - 1)],   pos = q E^T
//
// and p, l and out as K5's. The rel term is dropped when E is null (P = 0),
// the padding term when the mask is null; a fully masked row gets -FLT_MAX
// on every key and so a uniform average over its T keys, as K4's f32 kernel
// (csrc/flash_attention.cu) and the plain version give. The form with
// neither term and T a multiple of 256 is K5's, which the wrapper launches
// instead, as the JAX package dispatches it. dh = 64 in both.
//
// What bounds them on this card: 4 x T^2 x dh FLOPs per (batch, head), plus
// 2 x T x P x dh for the rel term, on the 989 TFLOP/s of the bf16 tensor
// cores: 0.0347 ms for K5 at [8, 16, 1024, 64], 0.076 ms for K4 at
// [8, 16, 1500, 64] with P = 73; their bytes (q, k, v, out) are below that.
// The design, FlashAttention-2's on mma.sync:
//   * one block per (batch*head, 128 query rows), 8 warps; each warp owns
//     16 query rows, whose Q tile it loads once with ldmatrix into the A
//     fragments of mma.sync.m16n8k16 (bf16 in, f32 accumulators). 128 rows
//     a block read each head's K and V from L2 half as often as 64 rows and
//     4 warps, and measured a little faster on the H100 (PERF.md). At
//     128 registers a thread two blocks share an SM; one register more
//     leaves one, which measured slower, so the launch bounds hold it;
//   * K and V stream through shared memory 64 keys at a time, double
//     buffered with 16-byte cp.async, so the next tile's copy overlaps this
//     tile's math (K4: beside the tile's 64 padding biases in f32). Rows are
//     padded to 144 bytes: the eight 16-byte rows an ldmatrix phase reads
//     fall on distinct banks (plain ldmatrix for K, .trans for V);
//   * S = Q K^T is 8 n-tiles x 4 k-steps of mma.sync a warp a tile, into 32
//     f32 registers a thread;
//   * K4's rel term: pos = q_tile E^T [128, P] is computed once per block in
//     f32 FMAs of the bf16 values (exact products, f32 sums) into shared
//     memory. A key tile wholly left of a warp's band (k - q + left <= 0 for
//     every pair) adds the row's pos[r][0], one wholly right of it
//     pos[r][P - 1]; only tiles that cross the band gather at the clamped
//     distance. Then the scale and the padding bias, in f32;
//   * the online softmax runs in the accumulator registers: a row's maximum
//     combines across the 4 threads of a quad with __shfl_xor_sync; keys
//     >= T are -inf before it. K5's p = exp2f(s * log2e - m * log2e), the
//     argument one fmaf: against f32 exp(s - m) that is a relative error of
//     about (|s| + |m|) x 2^-24 plus exp2f's 2 ulp, under 1e-5 for scores
//     below 64, against the 2^-9 of p's rounding to bf16. K4 takes expf(s -
//     m): a masked score near -FLT_MAX times log2e would overflow. l sums the
//     unrounded f32 p, per thread, combined across the quad once at the end;
//   * p is rounded to bf16 pairs in registers and is the A operand of PV
//     directly: the m16n8 C fragment of S has the layout of the m16n8k16 A
//     fragment, so P never touches shared memory. PV is 8 n-tiles (dh) x 4
//     k-steps (keys);
//   * the epilogue divides by max(l, 1e-30) (K5: multiplies by its
//     reciprocal), rounds to bf16 and stores; rows >= T are not written.
// wgmma with TMA loads and warp specialisation is the next step.
//
// K8 in bf16 (attn_ablation_bf16) replaces the two Pallas kernels of
// scripts/profile_attn_micro.py: `ablation_kernel` (`run_ablation`, the
// pallas_call at :108) and `onepass_kernel` (`run_onepass`, :157). They
// are K5's kernel with one part taken out, so that K5's time minus an
// ablation's is what that part costs in K5 (not valid attention; their
// function is ops/attn_ablation.py:attn_ablation_plain's):
//   full      K5's own instantiation (MODE_FULL, 64 keys a step);
//   noexp     p = s - m' in place of exp2, l = l alpha + rowsum(p), the
//             accumulator not rescaled by alpha;
//   dotsonly  both products, p = bf16(s 1e-6) and l gains 1 a tile: no
//             softmax;
//   onepass   an exact softmax over whole key rows from the same blocks
//             (cp.async into padded rows, ldmatrix, mma.sync m16n8k16), in
//             a kernel of its own (attn_onepass_bf16_kernel, below).
// noexp and dotsonly also take 128 keys a recurrence step: S of both
// 64-key halves is taken before m', 64 score registers a thread, so those
// two instantiations run one block an SM and measure that change too.
// What bounds them is K5's bound at [16, 16, 1024, 64]: 68.7 GFLOP on the
// bf16 tensor cores, 0.0695 ms; onepass reads K and V once per 16 or 32
// query rows, 4.3 or 2.1 GB from L2 at that shape.

#include <cfloat>
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
// rows >= T as zeros, by a block of THREADS threads
template <int ROWS, int THREADS = NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int T_len) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * (DH / 8); c += THREADS) {
    const int r = c / (DH / 8), col = (c % (DH / 8)) * 8;
    const bool valid = r0 + r < T_len;
    cp_async16(smem_addr(dst + r * LDS + col), src + (size_t)(valid ? r0 + r : 0) * DH + col,
               valid);
  }
}

// Q [BQ][LDS], K and V [2][KT][LDS] each (bf16); K4 adds kbias [2][BK] and
// pos [BQ][pos_ld] (f32)
template <int KT>
constexpr size_t qkv_smem_bytes() {
  return (size_t)(BQ + 4 * KT) * LDS * sizeof(bf16);
}

// The softmax step of each key tile (K8's modes; ops/attn_ablation.py numbers
// them so): MODE_FULL is K5's and K4's, the others take a part of it out.
constexpr int MODE_NOEXP = 0, MODE_DOTSONLY = 1, MODE_ONEPASS = 2, MODE_FULL = 3;

// TERMS = false: K5 (q pre-scaled, no rel term, no mask; E, mask, H, P,
// left and pos_ld unused). TERMS = true: K4, with the rel term when P > 0
// and the padding bias when mask is not null. MODE and KT (keys a
// recurrence step) are MODE_FULL and BK for both; K8's ablations instantiate the
// kernel without K4's terms at another MODE, and at KT = 128, whose 64
// score registers a thread leave room for one block an SM.
template <bool TERMS, int MODE, int KT>
__global__ void __launch_bounds__(NT, KT == BK ? 2 : 1)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ E,
                      const float* __restrict__ mask, bf16* __restrict__ out, int H, int T_len,
                      int P, int left, int pos_ld) {
  static_assert(!TERMS || (MODE == MODE_FULL && KT == BK), "K4's terms take K5's softmax step");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [BQ][LDS]
  bf16* sk = sq + BQ * LDS;                  // [2][KT][LDS]
  bf16* sv = sk + 2 * KT * LDS;              // [2][KT][LDS]
  float* kbias = reinterpret_cast<float*>(sv + 2 * KT * LDS);  // [2][BK] (K4)
  float* pos = kbias + 2 * BK;                                  // [BQ][pos_ld] (K4)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3;  // the 8 x 8 matrix of an ldmatrix.x4 whose row this lane addresses
  const int q0 = blockIdx.x * BQ;
  const int qw = q0 + warp * 16;  // the warp's first row
  const size_t base = (size_t)blockIdx.y * T_len * DH;
  const float* mrow = (TERMS && mask) ? mask + (size_t)(blockIdx.y / H) * T_len : nullptr;
  const int ntiles = (T_len + KT - 1) / KT;

  auto load_kv = [&](int j) {
    load_tile<KT>(sk + (j & 1) * KT * LDS, k + base, j * KT, T_len);
    load_tile<KT>(sv + (j & 1) * KT * LDS, v + base, j * KT, T_len);
    if constexpr (TERMS) {
      if (tid < BK) {
        const int kg = j * BK + tid;
        kbias[(j & 1) * BK + tid] = (mrow && kg < T_len) ? (1.f - mrow[kg]) * -FLT_MAX : 0.f;
      }
    }
  };
  uint32_t qa[4][4];  // A fragments of the warp's 16 query rows, 4 k-steps of 16 dims
  auto load_q_fragments = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(qa[kk], smem_addr(sq + (warp * 16 + (mat & 1) * 8 + (lane & 7)) * LDS +
                                    kk * 16 + (mat >> 1) * 8));
  };

  load_tile<BQ>(sq, q + base, q0, T_len);
  load_kv(0);
  cp_async_commit();

  if constexpr (TERMS) {
    cp_async_wait<0>();
    __syncthreads();
    // pos = q_tile E^T: thread e takes row e % BQ, distance e / BQ
    for (int e = tid; e < BQ * P; e += NT) {
      const int r = e % BQ, p = e / BQ;
      const uint4* qr = reinterpret_cast<const uint4*>(sq + r * LDS);
      const uint4* er = reinterpret_cast<const uint4*>(E + (size_t)p * DH);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        const uint4 a = qr[c];
        const uint4 b = __ldg(er + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
      pos[r * pos_ld + p] = acc;
    }
    load_q_fragments();
    __syncthreads();  // pos is written
  }

  float o[8][4];  // output: 8 n-tiles of 8 dims; [0..1] row g, [2..3] row g + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8
  float l[2] = {0.f, 0.f};                      // this thread's share of the row sums
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * KT;
    if (j + 1 < ntiles) {  // the next tile's copy overlaps this tile's math
      load_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (!TERMS) {
      if (j == 0) load_q_fragments();
    }
    const bf16* kt = sk + (j & 1) * KT * LDS;
    const bf16* vt = sv + (j & 1) * KT * LDS;

    // S = Q K^T over the tile's KT keys: n-tile n holds keys n*8 + 2t, + 1
    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {  // two n-tiles of 8 keys
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(kt + (np * 16 + (mat >> 1) * 8 + (lane & 7)) * LDS + kk * 16 +
                                 (mat & 1) * 8));
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    if constexpr (TERMS) {
      if (P > 0) {
        // the band is k - q + left in [0, P - 1]; d covers the warp's pairs
        const int d_lo = k0 - (qw + 15) + left, d_hi = k0 + BK - 1 - qw + left;
        if (d_hi <= 0 || d_lo >= P - 1) {
          const int col = d_hi <= 0 ? 0 : P - 1;
          const float c0 = pos[(warp * 16 + g) * pos_ld + col];
          const float c1 = pos[(warp * 16 + g + 8) * pos_ld + col];
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
      const float* kb = kbias + (j & 1) * BK;
      const bool ragged = k0 + BK > T_len;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 bias = *reinterpret_cast<const float2*>(kb + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e] * 0.125f + ((e & 1) ? bias.y : bias.x);  // dh^-0.5
          s[n][e] = (ragged && k0 + n * 8 + 2 * t + (e & 1) >= T_len) ? -CUDART_INF_F : x;
        }
      }
    } else if (k0 + KT > T_len) {  // the ragged last tile: keys >= T leave the softmax
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + 2 * t + (e & 1) >= T_len) s[n][e] = -CUDART_INF_F;
    }

    uint32_t pa[KT / 16][4];  // P as the A fragments of PV: KT / 16 k-steps of 16 keys
    if constexpr (MODE == MODE_DOTSONLY) {
      // no softmax: p = bf16(s * 1e-6) keeps PV's dependence on S; each row's l
      // gains 1 a tile, from one thread of its quad (the quad's sum is l)
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        pa[n >> 1][(n & 1) * 2] = pack_bf16(s[n][0] * 1e-6f, s[n][1] * 1e-6f);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2] * 1e-6f, s[n][3] * 1e-6f);
      }
      if (t == 0) {
        l[0] += 1.f;
        l[1] += 1.f;
      }
    } else {
      // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float mb[2];  // K5: the running maximum times log2e
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        // finite: every tile holds a key < T
        const float alpha = TERMS ? expf(m[i] - mx[i]) : exp2f((m[i] - mx[i]) * LOG2E);
        m[i] = mx[i];
        mb[i] = mx[i] * LOG2E;
        l[i] *= alpha;
        if constexpr (MODE == MODE_FULL) {  // noexp: the accumulator keeps its scale
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            o[n][2 * i] *= alpha;
            o[n][2 * i + 1] *= alpha;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = MODE == MODE_NOEXP ? s[n][e] - m[e >> 1]  // noexp: the identity in place of exp
                 : TERMS            ? expf(s[n][e] - m[e >> 1])
                                    : exp2f(fmaf(s[n][e], LOG2E, -mb[e >> 1]));
        l[0] += p[0] + p[1];  // the unrounded p
        l[1] += p[2] + p[3];
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
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

  const int r = qw + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const float den = fmaxf(l[i], 1e-30f), inv = 1.f / den;
    if (r + 8 * i < T_len) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + base + (size_t)(r + 8 * i) * DH + 2 * t);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        dst[n * 4] = TERMS ? pack_bf16(o[n][2 * i] / den, o[n][2 * i + 1] / den)
                           : pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

// K8's onepass: an exact softmax over whole key rows (no m / l recurrence),
// R = 16 or 32 query rows a block, W = R / 4 warps; T <= 1024, a multiple
// of 64. K and then V stream through a ring of two stages of 32 W keys; in
// each stage warp w takes keys [32 w, 32 w + 32). S = Q K^T goes into f32
// score rows in shared memory; 8 threads a row take its maximum, p =
// exp2(s log2e - m log2e) in place and l; P V reads P from those rows,
// rounded to bf16 pairs as A fragments, each warp's partial O in registers;
// the W partials are summed in warp order through shared memory.
template <int R>
__host__ __device__ constexpr int onepass_warps() {
  return R / 4;
}
constexpr int ONEPASS_RLD = DH + 8;  // row of a warp's partial O, f32

template <int R>
size_t onepass_smem_bytes(int T_len) {
  constexpr int W = onepass_warps<R>();
  const size_t scores = (size_t)R * (T_len + 8), partials = (size_t)W * R * ONEPASS_RLD;
  return (size_t)(R + 2 * 32 * W) * LDS * sizeof(bf16) + R * sizeof(float) +
         (scores > partials ? scores : partials) * sizeof(float);
}

template <int R>
__global__ void __launch_bounds__(R * 8, R == 16 ? 2 : 1)
attn_onepass_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out, int T_len) {
  constexpr int W = onepass_warps<R>(), THREADS = 32 * W, KS = 32 * W;  // KS: keys a stage
  constexpr int MT = R / 16;                                            // m16 row tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);                // [R][LDS]
  bf16* ring = sq + R * LDS;                               // [2][KS][LDS]: K, then V
  float* lrow = reinterpret_cast<float*>(ring + 2 * KS * LDS);  // [R]
  float* S = lrow + R;  // [R][T + 8] scores, then p; at the end [W][R][ONEPASS_RLD] partials
  // T + 8 = 8 (mod 32) words: the float2 accesses of a fragment's rows g
  // and columns 2t fall on distinct banks
  const int lds = T_len + 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3;
  const int q0 = blockIdx.x * R;
  const size_t base = (size_t)blockIdx.y * T_len * DH;
  const int nst = (T_len + KS - 1) / KS;  // stages of each product

  // stage i < nst: keys [i KS, (i + 1) KS) of K; then the same of V
  auto load_stage = [&](int i) {
    load_tile<KS, THREADS>(ring + (i & 1) * KS * LDS, (i < nst ? k : v) + base, (i % nst) * KS,
                           T_len);
  };
  load_tile<R, THREADS>(sq, q + base, q0, T_len);
  load_stage(0);
  cp_async_commit();

  // 1. S = Q K^T into the score rows
  uint32_t qa[MT][4][4];
  for (int i = 0; i < nst; ++i) {
    load_stage(i + 1);  // V's first stage overlaps the last of K and the softmax
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(qa[mt][kk], smem_addr(sq + (mt * 16 + (mat & 1) * 8 + (lane & 7)) * LDS +
                                            kk * 16 + (mat >> 1) * 8));
    }
    const int kw = i * KS + warp * 32;  // T % 64 == 0: a warp's 32 keys are all < T or none
    if (kw < T_len) {
      const bf16* kt = ring + (i & 1) * KS * LDS + warp * 32 * LDS;
      float s[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(kt + (np * 16 + (mat >> 1) * 8 + (lane & 7)) * LDS + kk * 16 +
                                   (mat & 1) * 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], qa[mt][kk], b[0], b[1]);
            mma_bf16(s[mt][2 * np + 1], qa[mt][kk], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float* dst = S + (mt * 16 + g) * lds + kw + n * 8 + 2 * t;
          *reinterpret_cast<float2*>(dst) = make_float2(s[mt][n][0], s[mt][n][1]);
          *reinterpret_cast<float2*>(dst + 8 * lds) = make_float2(s[mt][n][2], s[mt][n][3]);
        }
    }
    __syncthreads();
  }

  // 2. each row's maximum, p in place (f32, unrounded) and l = sum(p)
  {
    const int r = tid >> 3, u = tid & 7;
    float* row = S + r * lds;
    float mx = -CUDART_INF_F;
    for (int c = u * 4; c < T_len; c += 32) {
      const float4 x = *reinterpret_cast<const float4*>(row + c);
      mx = fmaxf(mx, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float mb = mx * LOG2E;
    float sum = 0.f;
    for (int c = u * 4; c < T_len; c += 32) {
      float4 x = *reinterpret_cast<const float4*>(row + c);
      x.x = exp2f(fmaf(x.x, LOG2E, -mb));
      x.y = exp2f(fmaf(x.y, LOG2E, -mb));
      x.z = exp2f(fmaf(x.z, LOG2E, -mb));
      x.w = exp2f(fmaf(x.w, LOG2E, -mb));
      sum += (x.x + x.y) + (x.z + x.w);
      *reinterpret_cast<float4*>(row + c) = x;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(FULL, sum, off);
    if (u == 0) lrow[r] = sum;
  }
  __syncthreads();

  // 3. O = P V, each warp over its keys of every stage
  float o[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  for (int i = nst; i < 2 * nst; ++i) {
    if (i + 1 < 2 * nst) {
      load_stage(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kw = (i - nst) * KS + warp * 32;
    if (kw < T_len) {
      const bf16* vt = ring + (i & 1) * KS * LDS + warp * 32 * LDS;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[MT][4];  // p rounded to bf16 pairs: rows g, g + 8; keys 2t, 2t + 8
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* p0 = S + (mt * 16 + g) * lds + kw + kk * 16 + 2 * t;
          const float2 a0 = *reinterpret_cast<const float2*>(p0);
          const float2 a1 = *reinterpret_cast<const float2*>(p0 + 8 * lds);
          const float2 a2 = *reinterpret_cast<const float2*>(p0 + 8);
          const float2 a3 = *reinterpret_cast<const float2*>(p0 + 8 * lds + 8);
          pa[mt][0] = pack_bf16(a0.x, a0.y);
          pa[mt][1] = pack_bf16(a1.x, a1.y);
          pa[mt][2] = pack_bf16(a2.x, a2.y);
          pa[mt][3] = pack_bf16(a3.x, a3.y);
        }
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(vt + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * LDS +
                                         dp * 16 + (mat >> 1) * 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * dp], pa[mt], b[0], b[1]);
            mma_bf16(o[mt][2 * dp + 1], pa[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the last one also ends every read of P before the partials overwrite it
  }

  // 4. the warps' partial O, summed in warp order; out = bf16(O / l)
  float* part = S;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* dst = part + (warp * R + mt * 16 + g) * ONEPASS_RLD + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst) = make_float2(o[mt][n][0], o[mt][n][1]);
      *reinterpret_cast<float2*>(dst + 8 * ONEPASS_RLD) = make_float2(o[mt][n][2], o[mt][n][3]);
    }
  __syncthreads();
  {
    const int r = tid >> 3, c = (tid & 7) * 8;  // 8 threads a row, 8 dims each
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* src = part + (w * R + r) * ONEPASS_RLD + c;
      const float4 x = *reinterpret_cast<const float4*>(src);
      const float4 y = *reinterpret_cast<const float4*>(src + 4);
      acc[0] += x.x;
      acc[1] += x.y;
      acc[2] += x.z;
      acc[3] += x.w;
      acc[4] += y.x;
      acc[5] += y.y;
      acc[6] += y.z;
      acc[7] += y.w;
    }
    const float inv = 1.f / fmaxf(lrow[r], 1e-30f);
    uint4 packed;
    packed.x = pack_bf16(acc[0] * inv, acc[1] * inv);
    packed.y = pack_bf16(acc[2] * inv, acc[3] * inv);
    packed.z = pack_bf16(acc[4] * inv, acc[5] * inv);
    packed.w = pack_bf16(acc[6] * inv, acc[7] * inv);
    *reinterpret_cast<uint4*>(out + base + (size_t)(q0 + r) * DH + c) = packed;
  }
}

template <bool TERMS, int MODE, int KT>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* E, const float* mask,
           bf16* out, int BH, int H, int T_len, int P, int left, int pos_ld, void* stream) {
  const size_t smem =
      qkv_smem_bytes<KT>() + (TERMS ? (size_t)(2 * BK + BQ * pos_ld) * sizeof(float) : 0);
  auto kernel = attention_bf16_kernel<TERMS, MODE, KT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + BQ - 1) / BQ, BH);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, E, mask, out, H, T_len,
                                                               P, left, pos_ld);
  return static_cast<int>(cudaGetLastError());
}

// K8's ablations: K5's kernel at another MODE and KT, without K4's terms
template <int MODE, int KT>
int launch_ablation(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int T_len,
                    void* stream) {
  return launch<false, MODE, KT>(q, k, v, nullptr, nullptr, out, BH, 1, T_len, 0, 0, 0, stream);
}

template <int R>
int launch_onepass(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int T_len,
                   void* stream) {
  auto kernel = attn_onepass_bf16_kernel<R>;
  const size_t smem = onepass_smem_bytes<R>(T_len);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(T_len / R, BH), 32 * onepass_warps<R>(), smem,
           static_cast<cudaStream_t>(stream)>>>(q, k, v, out, T_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5: q (pre-scaled), k, v, out [BH, T, 64] bf16, contiguous.
extern "C" int flash_attention_plain_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                          int BH, int T, void* stream) {
  return launch<false, MODE_FULL, BK>(q, k, v, nullptr, nullptr, out, BH, 1, T, 0, 0, 0, stream);
}

// K4: q, k, v, out [BH, T, 64] bf16 (BH = batch x H heads); E [P, 64] bf16
// with P = left + right + 1, or null with P = 0 (no rel term); mask
// [batch, T] f32, or null (no padding bias).
extern "C" int flash_attention_relkey_bf16(const bf16* q, const bf16* k, const bf16* v,
                                           const bf16* E, const float* mask, bf16* out, int BH,
                                           int H, int T, int P, int left, void* stream) {
  const int pos_ld = P > 0 ? (P | 1) : 0;  // odd: the pos stores do not conflict
  return launch<true, MODE_FULL, BK>(q, k, v, E, mask, out, BH, H, T, P, left, pos_ld, stream);
}

// K8 in bf16: q (pre-scaled), k, v, out [BH, T, 64] bf16, contiguous. mode:
// 0 noexp, 1 dotsonly (tile = keys a recurrence step, 64 or 128), 2 onepass
// (tile = query rows a block, 16 or 32), 3 full (tile 64: K5's own
// instantiation). T must be a multiple of the key tile for the tiled modes
// and of 64, at most 1024, for onepass (the wrapper checks).
extern "C" int attn_ablation_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH,
                                  int T, int mode, int tile, void* stream) {
  if (mode == MODE_NOEXP && tile == 64)
    return launch_ablation<MODE_NOEXP, 64>(q, k, v, out, BH, T, stream);
  if (mode == MODE_NOEXP && tile == 128)
    return launch_ablation<MODE_NOEXP, 128>(q, k, v, out, BH, T, stream);
  if (mode == MODE_DOTSONLY && tile == 64)
    return launch_ablation<MODE_DOTSONLY, 64>(q, k, v, out, BH, T, stream);
  if (mode == MODE_DOTSONLY && tile == 128)
    return launch_ablation<MODE_DOTSONLY, 128>(q, k, v, out, BH, T, stream);
  if (mode == MODE_FULL && tile == 64)
    return launch_ablation<MODE_FULL, 64>(q, k, v, out, BH, T, stream);
  if (mode == MODE_ONEPASS && tile == 16) return launch_onepass<16>(q, k, v, out, BH, T, stream);
  if (mode == MODE_ONEPASS && tile == 32) return launch_onepass<32>(q, k, v, out, BH, T, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
