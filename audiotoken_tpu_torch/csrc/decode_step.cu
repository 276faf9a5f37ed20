// K7: the GPT decode step's products around the attention, for one token
// per row: decode_qkv (LN1 -> x Wqkv + b) and decode_ffn (x + a Wo + bo ->
// LN2 -> exact-GELU(h Win + bi) Wout2 + b2 + residual), and decode_ffn's
// tensor-parallel form, decode_ffn_tp (below).
//
// Replaces audiotoken_tpu/ops/decode_step_fused.py:decode_qkv (Pallas
// kernel `_qkv_kernel`, pallas_call at :108) and decode_ffn (`_ffn_kernel`,
// :131). Both are built from one product, a GEMV over B <= 32 rows with an
// optional LayerNorm prologue and a bias / GELU / residual epilogue:
//
//   y[b, o] = epi( sum_k pro(x)[b, k] W[o, k] )       W [N, K], torch layout
//
// decode_qkv is one product (LN prologue, bias); decode_ffn is three
// (bias + residual; LN prologue, bias, GELU; bias + residual), because LN2
// needs the whole x1 row. The numerics follow the Pallas kernels' staging:
// LN statistics in f32 (mean, then the mean square of the deviations); the
// normalised row, the scale and the shift rounded to T in turn; each product
// accumulated in f32 and rounded to T, then the bias added in T, GELU (erff,
// exact) in f32 rounded to T, and the residual added in T. For T = f32 every
// rounding is the identity. B > 32 runs as row groups of 32.
//
// What bounds it on this card: reading the weights once. At 768 wide a
// layer's four matrices are 14.2 MB in bf16: decode_ffn's three 10.6 MB, 3.2
// us at 3.35 TB/s, decode_qkv's 3.5 MB, 1.1 us. They are read cold: the
// twelve layers of a step walk 170 MB, more than the 50 MB L2. At B = 32 the
// products are 2 x 32 x 5.3 M = 340 MFLOP, 5.1 us as f32 FMAs, above the byte
// bound, so in bf16 they run on the tensor cores. At these sizes the time
// goes to latency more than to bytes: what the design removes is waiting.
//
// bf16, the main path, a weight stream over the whole card:
//   * a block owns 16 output columns (the M of mma.sync.m16n8k16: the
//     weights are the A operand, read straight from device memory into
//     registers) and the rows are the N, 8 a tile. Its 8 warps split its k
//     range, 32 k a chunk, and their sums are added in shared memory in warp
//     order. A product wider than 1024 in k, or one with too few column
//     blocks to give every SM a block, is also split over the blocks of a
//     thread-block cluster, whose sums the first block adds in rank order
//     through distributed shared memory: 768 x 768 as 48 column blocks x 3
//     splits of 256, 3072 x 768 (the MLP input) as 192 x 1, 768 x 3072 (the
//     MLP output) as 48 x 3 of 1024, 2304 x 768 (qkv) as 144 x 1. The sums
//     come out in a fixed order, with no atomics: a sampled decode stays
//     deterministic per seed;
//   * a lane's k slots of a fragment are mapped to 8 consecutive k, so each
//     lane reads its weights as 16-byte streaming loads (ld.global.cs: read
//     once, evict first), all of them issued first (up to 32 KB a block);
//   * the LN prologue runs once per row group, in a kernel of its own (a warp
//     a row, the row in registers), into module memory that the product then
//     copies into shared memory with cp.async; computing it in every block
//     cost more than the rest of the product together;
//   * consecutive kernels of one call overlap by programmatic dependent
//     launch: each starts its successor at once, and that one issues its
//     weight loads, then waits (griddepcontrol.wait) for its predecessor
//     before it reads anything the predecessor wrote. So the MLP's weights
//     stream while the out-projection and LN2 run. One cooperative launch
//     with grid barriers between the three products was, in two earlier
//     designs of this kernel (split K over blocks reduced through device
//     memory), about as fast as three launches in one and slower in the
//     other; with clusters and programmatic dependent launch the chain of
//     launches is what is kept.
// The module memory and the launch order it relies on assume that the K7 calls
// of a device are issued on one stream, as the port issues them.
//
// f32, the greedy parity path (decode_gemv_kernel): IEEE f32 FMAs, 16 output
// columns a block of 8 warps, two a warp; a lane reads 8 contiguous weights
// of each column per 256-wide chunk of k; the rows' chunk of pro(x) is
// staged in shared memory, each lane keeps 2 x B accumulators, and the sums
// are reduced across the warp with shuffles, lane b applying row b's
// epilogue.
//
// decode_ffn_tp, tensor parallel (Megatron): the out-projection and the MLP
// output are row-parallel, so each needs its partial sums added over the
// ranks before its rounding, bias and residual add. decode_ffn fuses across
// both of those points, so its tp form is three calls, the caller's
// all-reduce of f32 sums [B, C] between them:
//   decode_ffn_tp_out: s1 = a Wo^T (the rank's columns of a, rows of Wo's
//                      input), the raw f32 sums;
//   decode_ffn_tp_mlp: x1 = x + s1 + bo (the epilogue of the product, on
//                      the reduced s1); h = GELU(LN2(x1) Wi^T + bi) on the
//                      rank's block of Wi; s2 = h W2^T, raw f32 sums;
//   decode_ffn_tp_add: out = x1 + s2 + b2.
// The products are decode_ffn's (the same kernels and plans, writing f32
// sums in place of the epilogue), and the epilogue a small elementwise
// kernel with decode_ffn's roundings, so on one rank the three calls give
// decode_ffn's bits. A call that follows the all-reduce starts without
// programmatic dependent launch.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

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

// --- f32: FMAs ---------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPW = 2;                  // output columns per warp
constexpr int COLS = WARPS * CPW;       // output columns per block
constexpr int KC = 256;                 // k per chunk: 32 lanes x 8

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_gemv_kernel(const T* __restrict__ x, const T* __restrict__ ln_w,
                   const T* __restrict__ ln_b, const T* __restrict__ W,
                   const T* __restrict__ bias, const T* __restrict__ resid, T* __restrict__ y,
                   float* __restrict__ ys, int B, int K, int N, bool do_ln, int gelu, float eps) {
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
      if (o < N && ys) {
        ys[(size_t)lane * N + o] = mine[c];
      } else if (o < N) {
        float t = rnd<T>(mine[c]);
        if (bias) t = rnd<T>(t + to_f(bias[o]));
        if (gelu) t = rnd<T>(0.5f * t * (1.f + erff(t * 0.70710678118654752f)));
        if (resid) t = rnd<T>(to_f(resid[(size_t)lane * N + o]) + t);
        y[(size_t)lane * N + o] = from_f<T>(t);
      }
    }
  }
}

// --- bf16: the weight stream on the tensor cores ---------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 8;                  // warps a block, splitting its k range
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_COLS = 16;                  // output columns a block: the M of the mma
constexpr int KCH = 32;                      // k a chunk: 8 consecutive k a lane
constexpr int KR_MAX = 1024;                 // k a block
constexpr int WCH = KR_MAX / KCH / TC_WARPS; // chunks a warp, at most
constexpr int MAX_SPLITS = 8;                // blocks of a cluster splitting K
constexpr int LN_MAX = 1024;                 // width of an LN row: 4 x 8 a lane

// The LN prologue's output, pro(x) [B, K] bf16, for the product after it.
// Module memory: the K7 launches of a device must run on one stream.
__device__ bf16 g_pro[MAXB * LN_MAX];

struct Product {
  const bf16* x;      // [B, K], pro(x) already
  const bf16* W;      // [N, K]
  const bf16* bias;   // [N] or null
  const bf16* resid;  // [B, N] or null
  bf16* y;            // [B, N]
  float* ys;          // [B, N] the raw f32 sums in place of y and the epilogue, or null
  int B, K, N, gelu;
  int splits, kr;     // k-splits (a cluster) of kr k each
};

// How a product is cut: 16 columns a block; K split over the blocks of a
// cluster until every SM has a block, each split at least a chunk a warp
// and at most KR_MAX wide
Product plan(Product p, int sms) {
  const int cpk = (p.K + KCH - 1) / KCH;
  const int cblocks = (p.N + TC_COLS - 1) / TC_COLS;
  const int want = (sms + cblocks - 1) / cblocks;
  int most = cpk / TC_WARPS > 1 ? cpk / TC_WARPS : 1;
  most = most < MAX_SPLITS ? most : MAX_SPLITS;
  int splits = want < most ? want : most;
  const int least = (cpk * KCH + KR_MAX - 1) / KR_MAX;
  splits = splits > least ? splits : least;
  const int cps = (cpk + splits - 1) / splits;
  p.splits = (cpk + cps - 1) / cps;
  p.kr = cps * KCH;
  return p;
}

int tc_smem_bytes(const Product& p) {
  const int rows = (p.B + 7) & ~7;
  return rows * (p.kr + KCH) * (int)sizeof(bf16)                // pro(x) [rows][kr + 32]
         + (TC_WARPS + 1) * 32 * TC_COLS * (int)sizeof(float);  // warp sums, block sums
}

// programmatic dependent launch: let the next kernel of the stream start
// (its weight loads do not depend on this one); wait for the previous one
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}
__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes (nothing read)
// where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 16 bytes of weights, read once: streaming (evict first). Volatile, so
// that the compiler issues them where they stand, ahead of the wait.
__device__ __forceinline__ uint4 ld_stream(const bf16* p) {
  uint4 r;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ float2 bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b for one m16n8k16 tile: bf16 a (16 x 16) and b (16 x 8), f32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// pro(x) = LN(x) of B <= 32 rows of K <= LN_MAX into `out`, once per row
// group: one warp a row, the row in registers (8 consecutive k a lane and
// step); f32 statistics, the mean, then the mean square of the deviations
__global__ void __launch_bounds__(32 * MAXB)
decode_ln_kernel(const bf16* x, const bf16* ln_w, const bf16* ln_b, bf16* out, int B, int K,
                 float eps) {
  launch_dependents();
  const int b = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int S = LN_MAX / 256;
  uint4 lw[S], lb[S];  // the scale and shift are weights: read before the wait
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int k = 256 * i + 8 * lane;
    lw[i] = k < K ? __ldg(reinterpret_cast<const uint4*>(ln_w + k)) : make_uint4(0, 0, 0, 0);
    lb[i] = ln_b && k < K ? __ldg(reinterpret_cast<const uint4*>(ln_b + k))
                          : make_uint4(0, 0, 0, 0);
  }
  wait_previous();
  if (b >= B) return;
  uint4 u[S];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int k = 256 * i + 8 * lane;
    u[i] = k < K ? __ldcg(reinterpret_cast<const uint4*>(x + (size_t)b * K + k))
                 : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const uint32_t w[4] = {u[i].x, u[i].y, u[i].z, u[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = bf2(w[j]);
      sum += f.x;
      sum += f.y;
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
  const float mean = sum / K;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (256 * i + 8 * lane < K) {
      const uint32_t w[4] = {u[i].x, u[i].y, u[i].z, u[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = bf2(w[j]);
        sq = fmaf(f.x - mean, f.x - mean, sq);
        sq = fmaf(f.y - mean, f.y - mean, sq);
      }
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) sq += __shfl_xor_sync(FULL, sq, off);
  const float rstd = rsqrtf(sq / K + eps);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int k = 256 * i + 8 * lane;
    if (k < K) {
      const uint32_t uu[4] = {u[i].x, u[i].y, u[i].z, u[i].w},
                     ww[4] = {lw[i].x, lw[i].y, lw[i].z, lw[i].w},
                     bb[4] = {lb[i].x, lb[i].y, lb[i].z, lb[i].w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xv = bf2(uu[j]), wv = bf2(ww[j]), bv = bf2(bb[j]);
        float v0 = rnd<bf16>(rnd<bf16>((xv.x - mean) * rstd) * wv.x);
        float v1 = rnd<bf16>(rnd<bf16>((xv.y - mean) * rstd) * wv.y);
        if (ln_b) {
          v0 += bv.x;
          v1 += bv.y;
        }
        o[j] = pack(v0, v1);  // the shift's sum rounds here
      }
      *reinterpret_cast<uint4*>(out + (size_t)b * K + k) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// 16 output columns of one k-split: block column block blockIdx.x / splits,
// split (cluster rank) blockIdx.x % splits
__global__ void __launch_bounds__(TC_THREADS)
decode_tc_kernel(Product p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  launch_dependents();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cb = blockIdx.x / p.splits, sp = blockIdx.x % p.splits;
  const int B = p.B, K = p.K, N = p.N;
  const int kb0 = sp * p.kr;
  const int nch = (min(p.kr, K - kb0) + KCH - 1) / KCH;
  const int o0 = cb * TC_COLS;
  const int rows = (B + 7) & ~7, ldx = p.kr + KCH;
  bf16* xs = reinterpret_cast<bf16*>(tc_smem);            // [rows][ldx] x over the split
  float* red = reinterpret_cast<float*>(xs + rows * ldx);  // [warp][32 rows][16 cols]
  float* tot = red + TC_WARPS * 32 * TC_COLS;              // [32 rows][16 cols] the block's

  // the weights first, before waiting for the previous kernel: warp w takes
  // chunks w, w + 8, ...; rows o0 + g and o0 + g + 8, k = 32c + 8t .. + 7
  uint4 wa[WCH], wb[WCH];
#pragma unroll
  for (int j = 0; j < WCH; ++j) {
    const int c = warp + TC_WARPS * j, k = kb0 + c * KCH + 8 * t;
    const bool in = c < nch && k < K;  // K % 8 == 0: all 8 or none
    wa[j] = (in && o0 + g < N) ? ld_stream(p.W + (size_t)(o0 + g) * K + k) : make_uint4(0, 0, 0, 0);
    wb[j] = (in && o0 + g + 8 < N) ? ld_stream(p.W + (size_t)(o0 + g + 8) * K + k)
                                   : make_uint4(0, 0, 0, 0);
  }
  wait_previous();

  // x over the split's k range; zeros past K and in the padding rows
  const int per_row = nch * (KCH / 8);
  for (int e = tid; e < rows * per_row; e += TC_THREADS) {
    const int b = e / per_row, c8 = e % per_row, k = kb0 + c8 * 8;
    const bool valid = b < B && k < K;
    cp_async16(xs + b * ldx + c8 * 8, valid ? p.x + (size_t)b * K + k : p.x, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // the residual of the thread's outputs (below), in flight with x
  constexpr int OUTS = 32 * TC_COLS / TC_THREADS;
  float res[OUTS];
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int e = tid + i * TC_THREADS, b = e / TC_COLS, o = o0 + e % TC_COLS;
    res[i] = p.resid && sp == 0 && b < B && o < N ? to_f(p.resid[(size_t)b * N + o]) : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // k-step h of chunk c: slots (2t, 2t + 1) are k = 32c + 8t + 4h + {0, 1},
  // slots (2t + 8, 2t + 9) are k = 32c + 8t + 4h + {2, 3}
  float acc[MAXB / 8][4] = {};
#pragma unroll
  for (int j = 0; j < WCH; ++j) {
    const int c = warp + TC_WARPS * j;
    if (c < nch) {
#pragma unroll
      for (int nt = 0; nt < MAXB / 8; ++nt) {
        if (nt * 8 < B) {
          const uint4 xv =
              *reinterpret_cast<const uint4*>(xs + (nt * 8 + g) * ldx + c * KCH + 8 * t);
          mma_bf16(acc[nt], wa[j].x, wb[j].x, wa[j].y, wb[j].y, xv.x, xv.y);
          mma_bf16(acc[nt], wa[j].z, wb[j].z, wa[j].w, wb[j].w, xv.z, xv.w);
        }
      }
    }
  }
  // C rows are the columns g (+ 8), C columns the rows nt*8 + 2t (+ 1)
#pragma unroll
  for (int nt = 0; nt < MAXB / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * 32 + nt * 8 + 2 * t + (e & 1)) * TC_COLS + g + 8 * (e >> 1)] = acc[nt][e];
  __syncthreads();

  // the block's sums, warps in order; a thread owns (row, column) pairs
  float s[OUTS];
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int e = tid + i * TC_THREADS;
    s[i] = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) s[i] += red[w * 32 * TC_COLS + e];
  }
  if (p.splits > 1) {  // the splits of the column block, in rank order
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int i = 0; i < OUTS; ++i) tot[tid + i * TC_THREADS] = s[i];
    cluster.sync();
    if (sp == 0) {
      for (int r = 1; r < p.splits; ++r) {
        const float* other = cluster.map_shared_rank(tot, r);
#pragma unroll
        for (int i = 0; i < OUTS; ++i) s[i] += other[tid + i * TC_THREADS];
      }
    }
    cluster.sync();  // the others' sums stay until read
    if (sp != 0) return;
  }
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int e = tid + i * TC_THREADS, b = e / TC_COLS, o = o0 + e % TC_COLS;
    if (b < B && o < N && p.ys) {
      p.ys[(size_t)b * N + o] = s[i];
    } else if (b < B && o < N) {
      float v = rnd<bf16>(s[i]);
      if (p.bias) v = rnd<bf16>(v + to_f(p.bias[o]));
      if (p.gelu) v = rnd<bf16>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
      if (p.resid) v = rnd<bf16>(res[i] + v);
      p.y[(size_t)b * N + o] = from_f<bf16>(v);
    }
  }
}

// y = resid + (s rounded to T, then the bias): a product's epilogue on its
// f32 sums s [B, N], decode_ffn's roundings
template <typename T>
__global__ void __launch_bounds__(256)
decode_residual_kernel(const float* __restrict__ s, const T* __restrict__ bias,
                       const T* __restrict__ resid, T* __restrict__ y, int total, int N) {
  launch_dependents();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float t = rnd<T>(s[e]);
  if (bias) t = rnd<T>(t + to_f(bias[e % N]));
  y[e] = from_f<T>(to_f(resid[e]) + t);
}

template <typename T>
cudaError_t residual(const float* s, const T* bias, const T* resid, T* y, int B, int N,
                     cudaStream_t stream) {
  const int total = B * N;
  decode_residual_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(s, bias, resid, y, total, N);
  return cudaGetLastError();
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  if (!count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// launch attributes: a cluster of `cluster` blocks (if > 1), and, with
// `after_own` (the previous kernel of the stream is one of this file's, or
// K6), programmatic dependent launch, so that the kernel may start before the
// previous one ends
struct Attrs {
  cudaLaunchAttribute a[2];
  int n = 0;
  Attrs(int cluster, bool after_own) {
    if (cluster > 1) {
      a[n].id = cudaLaunchAttributeClusterDimension;
      a[n].val.clusterDim.x = cluster;
      a[n].val.clusterDim.y = 1;
      a[n].val.clusterDim.z = 1;
      ++n;
    }
    if (after_own) {
      a[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      a[n].val.programmaticStreamSerializationAllowed = 1;
      ++n;
    }
  }
};

// LN(x) of a row group into g_pro; `pro` gets its address
cudaError_t launch_ln(const bf16* x, const bf16* ln_w, const bf16* ln_b, int B, int K, float eps,
                      bool after_own, cudaStream_t stream, const bf16** pro) {
  if (K > LN_MAX) return cudaErrorInvalidValue;
  bf16* out = nullptr;
  cudaError_t err = cudaGetSymbolAddress(reinterpret_cast<void**>(&out), g_pro);
  if (err != cudaSuccess) return err;
  *pro = out;
  Attrs at(1, after_own);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32 * B);
  cfg.stream = stream;
  cfg.attrs = at.a;
  cfg.numAttrs = at.n;
  err = cudaLaunchKernelEx(&cfg, decode_ln_kernel, x, ln_w, ln_b, out, B, K, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// one product of a row group
cudaError_t launch_tc(Product p, bool after_own, cudaStream_t stream) {
  p = plan(p, sm_count());
  if (p.kr > KR_MAX || p.splits > MAX_SPLITS) return cudaErrorInvalidValue;
  const int smem = tc_smem_bytes(p);
  cudaError_t err =
      cudaFuncSetAttribute(decode_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Attrs at(p.splits, after_own);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + TC_COLS - 1) / TC_COLS * p.splits);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at.a;
  cfg.numAttrs = at.n;
  err = cudaLaunchKernelEx(&cfg, decode_tc_kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// y = epi(pro(x) W^T), B > 32 as row groups of 32
// (with ys, the raw f32 sums into ys instead of y and the epilogue)
template <typename T>
cudaError_t gemv(const T* x, const T* ln_w, const T* ln_b, const T* W, const T* bias,
                 const T* resid, T* y, int B, int K, int N, int gelu, float eps,
                 cudaStream_t stream, bool after_own = false, float* ys = nullptr) {
  for (int r0 = 0; r0 < B; r0 += MAXB) {
    const int rows = B - r0 < MAXB ? B - r0 : MAXB;
    const T* rx = x + (size_t)r0 * K;
    const T* rr = resid ? resid + (size_t)r0 * N : nullptr;
    T* ry = y ? y + (size_t)r0 * N : nullptr;
    float* rs = ys ? ys + (size_t)r0 * N : nullptr;
    cudaError_t err;
    if constexpr (sizeof(T) == 2) {
      // the LN prologue once for the row group, then the product
      const bool own = after_own || r0 > 0;
      const T* px = rx;
      err = ln_w ? launch_ln(rx, ln_w, ln_b, rows, K, eps, own, stream, &px) : cudaSuccess;
      if (err == cudaSuccess)
        err = launch_tc(Product{px, W, bias, rr, ry, rs, rows, K, N, gelu, 0, 0}, own || ln_w,
                        stream);
    } else {
      decode_gemv_kernel<float><<<(N + COLS - 1) / COLS, THREADS, 0, stream>>>(
          rx, ln_w, ln_b, W, bias, rr, ry, rs, rows, K, N, ln_w != nullptr, gelu, eps);
      err = cudaGetLastError();
    }
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
  // the first product may start during K6 (decode_attention.cu), which
  // triggers its dependents at once: it reads only weights before its wait.
  // After a kernel that does not trigger, it starts when that one ends.
  cudaError_t err = gemv(a, none, none, wo, bo, x, x1, B, C, C, 0, eps, st, true);
  if (err == cudaSuccess)
    err = gemv((const T*)x1, ln_w, ln_b, wi, bi, none, h, B, C, H, 1, eps, st, true);
  if (err == cudaSuccess)
    err = gemv((const T*)h, none, none, w2, b2, (const T*)x1, out, B, H, C, 0, eps, st, true);
  return static_cast<int>(err);
}

// decode_ffn_tp's three calls (see the head of the file). K: the rank's
// columns of a; C: the model width; H: the rank's MLP columns.
template <typename T>
int ffn_tp_out(const T* a, const T* wo, float* s1, int B, int K, int C, void* stream) {
  const T* none = nullptr;
  // like decode_ffn's first product, it may start during K6
  return static_cast<int>(gemv(a, none, none, wo, none, none, (T*)nullptr, B, K, C, 0, 0.f,
                               static_cast<cudaStream_t>(stream), true, s1));
}

template <typename T>
int ffn_tp_mlp(const T* x, const float* s1, const T* bo, const T* ln_w, const T* ln_b,
               const T* wi, const T* bi, const T* w2, T* x1, T* h, float* s2, int B, int C,
               int H, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* none = nullptr;
  cudaError_t err = residual(s1, bo, x, x1, B, C, st);
  if (err == cudaSuccess)
    err = gemv((const T*)x1, ln_w, ln_b, wi, bi, none, h, B, C, H, 1, eps, st, true);
  if (err == cudaSuccess)
    err = gemv((const T*)h, none, none, w2, none, none, (T*)nullptr, B, H, C, 0, eps, st, true,
               s2);
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

// decode_ffn_tp: a [B, K]; wo [C, K]; s1, s2 [B, C] f32; x, x1, out [B, C];
// wi [H, C]; w2 [C, H]; bo, b2 [C], bi [H] or null; ln_b may be null; h
// [B, H] scratch. Between the calls the caller sums s1 (then s2) over the
// ranks. C, K, H % 8 == 0.
extern "C" int decode_ffn_tp_out_f32(const float* a, const float* wo, float* s1, int B, int K,
                                     int C, void* stream) {
  return ffn_tp_out(a, wo, s1, B, K, C, stream);
}

extern "C" int decode_ffn_tp_out_bf16(const __nv_bfloat16* a, const __nv_bfloat16* wo, float* s1,
                                      int B, int K, int C, void* stream) {
  return ffn_tp_out(a, wo, s1, B, K, C, stream);
}

extern "C" int decode_ffn_tp_mlp_f32(const float* x, const float* s1, const float* bo,
                                     const float* ln_w, const float* ln_b, const float* wi,
                                     const float* bi, const float* w2, float* x1, float* h,
                                     float* s2, int B, int C, int H, float eps, void* stream) {
  return ffn_tp_mlp(x, s1, bo, ln_w, ln_b, wi, bi, w2, x1, h, s2, B, C, H, eps, stream);
}

extern "C" int decode_ffn_tp_mlp_bf16(const __nv_bfloat16* x, const float* s1,
                                      const __nv_bfloat16* bo, const __nv_bfloat16* ln_w,
                                      const __nv_bfloat16* ln_b, const __nv_bfloat16* wi,
                                      const __nv_bfloat16* bi, const __nv_bfloat16* w2,
                                      __nv_bfloat16* x1, __nv_bfloat16* h, float* s2, int B,
                                      int C, int H, float eps, void* stream) {
  return ffn_tp_mlp(x, s1, bo, ln_w, ln_b, wi, bi, w2, x1, h, s2, B, C, H, eps, stream);
}

extern "C" int decode_ffn_tp_add_f32(const float* x1, const float* s2, const float* b2,
                                     float* out, int B, int C, void* stream) {
  return static_cast<int>(residual(s2, b2, x1, out, B, C, static_cast<cudaStream_t>(stream)));
}

extern "C" int decode_ffn_tp_add_bf16(const __nv_bfloat16* x1, const float* s2,
                                      const __nv_bfloat16* b2, __nv_bfloat16* out, int B, int C,
                                      void* stream) {
  return static_cast<int>(residual(s2, b2, x1, out, B, C, static_cast<cudaStream_t>(stream)));
}
