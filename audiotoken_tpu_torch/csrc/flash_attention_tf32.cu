// K4 and K5's f32 path in one TF32 pass, for Hopper: wgmma on TF32 operands,
// K and V tiles by bulk copies into a shared-memory ring, and q E^T on the
// tensor cores.
//
// Replaces audiotoken_tpu/ops/flash_attention.py:flash_attention_relkey (the
// pallas_call at :519, and the 2-head-packed one at :464, which computes the
// same function) and :_flash_attention_plain (the pallas_call at :287, and
// the tiled one at :309) at Precision.DEFAULT, and at HIGH, which the TPU
// kernel lowers to DEFAULT (:368-380). The function is that of the plain
// versions' tf32=True in ops/flash_attention.py: for one (batch, head), dh = 64,
//
//   s[q, k]   = (q . k + rel[q, k]) * dh^-0.5 + (1 - mask[k]) * (-FLT_MAX)
//   rel[q, k] = pos[q, clamp(k - q + left, 0, P - 1)],   pos = q E^T
//   out[q]    = sum_k softmax_k(s[q, :]) v[k]
//
// with q, k, E, p and v rounded to TF32 (to nearest, ties away from zero:
// (bits + 0x1000) & 0xffffe000, tf32_round), exact products and f32 sums,
// and p rounded against the running maximum of the 64-key tiles so far
// (ONEPASS_KEY_TILE). The rel term is dropped when E is null (P = 0), the
// padding term when the mask is null; K5's f32 path has neither and q comes
// pre-scaled (PRESCALED: the scores are not scaled again). Keys past T leave
// the softmax, rows past T are not written, the output is divided by
// max(l, 1e-30), and a fully masked row gets -FLT_MAX on every key and so the
// uniform average over its T keys, as the plain version gives.
//
// What bounds it on this card: 4 T^2 dh + 2 T P dh FLOPs per (batch, head) in
// one TF32 pass at 495 TFLOP/s (0.1526 ms at [8, 16, 1500, 64] with P = 73,
// 0.1116 at [8, 12, 1499, 64], 0.0694 at K5's [8, 16, 1024, 64]); q, k, v and
// out move in a few microseconds of that. What held the mma.sync form of
// csrc/flash_attention.cu (PASSES = 1, PR 14) at 13-18 % of it, and what this
// design does about each:
//   1. mma.sync.m16n8k8 TF32 runs at about half the TF32 peak on the H100.
//      Here both products are wgmma.mma_async m64n64k8 TF32, issued by a
//      warpgroup for 64 query rows at once: S = Q K^T with Q's A fragments in
//      registers (read once from the rounded Q tile) and K from shared
//      memory, O += P V with P in registers and V^T from shared memory.
//   2. Each of 8 warps read the whole K and V tiles from shared memory and
//      rounded every element itself. Here each element is rounded once a
//      block: a tile lands raw by bulk copy, and one transform step writes K
//      rounded into the 128-byte-swizzled K-major layout that wgmma's
//      descriptor reads, and V rounded and transposed to V^T [dh, keys]
//      (TF32 wgmma takes K-major B operands only) with the keys of each group
//      of 8 in the order 0 2 4 6 1 3 5 7: k-slot t holds key 2t and slot t + 4
//      key 2t + 1, which is where the S accumulator holds a thread's two keys,
//      so P goes from the softmax's registers into the A fragments of P V
//      without shuffles. Q is rounded once, into shared memory, at the start;
//      p with the integer rule in registers, once the P V before it is done
//      (wgmma reads its A registers while it runs). The rounding does not rely
//      on what the tensor cores do with the 13 low bits of an f32 operand:
//      every operand reaches wgmma with them at zero.
//   3. q E^T ran on f32 FMAs before the main loop. Here pos = Q E^T is one
//      wgmma m64n80k8 chain a warpgroup (E rounded and zero-padded to 80
//      rows by V's producer first) into the pos tile in shared memory; key
//      tiles that cross a warp's band gather from it, the others add the
//      per-row constants pos[r][0] and pos[r][P - 1]. A band wider than 80
//      (P > 80, off every entry path: the tests' P = 201) does not fit beside
//      the ring; there the crossing tiles take q . E[d] on f32 FMAs of rounded
//      operands, E from global memory, and the pos tile is not kept.
//   4. Registers and no overlap. Here the block is warp-specialised: warps 0-7
//      are two consumer warpgroups of 64 query rows (BQ = 128), warps 8-11
//      K's producer and 12-15 V's, and setmaxnreg moves registers from the
//      producers (56) to the consumers (200). Each producer keeps two raw
//      stages in flight (one head's 64 keys are one contiguous run of 16 KB,
//      so cp.async.bulk fetches a tile without a tensor map, completing on an
//      mbarrier; never past the last key) and fills two rounded slots under
//      full and empty mbarriers: K's slot is released when S is done, V's
//      when P V is, and the consumers wait for V^T one tile after K. Each
//      consumer issues S_j and P_{j-1} V_{j-1} back to back and runs the
//      softmax of S_j while P V runs; the two consumers take turns at the
//      tensor cores (named barriers), so one's softmax overlaps the other's
//      products.
// On the H100 (PERF.md, PR 15) one producer warpgroup for both K and V
// measured 8-16 % slower, and S with Q in shared memory too 7-10 %; the
// turns measured within 2 % of none. Dropping the transform (a wrong
// result) ran 1.1-1.3x faster, dropping the softmax 1.05-1.1x, halving the
// bulk copies 1-2 %: the round trip through shared memory is the larger
// cost, not the reads from L2.
// One block an SM: 32 KB Q, 2 x 32 KB rounded K and V^T, 2 x 32 KB raw tiles,
// the key bias (a ring of 4 tiles), and with the rel term 20 KB E and the
// pos tile, 128 x (P | 1) f32 (36.5 KB at P = 73): 224,768 bytes in all.
// BK = 128 would need the rounded slots and raw stages twice as large, which
// does not fit beside the pos tile without dropping a stage; 64 also keeps the
// tile against which p is rounded (ONEPASS_KEY_TILE).
//
// The softmax runs in the log2 domain: x = fmaf(qk + rel, 0.125 log2 e, bias)
// and p = 2^(x - m) (ex2.approx); the bias (0, -FLT_MAX for a masked key, -inf
// past T) is added unscaled, so a masked key stays at -FLT_MAX and a fully
// masked row still averages. Against the twin's f32 exp(s - m) that is a
// relative error of about (|s| + |m|) 2^-24 plus ex2's 2^-22, far below p's
// TF32 unit.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

#include "hopper_async.cuh"

namespace {

constexpr int DH = 64;            // head size
constexpr int BQ = 128;           // query rows a block: two consumer warpgroups of 64
constexpr int BK = 64;            // keys a tile (ONEPASS_KEY_TILE)
constexpr int NE = 80;            // rows of the padded E: q E^T's wgmma width
constexpr int NT = 512;           // warps 0-7 the consumers, 8-11 K's producer, 12-15 V's
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 200;  // 256 x 56 + 256 x 200 = 512 x 128
constexpr uint32_t TILE_BYTES = BK * DH * 4;  // one K or V tile, 16 KB

// shared memory, bytes from a 1024-aligned base (the swizzle atoms' alignment)
constexpr uint32_t Q_OFF = 0;                          // [2][64] Q rows, rounded, swizzled
constexpr uint32_t KR_OFF = Q_OFF + BQ * DH * 4;       // [2 slots] K, rounded, swizzled
constexpr uint32_t VT_OFF = KR_OFF + 2 * TILE_BYTES;   // [2 slots] V^T, rounded, swizzled
constexpr uint32_t RAW_OFF = VT_OFF + 2 * TILE_BYTES;  // [2 stages] K rows, then V rows
constexpr uint32_t KB_OFF = RAW_OFF + 4 * TILE_BYTES;  // [4 slots][BK] key bias
constexpr uint32_t BAR_OFF = KB_OFF + 4 * BK * 4;      // the mbarriers
enum {
  RAWK_FULL = 0, RAWV_FULL = 2, K_FULL = 4, V_FULL = 6, K_EMPTY = 8, V_EMPTY = 10, E_FULL = 12,
  NBARS = 13
};
constexpr uint32_t E_OFF = (BAR_OFF + NBARS * 8 + 1023) / 1024 * 1024;  // [NE] E, swizzled
constexpr uint32_t POS_OFF = E_OFF + NE * DH * 4;      // [BQ][pos_ld] q E^T
// named barriers (0 is __syncthreads): a consumer's Q tile, the consumers'
// turns at the tensor cores, each producer's raw stage
enum { BAR_Q = 1, BAR_TURN = 3, BAR_PRODUCER = 5 };

// REL: 0 no rel term; 1 pos by wgmma into shared memory (P <= NE); 2 the
// crossing tiles on FMAs (P > NE)
size_t smem_bytes(int rel, int pos_ld) {
  return 1024 + (rel == 1 ? POS_OFF + (size_t)BQ * pos_ld * 4 : BAR_OFF + NBARS * 8);
}

// Byte offset of the 16-byte chunk c (0-15: columns 4c..4c+3) of row r of a
// K-major tile of R rows x 64 f32 as wgmma reads it with the 128-byte
// swizzle: columns 0-31 of all rows first, then columns 32-63, each as R / 8
// atoms of 8 rows x 128 bytes; chunk c of row r at position c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c, int R) {
  return (c >> 3) * (R * 128) + (r >> 3) * 1024 + (r & 7) * 128 + (((c ^ r) & 7) << 4);
}

// wgmma's descriptor of k-step ks (columns 8ks..8ks+7) of such a tile at
// shared address a: the start advanced inside the swizzle atom, 8-row groups
// 1024 bytes apart (SBO), LBO unused (1), the 128-byte swizzle
__device__ __forceinline__ uint64_t kdesc(uint32_t a, int ks, int R) {
  const uint32_t s = a + (ks >> 2) * R * 128 + (ks & 3) * 32;
  return (uint64_t)((s & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ float4 tf32(float4 x) {
  return make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
}

// 2^x on the special-function unit (ex2.approx, subnormal results flushed to 0:
// against exp2f a relative difference of about 2^-22, below p's TF32 unit)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// this thread's shared-memory stores, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

#define D4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define D32(c) D4(c, 0), D4(c, 4), D4(c, 8), D4(c, 12), D4(c, 16), D4(c, 20), D4(c, 24), D4(c, 28)
#define D40(c) D32(c), D4(c, 32), D4(c, 36)
#define R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define R40 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39}"

// d (=, or += with acc) a b for a 64 x 64 x 8 TF32 product, a (64 x 8) in
// registers: a[0] (row g, slot t), a[1] (g + 8, t), a[2] (g, t + 4), a[3]
// (g + 8, t + 4), as mma.sync's A fragment; b in shared memory. d has the
// accumulator layout of mma.sync's C fragment a warp, the warps of the
// warpgroup on rows 16w..16w+15
__device__ __forceinline__ void mma64_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D32("+f")
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}
// d (=, or += with acc) a b for a 64 x 80 x 8 TF32 product, a and b in
// shared memory (q E^T)
__device__ __forceinline__ void mma80_ss(float (&d)[40], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 " R40 ", %40, %41, p, 1, 1;\n}\n"
      : D40("+f")
      : "l"(a), "l"(b), "r"(acc));
}

// q . E[d] on f32 FMAs of the rounded operands: row r of a consumer's Q tile
// (already rounded) against E's row e, rounded here
__device__ __forceinline__ float qe_dot(const unsigned char* qt, int r, const float* e) {
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < DH / 4; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(qt + swz(r, c, 64));
    acc = fmaf(a.x, tf32(__ldg(e + 4 * c)), acc);
    acc = fmaf(a.y, tf32(__ldg(e + 4 * c + 1)), acc);
    acc = fmaf(a.z, tf32(__ldg(e + 4 * c + 2)), acc);
    acc = fmaf(a.w, tf32(__ldg(e + 4 * c + 3)), acc);
  }
  return acc;
}

template <bool PRESCALED, int REL>
__global__ void __launch_bounds__(NT, 1)
attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ E,
                      const float* __restrict__ mask, float* __restrict__ out, int H, int T,
                      int P, int left, int pos_ld) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw_base);
  auto bar = [&](int i) { return base + BAR_OFF + 8 * i; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * T * DH;
  const int ntiles = (T + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar(RAWK_FULL + i), 1);
      mbar_init(bar(RAWV_FULL + i), 1);
      mbar_init(bar(K_FULL + i), 128);  // every thread of the producer
      mbar_init(bar(V_FULL + i), 128);
      mbar_init(bar(K_EMPTY + i), 8);  // every consumer warp
      mbar_init(bar(V_EMPTY + i), 8);
    }
    mbar_init(bar(E_FULL), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- the producers: warpgroup 2 takes K, warpgroup 3 V; each tile a
    // bulk copy into a raw stage, then one rounding transform ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const bool kside = warp < 12;
    const int pt = tid & 127;
    const float* src = (kside ? k : v) + head;
    const int raw_full = kside ? RAWK_FULL : RAWV_FULL;
    const uint32_t stage0 = base + RAW_OFF + (kside ? 0 : TILE_BYTES);
    auto load_tile = [&](int j) {  // keys [j BK, j BK + nv), never past T
      const int k0 = j * BK, nv = min(BK, T - k0), s = j & 1;
      mbar_expect(bar(raw_full + s), nv * DH * 4);
      bulk_copy(stage0 + s * 2 * TILE_BYTES, src + (size_t)k0 * DH, nv * DH * 4,
                bar(raw_full + s));
    };
    if (pt == 0) {
      load_tile(0);
      if (ntiles > 1) load_tile(1);
    }
    if (kside) {
      const float* mrow = mask ? mask + (size_t)(blockIdx.y / H) * T : nullptr;
      // this thread takes 16-byte chunk kc of rows kr + 8i (i = 0..7), 2048
      // bytes apart in the raw tile and 1024 apart in the swizzled one
      const int kr = pt >> 4, kc = pt & 15;
      const uint32_t ksrc = (kr * DH + 4 * kc) * 4, kdst = swz(kr, kc, BK);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j & 1, k0 = j * BK, nv = min(BK, T - k0);
        mbar_wait(bar(RAWK_FULL + s), (j >> 1) & 1);
        // K and the key bias (a ring of 4: tile j + 4 writes it once both
        // consumers are past S_{j+2}, so past the softmax of tile j)
        if (j >= 2) mbar_wait(bar(K_EMPTY + s), ((j >> 1) - 1) & 1);
        const unsigned char* raw = sm + RAW_OFF + s * 2 * TILE_BYTES;
        unsigned char* kt = sm + KR_OFF + s * TILE_BYTES;
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // rows past T as zeros
          float4 x = *reinterpret_cast<const float4*>(raw + ksrc + 2048 * i);
          if (kr + 8 * i >= nv) x = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(kt + kdst + 1024 * i) = tf32(x);
        }
        if (pt < BK) {
          const int kg = k0 + pt;
          float b = -CUDART_INF_F;
          if (kg < T) b = mrow ? (1.f - mrow[kg]) * -FLT_MAX : 0.f;
          reinterpret_cast<float*>(sm + KB_OFF)[(j & 3) * BK + pt] = b;
        }
        fence_async_smem();
        mbar_arrive(bar(K_FULL + s));
        bar_sync(BAR_PRODUCER, 128);  // every K thread is done with raw stage s
        if (pt == 0 && j + 2 < ntiles) load_tile(j + 2);
      }
    } else {
      if constexpr (REL == 1) {  // E rounded, rows P..NE-1 zero
        for (int c = pt; c < NE * (DH / 4); c += 128) {
          const int r = c >> 4, c4 = c & 15;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < P) {
            const float* e = E + (size_t)r * DH + 4 * c4;
            x = make_float4(__ldg(e), __ldg(e + 1), __ldg(e + 2), __ldg(e + 3));
          }
          *reinterpret_cast<float4*>(sm + E_OFF + swz(r, c4, NE)) = tf32(x);
        }
        fence_async_smem();
        mbar_arrive(bar(E_FULL));
      }
      // V^T: dims 4vd..4vd+3 of keys 8va..8va+7, read as 16-byte chunks of
      // the key rows, written as the chunks (keys 0 2 4 6) and (1 3 5 7) of
      // four V^T rows, odd vd taking the two chunks in the other order: the
      // eight threads of a shared-memory phase read and write distinct banks
      const int vi = pt & 7, vph = pt >> 3;
      const int vd = vi + 8 * (vph & 1), va = (((vi >> 1) + (vph >> 1)) & 3) + 4 * (vph >> 3);
      const uint32_t vsrc = (8 * va * DH + 4 * vd) * 4;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j & 1, nv = min(BK, T - j * BK);
        mbar_wait(bar(RAWV_FULL + s), (j >> 1) & 1);
        // the consumers wait for V^T one tile later, before P V
        if (j >= 2) mbar_wait(bar(V_EMPTY + s), ((j >> 1) - 1) & 1);
        const unsigned char* raw = sm + RAW_OFF + s * 2 * TILE_BYTES + TILE_BYTES;
        unsigned char* vt = sm + VT_OFF + s * TILE_BYTES;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int h = hh ^ (vi & 1);  // keys 2u + h, u = 0..3: chunk 2va + h
          float4 x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            x[u] = *reinterpret_cast<const float4*>(raw + vsrc + (2 * u + h) * DH * 4);
            if (8 * va + 2 * u + h >= nv) x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
          *reinterpret_cast<float4*>(vt + swz(4 * vd, 2 * va + h, DH)) =
              tf32(make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
          *reinterpret_cast<float4*>(vt + swz(4 * vd + 1, 2 * va + h, DH)) =
              tf32(make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
          *reinterpret_cast<float4*>(vt + swz(4 * vd + 2, 2 * va + h, DH)) =
              tf32(make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
          *reinterpret_cast<float4*>(vt + swz(4 * vd + 3, 2 * va + h, DH)) =
              tf32(make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
        }
        fence_async_smem();
        mbar_arrive(bar(V_FULL + s));
        bar_sync(BAR_PRODUCER + 1, 128);  // every V thread is done with raw stage s
        if (pt == 0 && j + 2 < ntiles) load_tile(j + 2);
      }
    }
  } else {
    // ---- the consumers: 64 query rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp >> 2, w4 = warp & 3, ct = tid & 127;
    const int g = lane >> 2, t = lane & 3;
    const int qw = q0 + 64 * wg + 16 * w4;  // the warp's first row
    unsigned char* qt = sm + Q_OFF + wg * 64 * DH * 4;
    const uint32_t qa = base + Q_OFF + wg * 64 * DH * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // Q rounded, rows past T as zeros
      const int c = ct + 128 * i, r = c >> 4, c4 = c & 15, row = q0 + 64 * wg + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < T) x = __ldg(reinterpret_cast<const float4*>(q + head + (size_t)row * DH) + c4);
      *reinterpret_cast<float4*>(qt + swz(r, c4, 64)) = tf32(x);
    }
    fence_async_smem();
    bar_sync(BAR_Q + wg, 128);

    float pos_l[2] = {0.f, 0.f}, pos_r[2] = {0.f, 0.f};  // rows g and g + 8
    float* pos = reinterpret_cast<float*>(sm + POS_OFF);
    if constexpr (REL == 1) {
      mbar_wait(bar(E_FULL), 0);
      float d[40];
      keep(d);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) mma80_ss(d, kdesc(qa, ks, 64), kdesc(base + E_OFF, ks, NE), ks);
      wg_commit();
      keep(d);
      wg_wait<0>();
      keep(d);
      const int r0 = 64 * wg + 16 * w4 + g;
#pragma unroll
      for (int i = 0; i < NE / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * i + 2 * t + (e & 1);
          if (col < P) pos[(r0 + 8 * (e >> 1)) * pos_ld + col] = d[4 * i + e];
        }
      __syncwarp();  // a warp reads back the rows it wrote
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pos_l[i] = pos[(r0 + 8 * i) * pos_ld];
        pos_r[i] = pos[(r0 + 8 * i) * pos_ld + P - 1];
      }
    } else if constexpr (REL == 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pos_l[i] = qe_dot(qt, 16 * w4 + g + 8 * i, E);
        pos_r[i] = qe_dot(qt, 16 * w4 + g + 8 * i, E + (size_t)(P - 1) * DH);
      }
    }
    // Q as the A fragments of S: k-step ks in qf[4ks..4ks + 3] (dims 8ks + t
    // and 8ks + t + 4 of rows g and g + 8), so that S reads only K from
    // shared memory
    uint32_t qf[32];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qf[4 * ks + e] = *reinterpret_cast<const uint32_t*>(
            qt + swz(16 * w4 + g + 8 * (e & 1), 2 * ks + (e >> 1), 64) + 4 * t);
    if (wg == 1) bar_arrive(BAR_TURN, 256);  // consumer 0 takes the tensor cores first

    constexpr float scale = (PRESCALED ? 1.f : 0.125f) * 1.4426950408889634f;  // dh^-0.5 log2 e
    const float* kbias = reinterpret_cast<const float*>(sm + KB_OFF);
    float o[32];  // output: dims 8n + 2t, + 1 of rows g (o[4n], o[4n + 1]) and g + 8
    uint32_t pa[32];  // the last tile's P as A fragments: k-step n in pa[4n..4n + 3]
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    // S_j = Q K_j^T into d (keys 8n + 2t, + 1 of rows g and g + 8), on the
    // tensor cores in this consumer's turn; with P_{j-1} V_{j-1} behind it
    // (keep: the accumulators and P are pinned around each chain, so the
    // compiler moves no access of them into it)
    auto issue = [&](float (&d)[32], int j, auto with_pv) {
      const int s = j & 1;
      mbar_wait(bar(K_FULL + s), (j >> 1) & 1);
      if constexpr (decltype(with_pv)::value) mbar_wait(bar(V_FULL + (s ^ 1)), ((j - 1) >> 1) & 1);
      bar_sync(BAR_TURN + wg, 256);
      keep(d);
      if constexpr (decltype(with_pv)::value) {
        keep(o);
        keep(pa);
      }
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        mma64_rs(d, qf[4 * ks], qf[4 * ks + 1], qf[4 * ks + 2], qf[4 * ks + 3],
                 kdesc(base + KR_OFF + s * TILE_BYTES, ks, BK), ks);
      wg_commit();
      keep(d);
      if constexpr (decltype(with_pv)::value) {
        const uint32_t vt = base + VT_OFF + (s ^ 1) * TILE_BYTES;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mma64_rs(o, pa[4 * n], pa[4 * n + 1], pa[4 * n + 2], pa[4 * n + 3], kdesc(vt, n, DH));
        wg_commit();
        keep(o);
        keep(pa);
      }
      if (wg == 0 || j + 1 < ntiles) bar_arrive(BAR_TURN + (wg ^ 1), 256);
    };
    // the rel term, the scale and the key bias on S_j, then the online
    // softmax: d takes this tile's p in place, alpha rescales what came before
    auto softmax = [&](float (&d)[32], int j, float (&alpha)[2]) {
      const int k0 = j * BK;
      if constexpr (REL != 0) {
        // the band is k - q + left in [0, P - 1]; d covers the warp's pairs
        const int d_lo = k0 - (qw + 15) + left, d_hi = k0 + BK - 1 - qw + left;
        if (d_hi <= 0 || d_lo >= P - 1) {
          const float c0 = d_hi <= 0 ? pos_l[0] : pos_r[0];
          const float c1 = d_hi <= 0 ? pos_l[1] : pos_r[1];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            d[4 * n] += c0;
            d[4 * n + 1] += c0;
            d[4 * n + 2] += c1;
            d[4 * n + 3] += c1;
          }
        } else {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 16 * w4 + g + 8 * (e >> 1);  // the row among the warpgroup's 64
              const int dist = min(max(k0 + 8 * n + 2 * t + (e & 1) - (qw - 16 * w4 + r) + left,
                                       0), P - 1);
              if constexpr (REL == 1) {
                d[4 * n + e] += pos[(64 * wg + r) * pos_ld + dist];
              } else {
                d[4 * n + e] += qe_dot(qt, r, E + (size_t)dist * DH);
              }
            }
        }
      }
      const float* kb = kbias + (j & 3) * BK;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 b = *reinterpret_cast<const float2*>(kb + 8 * n + 2 * t);
        d[4 * n] = fmaf(d[4 * n], scale, b.x);
        d[4 * n + 1] = fmaf(d[4 * n + 1], scale, b.y);
        d[4 * n + 2] = fmaf(d[4 * n + 2], scale, b.x);
        d[4 * n + 3] = fmaf(d[4 * n + 3], scale, b.y);
        mx[0] = fmaxf(mx[0], fmaxf(d[4 * n], d[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(d[4 * n + 2], d[4 * n + 3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = ex2(m[i] - mx[i]);  // mx is finite: every tile has a key < T
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        d[4 * n] = ex2(d[4 * n] - m[0]);
        d[4 * n + 1] = ex2(d[4 * n + 1] - m[0]);
        d[4 * n + 2] = ex2(d[4 * n + 2] - m[1]);
        d[4 * n + 3] = ex2(d[4 * n + 3] - m[1]);
        l[0] += d[4 * n] + d[4 * n + 1];
        l[1] += d[4 * n + 2] + d[4 * n + 3];
      }
    };
    // p rounded into the A fragments of P V: key 2t to k-slot t, key 2t + 1
    // to slot t + 4. Only once the last P V is done: wgmma reads pa while it
    // runs, so pa is written with no wgmma in flight
    auto round_p = [&](const float (&d)[32]) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        pa[4 * n] = tf32_bits(d[4 * n]);
        pa[4 * n + 1] = tf32_bits(d[4 * n + 2]);
        pa[4 * n + 2] = tf32_bits(d[4 * n + 1]);
        pa[4 * n + 3] = tf32_bits(d[4 * n + 3]);
      }
    };

    {  // tile 0: o is still zero
      float d[32], alpha[2];
      issue(d, 0, std::false_type{});
      wg_wait<0>();
      keep(d);
      if (lane == 0) mbar_arrive(bar(K_EMPTY));
      softmax(d, 0, alpha);
      round_p(d);
    }
    for (int j = 1; j < ntiles; ++j) {
      float d[32], alpha[2];
      issue(d, j, std::true_type{});
      wg_wait<1>();  // S_j is done, P_{j-1} V_{j-1} may run on
      keep(d);
      if (lane == 0) mbar_arrive(bar(K_EMPTY + (j & 1)));
      softmax(d, j, alpha);
      wg_wait<0>();
      keep(o);
      keep(pa);
      keep(d);
      if (lane == 0) mbar_arrive(bar(V_EMPTY + ((j - 1) & 1)));
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
      round_p(d);
    }
    {  // the last tile's P V
      const uint32_t vt = base + VT_OFF + ((ntiles - 1) & 1) * TILE_BYTES;
      mbar_wait(bar(V_FULL + ((ntiles - 1) & 1)), ((ntiles - 1) >> 1) & 1);
      keep(o);
      keep(pa);
      wg_fence();
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma64_rs(o, pa[4 * n], pa[4 * n + 1], pa[4 * n + 2], pa[4 * n + 3], kdesc(vt, n, DH));
      wg_commit();
      keep(o);
      wg_wait<0>();
      keep(o);
    }

    const int r = qw + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      if (r + 8 * i < T) {
        float* dst = out + head + (size_t)(r + 8 * i) * DH + 2 * t;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
      }
    }
  }
}

template <bool PRESCALED, int REL>
int launch(const float* q, const float* k, const float* v, const float* E, const float* mask,
           float* out, int BH, int H, int T, int P, int left, void* stream) {
  const int pos_ld = REL == 1 ? (P | 1) : 0;  // odd: the gathers spread over the banks
  const size_t smem = smem_bytes(REL, pos_ld);
  cudaError_t err = cudaFuncSetAttribute(attention_tf32_kernel<PRESCALED, REL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, BH);
  attention_tf32_kernel<PRESCALED, REL><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, E, mask, out, H, T, P, left, pos_ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 in one TF32 pass (JAX's Precision.DEFAULT and HIGH). q, k, v, out
// [BH, T, 64] f32 (BH = batch x H heads), 16-byte aligned; E [P, 64] f32 with
// P = left + right + 1, or null with P = 0 (no rel term); mask [batch, T]
// f32, or null (no padding bias).
extern "C" int flash_attention_relkey_f32_1pass(const float* q, const float* k, const float* v,
                                                const float* E, const float* mask, float* out,
                                                int BH, int H, int T, int P, int left,
                                                void* stream) {
  if (P == 0) return launch<false, 0>(q, k, v, E, mask, out, BH, H, T, P, left, stream);
  if (P <= NE) return launch<false, 1>(q, k, v, E, mask, out, BH, H, T, P, left, stream);
  return launch<false, 2>(q, k, v, E, mask, out, BH, H, T, P, left, stream);
}

// K5's f32 path in one TF32 pass: no rel term, no mask, q pre-scaled,
// softmax(q k^T) v. q, k, v, out [BH, T, 64] f32.
extern "C" int flash_attention_plain_f32_1pass(const float* q, const float* k, const float* v,
                                               float* out, int BH, int T, void* stream) {
  return launch<true, 0>(q, k, v, nullptr, nullptr, out, BH, 1, T, 0, 0, stream);
}
