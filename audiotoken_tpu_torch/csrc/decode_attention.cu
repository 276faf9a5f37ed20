// K6: one query token's attention over the GPT's KV cache plus its own key
// and value (the self term), normalised; the new key and value are then
// appended to the cache at slot `pos`.
//
// Replaces audiotoken_tpu/ops/decode_attention.py:decode_attention_fused
// (Pallas kernel `_kernel_fused`, reached through the pallas_call at :142)
// and its partials form decode_attention (`_kernel`, :186), which returned
// (acc, m, l) only so that XLA could fold in the self term. For one
// (batch row b, head h), with dh = 64 and q scaled by dh^-0.5 = 0.125 here:
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
// 2 x n x 64 elements per (b, h); at B = 8, 12 heads and 1024 slots in bf16
// that is 25 MB per layer, 7.5 us at 3.35 TB/s. FLOPs are 4 per element
// read, far below the card's ratio. The TPU kernel streamed the whole static
// cache through VMEM with a block-diagonal Q so that the MXU saw (8, 128)
// tiles; here the cache is [B, nh, slots, 64] (the port's own layout), so
// one (b, h)'s slots are contiguous, and the design fills the card with
// bulk copies:
//   * a thread-block cluster per (b, h) of S = min(8, ceil(pos / 64), F)
//     blocks of 128 threads, F = the blocks that fit on the card at once
//     over B nh; block r takes the contiguous slot range [r c, (r + 1) c),
//     c = ceil(pos / S), clipped to [start[b], pos). At B = 8 and pos 1023
//     that is 768 blocks of at most 128 slots, at B = 32 768 blocks of 512
//     (S = 2): one wave, each block streaming its range;
//   * a block's range goes through shared memory in tiles of 64 slots, two
//     in flight: each tile of K and of V is one cp.async.bulk global ->
//     shared copy (TMA, no tensor map: slots are 128 or 256 bytes, so every
//     range starts and ends 16-byte aligned), completing on an mbarrier;
//     one thread issues them;
//   * one pass with an online softmax: a warp scores 16 slots of a tile, 8
//     lanes a slot, each lane 8 of q's 64 dims (three shuffles sum the dot
//     product), keeps a running max shared by the warp and, per lane, a sum
//     and 8 dims of p V read from the same tile; no score array;
//   * the warps' partials (m, l, acc[64]) meet in shared memory in warp
//     order; each block writes its partial into rank 0's shared memory
//     (distributed shared memory, once a cluster barrier armed at the start
//     shows every block running), one more cluster barrier, and rank 0 folds
//     them in rank order with the self term and writes out. Two calls give
//     the same bits. A partial with no valid slot has m = -inf and l = 0 and
//     is given weight 0 (never exp(-inf - -inf));
//   * programmatic dependent launch, when `chained` (K6 in the decode step,
//     between decode_qkv, which writes neither the caches nor `start`, and
//     decode_ffn): the bulk copies of the cached slots are issued before
//     griddepcontrol.wait, so they overlap decode_qkv; q, k_new and v_new
//     are read, and slot `pos` written, only after the wait. The kernel then
//     also triggers its dependents at once, so that decode_ffn's first
//     product streams its weights during K6;
//   * last, rank 0 writes k_new and v_new into slot `pos` of its (b, h): no
//     block reads that slot.
// q, k_new and v_new are column slices of the qkv projection [B, 3 nh 64],
// rows kv_stride elements apart; q is scaled after it is loaded, in f32
// (0.125 is a power of two: the same bits as a pre-scaled q).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int DH = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;        // slots a tile
constexpr int NST = 2;          // tiles in flight
constexpr int MAX_CLUSTER = 8;  // the portable maximum
constexpr int SLOTS_PER_BLOCK = 64;  // S = ceil(pos / 64), at most MAX_CLUSTER
constexpr float SCALE = 0.125f;      // dh^-0.5, exact
constexpr unsigned FULL = 0xffffffffu;

static_assert(TILE == WARPS * 16, "a warp scores 16 slots of a tile, 4 at a time");

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

// one arrival that also expects `bytes` of bulk copies to complete
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory by the TMA unit, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// programmatic dependent launch (no-ops when the launch did not ask for it)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}
__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// a block's partial of the softmax: running max, sum and p V
struct Partial {
  float m, l;
  float acc[DH];
};

// weight of a partial with maximum `m` against the overall maximum `mx`:
// 0 for an empty one (m = -inf), whatever mx is
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -CUDART_INF_F ? 0.f : expf(m - mx);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, T* kc, T* vc, const int* __restrict__ start,
                        const T* __restrict__ k_new, const T* __restrict__ v_new,
                        T* __restrict__ out, int nh, int L, int pos, int kv_stride, int chunk,
                        int chained) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [NST][TILE][DH]
  T* vs = ks + NST * TILE * DH;            // [NST][TILE][DH]
  __shared__ __align__(8) uint64_t bar[NST];
  __shared__ float wm[WARPS], wl[WARPS];
  __shared__ __align__(16) float wacc[WARPS][DH];
  __shared__ Partial parts[MAX_CLUSTER];  // rank 0's: every block's partial

  const int S = gridDim.x, rank = blockIdx.x;  // one cluster of S blocks per (b, h)
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 3, sub = lane & 7;  // a warp scores 4 slots at a time, 8 lanes a slot
  const int st = min(max(start[b], 0), pos);
  const int lo = max(rank * chunk, st), hi = min((rank + 1) * chunk, pos);
  const int n = max(hi - lo, 0);  // this block's valid slots
  const int ntiles = (n + TILE - 1) / TILE;
  const T* kb = kc + ((size_t)bh * L + lo) * DH;
  const T* vb = vc + ((size_t)bh * L + lo) * DH;

  auto issue = [&](int t) {  // tile t of the range into stage t % NST
    const int s = t % NST, slots = min(TILE, n - t * TILE);
    const uint32_t bytes = slots * DH * sizeof(T);
    mbar_expect(&bar[s], 2 * bytes);
    bulk_copy(ks + s * TILE * DH, kb + (size_t)t * TILE * DH, bytes, &bar[s]);
    bulk_copy(vs + s * TILE * DH, vb + (size_t)t * TILE * DH, bytes, &bar[s]);
  };

  // the cluster's blocks have started once this barrier phase completes
  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the cached slots first: they do not depend on the previous kernel
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int t = 0; t < min(NST, ntiles); ++t) issue(t);
  }
  if (chained) launch_dependents();
  wait_previous();

  float qv[8];
  load8(q + (size_t)b * kv_stride + h * DH + sub * 8, qv);
#pragma unroll
  for (int i = 0; i < 8; ++i) qv[i] *= SCALE;
  __syncthreads();  // the barriers are initialised

  float m = -CUDART_INF_F, l = 0.f, acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NST, slots = min(TILE, n - t * TILE);
    mbar_wait(&bar[s], (t / NST) & 1);
    const T* kt = ks + s * TILE * DH;
    const T* vt = vs + s * TILE * DH;
    float sc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = warp * 16 + u * 4 + g;
      float kv[8], dot = 0.f;
      if (j < slots) {
        load8(kt + j * DH + sub * 8, kv);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qv[i], kv[i], dot);
      }
      dot += __shfl_xor_sync(FULL, dot, 4);
      dot += __shfl_xor_sync(FULL, dot, 2);
      dot += __shfl_xor_sync(FULL, dot, 1);
      sc[u] = j < slots ? dot : -CUDART_INF_F;
    }
    float mt = fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3]));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 8));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 16));
    const float mn = fmaxf(m, mt);
    if (mn != -CUDART_INF_F) {  // warp-uniform: the warp has seen a valid slot
      const float alpha = expf(m - mn);  // 0 while m is -inf (acc and l are 0)
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = warp * 16 + u * 4 + g;
        if (j < slots) {
          const float p = expf(sc[u] - mn);
          float vv[8];
          load8(vt + j * DH + sub * 8, vv);
          l += p;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
        }
      }
      m = mn;
    }
    if (t + NST < ntiles) {
      __syncthreads();  // every warp is done with stage s
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(t + NST);
      }
    }
  }

  // the warp's 4 slot groups, then the warps in order
  l += __shfl_xor_sync(FULL, l, 8);
  l += __shfl_xor_sync(FULL, l, 16);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] += __shfl_xor_sync(FULL, acc[i], 8);
    acc[i] += __shfl_xor_sync(FULL, acc[i], 16);
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) wacc[warp][sub * 8 + i] = acc[i];
    if (sub == 0) {
      wm[warp] = m;
      wl[warp] = l;
    }
  }
  __syncthreads();
  if (S > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < DH) {  // the block's partial, into rank 0's shared memory
    float mx = wm[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, wm[w]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = weight(wm[w], mx);
      a = fmaf(c, wacc[w][tid], a);
      ls = fmaf(c, wl[w], ls);
    }
    Partial* dst = S > 1 ? cg::this_cluster().map_shared_rank(&parts[rank], 0) : &parts[0];
    dst->acc[tid] = a;
    if (tid == 0) {
      dst->m = mx;
      dst->l = ls;
    }
  }
  if (S > 1) {  // release the remote writes; rank 0 acquires them
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
  if (rank != 0) return;

  const T* kn = k_new + (size_t)b * kv_stride + h * DH;
  const T* vn = v_new + (size_t)b * kv_stride + h * DH;
  if (tid < DH) {
    // the self term q . k_new, 8 lanes of 8 dims as for a slot
    float kv[8], ss = 0.f;
    load8(kn + sub * 8, kv);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(qv[i], kv[i], ss);
    ss += __shfl_xor_sync(FULL, ss, 4);
    ss += __shfl_xor_sync(FULL, ss, 2);
    ss += __shfl_xor_sync(FULL, ss, 1);
    float mx = ss;
    for (int r = 0; r < S; ++r) mx = fmaxf(mx, parts[r].m);
    float a = 0.f, ls = 0.f;
    for (int r = 0; r < S; ++r) {  // in rank order: the same bits every call
      const float c = weight(parts[r].m, mx);
      a = fmaf(c, parts[r].acc[tid], a);
      ls = fmaf(c, parts[r].l, ls);
    }
    const float w = expf(ss - mx);
    a = fmaf(w, to_f(vn[tid]), a);
    ls += w;
    out[(size_t)b * nh * DH + h * DH + tid] = from_f<T>(a / ls);
  } else {
    const int d = tid - DH;  // the append: k and v of the token into slot pos
    kc[((size_t)bh * L + pos) * DH + d] = kn[d];
    vc[((size_t)bh * L + pos) * DH + d] = vn[d];
  }
}

// blocks of the kernel for T that fit on the card at once
template <typename T>
int resident_blocks(int smem) {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  if (!count[dev]) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_attention_kernel<T>, THREADS,
                                                  smem);
    count[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return count[dev];
}

template <typename T>
int launch(const T* q, T* kc, T* vc, const int* start, const T* k_new, const T* v_new, T* out,
           int B, int nh, int L, int pos, int kv_stride, int chained, void* stream) {
  const int smem = NST * 2 * TILE * DH * (int)sizeof(T);  // 32 KB in bf16, 64 KB in f32
  if (smem > 48 * 1024) {  // the f32 path; bf16 (the main path) needs no call
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // blocks a (b, h): at most one per 64 slots and 8 (a portable cluster), and
  // no more than fill the card once, so that no block waits for a second wave
  const int fill = max(1, resident_blocks<T>(smem) / (B * nh));
  const int S = max(1, min(min(MAX_CLUSTER, fill), (pos + SLOTS_PER_BLOCK - 1) / SLOTS_PER_BLOCK));
  const int chunk = (pos + S - 1) / S;
  cudaLaunchAttribute attrs[2];
  int na = 0;
  if (S > 1) {
    attrs[na].id = cudaLaunchAttributeClusterDimension;
    attrs[na].val.clusterDim.x = S;
    attrs[na].val.clusterDim.y = 1;
    attrs[na].val.clusterDim.z = 1;
    ++na;
  }
  if (chained) {
    attrs[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[na].val.programmaticStreamSerializationAllowed = 1;
    ++na;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, B * nh);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attrs;
  cfg.numAttrs = na;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T>, q, kc, vc, start,
                                             k_new, v_new, out, nh, L, pos, kv_stride, chunk,
                                             chained);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// q, k_new, v_new [B, nh*64], rows kv_stride elements apart (column slices
// of the qkv projection; q unscaled); k/v caches [B, nh, L, 64] (one layer),
// read at slots [start[b], pos) and written at slot pos; start [B] int32;
// out [B, nh*64]. chained != 0: the previous kernel of the stream writes
// neither the caches nor start, and K6 may start while it runs; the next
// may start during K6.
extern "C" int decode_attention_f32(const float* q, float* kc, float* vc, const int* start,
                                    const float* k_new, const float* v_new, float* out,
                                    int B, int nh, int L, int pos, int kv_stride, int chained,
                                    void* stream) {
  return launch(q, kc, vc, start, k_new, v_new, out, B, nh, L, pos, kv_stride, chained, stream);
}

extern "C" int decode_attention_bf16(const __nv_bfloat16* q, __nv_bfloat16* kc,
                                     __nv_bfloat16* vc, const int* start,
                                     const __nv_bfloat16* k_new, const __nv_bfloat16* v_new,
                                     __nv_bfloat16* out, int B, int nh, int L, int pos,
                                     int kv_stride, int chained, void* stream) {
  return launch(q, kc, vc, start, k_new, v_new, out, B, nh, L, pos, kv_stride, chained, stream);
}
