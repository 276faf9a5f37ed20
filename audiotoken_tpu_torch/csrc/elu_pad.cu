// The input of every SEANet conv after K1, in one pass:
//
//   out[b, c, :] = reflect_pad(ELU(x[b, c, :] + r[b, c, :]), left, right)
//
// with the residual r and the ELU each optional, and, on request, keep =
// x + r written contiguous for a 1x1 shortcut conv that reads it too; in
// f32 (elu_pad_f32) and in bf16 (elu_pad_bf16, the bf16 policy's convs).
// elu_pad_zero_f32 pads with zeros instead (Mimi's SEANet, pad_mode
// "constant"): ELU(0) = 0, so a zero pad before or after the ELU is one.
//
// Replaces no TPU kernel: on the TPU XLA fuses the residual add, the ELU
// and the pad into the convolution's operand, while the port's plain chain
// (nn/seanet.py before this kernel) wrote each step to device memory, a
// reflect pad even where the pad is (0, 0). The padding follows
// ops/conv.py:pad1d_reflect: a row not longer than its largest pad is
// zero-extended to max(left, right) + 1 samples first, and the extension
// is cut off again after the pad, so out has T + left + right samples.
//
// What bounds it on this card: bytes. It does one add and one ELU (by
// expm1f, as ATen's elu computes it: bit for bit, no fast math) a sample
// against 8 to 12 bytes moved, so the least time is (x + r + out + keep)
// bytes over 3.35 TB/s. In bf16 it computes as ATen does in its opmath:
// the add in f32, rounded to bf16 (x + r is a bf16 tensor there), the ELU
// in f32 on that, rounded once more; so both forms give the chain's bits.
// The design (a vector is 4 elements: 16 bytes in f32, 8 in bf16):
//   * a block takes one row (b, c) and a tile of 256 vectors of out, one
//     a thread; rows are flattened into blockIdx.x, so any number
//     of rows fits the grid. Small blocks that finish fast kept the most
//     bytes in flight: 4 vectors a thread (all loads issued before the
//     first store) ran 5-21 % slower than one at the acoustic cells'
//     shapes, 8 ran 25-65 % slower than 2, with more registers and fewer
//     blocks resident, and streaming (evict-first) stores gained nothing;
//   * out's rows of T + left + right elements start anywhere on its grid
//     of vectors. Every vector that lies whole inside the row is written
//     with one vector store; only the one or two vectors a row shares with
//     its neighbours are written element by element;
//   * the four input samples of an interior vector sit at one offset s
//     from x's (and r's) grid of vectors, the same for the whole row. They
//     are read as the one or two aligned vectors that hold them and
//     shifted in registers (load4), so no input is read element by element
//     either. Two neighbouring threads share a vector, which the second
//     finds in L1 or L2;
//   * the reflected head and tail (at most 15 samples a side) and a row of
//     x with a time stride other than 1 (a transposed view) take a gather
//     of single elements, with vector stores still;
//   * keep runs on its own grid (rows of T elements) over the same tile, so
//     its loads of x and r find the lines this block just read.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // vectors of out a block, one a thread

// An element type: its vector of 4 (V), and its loads and stores through
// f32, in which the kernel computes.
template <typename E>
struct Elem;

template <>
struct Elem<float> {
  using V = float4;
  static __device__ __forceinline__ float4 unpack(float4 v) { return v; }
  static __device__ __forceinline__ float4 pack(float4 v) { return v; }
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  using V = uint2;  // 4 bf16, the first in the low half of x
  static __device__ __forceinline__ float lo(unsigned w) { return __uint_as_float(w << 16); }
  static __device__ __forceinline__ float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
  static __device__ __forceinline__ unsigned bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float4 unpack(uint2 v) {
    return make_float4(lo(v.x), hi(v.x), lo(v.y), hi(v.y));
  }
  static __device__ __forceinline__ uint2 pack(float4 v) {
    return make_uint2(bits(v.x) | bits(v.y) << 16, bits(v.z) | bits(v.w) << 16);
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
  // x + r is a bf16 tensor in the chain: the sum rounds before the ELU
  static __device__ __forceinline__ float round(float v) { return lo(bits(v)); }
};

template <typename E>
struct Args {
  const E* x;       // [B, C, T] at strides (sb, sc, st)
  const E* r;       // [B, C, T] contiguous, or null
  E* out;           // [B * C, T + L + R] contiguous, aligned to a vector
  E* keep;          // [B * C, T] contiguous, aligned to a vector, or null
  long long sb, sc, st;
  int C, T, L, R;
  int Te;           // T zero-extended as pad1d_reflect does
  int tiles;        // tiles a row
};

template <bool ELU>
__device__ __forceinline__ float act(float v) {
  return ELU ? (v > 0.f ? v : expm1f(v)) : v;
}

// The four elements from p on: the aligned vectors that hold them, shifted
// by s = (p / 4) % 4 elements in registers. Reads no byte outside them.
template <typename E>
__device__ __forceinline__ float4 load4(const E* p, int s) {
  using V = typename Elem<E>::V;
  const V* a = reinterpret_cast<const V*>(p - s);
  const float4 lo = Elem<E>::unpack(__ldg(a));
  if (s == 0) return lo;
  const float4 hi = Elem<E>::unpack(__ldg(a + 1));
  if (s == 1) return make_float4(lo.y, lo.z, lo.w, hi.x);
  if (s == 2) return make_float4(lo.z, lo.w, hi.x, hi.y);
  return make_float4(lo.w, hi.x, hi.y, hi.z);
}

// x + r at sample i of the row, rounded to E as the chain's sum is
template <typename E, bool RES>
__device__ __forceinline__ float sum1(const Args<E>& a, const E* xr, const E* rr, int i) {
  const float v = Elem<E>::load(xr + i * a.st);
  return RES ? Elem<E>::round(v + Elem<E>::load(rr + i)) : v;
}

// out's sample j of the row: pad1d_reflect's index i = j - L reflected
// into the extended row, zero past the row's own T samples; under ZERO,
// zero outside the row's T samples
template <typename E, bool ELU, bool RES, bool ZERO>
__device__ __forceinline__ float gather(const Args<E>& a, const E* xr, const E* rr, int j) {
  int i = j - a.L;
  if (ZERO) {
    if (i < 0 || i >= a.T) return 0.f;
  } else {
    if (i < 0) i = -i;
    else if (i >= a.Te) i = 2 * (a.Te - 1) - i;
    if (i >= a.T) return 0.f;
  }
  return act<ELU>(sum1<E, RES>(a, xr, rr, i));
}

template <typename E>
__device__ __forceinline__ int shift(const E* p, long long first) {
  return static_cast<int>(
      (static_cast<long long>(reinterpret_cast<uintptr_t>(p) / sizeof(E)) - first) & 3);
}

template <typename E>
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(Elem<E>::round(a.x + b.x), Elem<E>::round(a.y + b.y),
                     Elem<E>::round(a.z + b.z), Elem<E>::round(a.w + b.w));
}

template <typename E, bool ELU, bool RES, bool KEEP, bool ZERO>
__global__ void __launch_bounds__(THREADS) elu_pad_kernel(const Args<E> a) {
  using V = typename Elem<E>::V;
  const int row = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const int b = row / a.C, c = row % a.C;
  const E* xr = a.x + b * a.sb + c * a.sc;
  const E* rr = RES ? a.r + static_cast<long long>(row) * a.T : nullptr;
  const int To = a.T + a.L + a.R;
  const bool unit = a.st == 1;
  const long long vt = static_cast<long long>(tile) * THREADS + threadIdx.x;

  // out: the row's elements start at o0; vector v holds elements 4v ..
  // 4v + 3, the row's samples j .. j + 3, x's samples j - L .. j - L + 3
  const long long o0 = static_cast<long long>(row) * To;
  const long long v = (o0 >> 2) + vt;
  const long long jl = 4 * v - o0;
  if (jl + 4 > 0 && jl < To) {
    const int j = static_cast<int>(jl);
    if (j >= 0 && j + 4 <= To) {
      float4 o;
      if (unit && j >= a.L && j + 4 <= a.L + a.T) {
        float4 w = load4(xr + (j - a.L), shift(xr, o0 + a.L));
        if (RES) w = add4<E>(w, load4(rr + (j - a.L), shift(rr, o0 + a.L)));
        o = make_float4(act<ELU>(w.x), act<ELU>(w.y), act<ELU>(w.z), act<ELU>(w.w));
      } else {
        o = make_float4(gather<E, ELU, RES, ZERO>(a, xr, rr, j),
                        gather<E, ELU, RES, ZERO>(a, xr, rr, j + 1),
                        gather<E, ELU, RES, ZERO>(a, xr, rr, j + 2),
                        gather<E, ELU, RES, ZERO>(a, xr, rr, j + 3));
      }
      reinterpret_cast<V*>(a.out)[v] = Elem<E>::pack(o);
    } else {
      // a vector shared with the next or previous row
      for (int k = 0; k < 4; ++k)
        if (j + k >= 0 && j + k < To)
          a.out[o0 + j + k] = Elem<E>::from(gather<E, ELU, RES, ZERO>(a, xr, rr, j + k));
    }
  }

  if (KEEP) {
    // keep: the row's elements start at k0; vector u holds x + r at 4u - k0
    const long long k0 = static_cast<long long>(row) * a.T;
    const long long u = (k0 >> 2) + vt;
    const long long il = 4 * u - k0;
    if (il + 4 > 0 && il < a.T) {
      const int i = static_cast<int>(il);
      if (i >= 0 && i + 4 <= a.T) {
        float4 w = unit ? load4(xr + i, shift(xr, k0))
                        : make_float4(Elem<E>::load(xr + i * a.st),
                                      Elem<E>::load(xr + (i + 1) * a.st),
                                      Elem<E>::load(xr + (i + 2) * a.st),
                                      Elem<E>::load(xr + (i + 3) * a.st));
        if (RES) w = add4<E>(w, load4(rr + i, shift(rr, k0)));
        reinterpret_cast<V*>(a.keep)[u] = Elem<E>::pack(w);
      } else {
        for (int k = 0; k < 4; ++k)
          if (i + k >= 0 && i + k < a.T)
            a.keep[k0 + i + k] = Elem<E>::from(sum1<E, RES>(a, xr, rr, i + k));
      }
    }
  }
}

template <typename E, bool ELU, bool RES, bool KEEP, bool ZERO>
int launch(const Args<E>& a, unsigned blocks, cudaStream_t s) {
  elu_pad_kernel<E, ELU, RES, KEEP, ZERO><<<blocks, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, bool ZERO>
int run(const E* x, const E* r, E* out, E* keep, int B, int C, int T, int L, int R, int sb,
        int sc, int st, int elu, void* stream) {
  constexpr uintptr_t align = sizeof(typename Elem<E>::V);
  if (B < 1 || C < 1 || T < 1 || L < 0 || R < 0 || reinterpret_cast<uintptr_t>(out) % align ||
      (keep && reinterpret_cast<uintptr_t>(keep) % align))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<E> a{x, r, out, keep, sb, sc, st, C, T, L, R, 0, 0};
  const int extra = (L > R ? L : R) - T + 1;
  a.Te = T + (extra > 0 ? extra : 0);
  const long long To = static_cast<long long>(T) + L + R;
  a.tiles = static_cast<int>(((To + 3) / 4 + 1 + THREADS - 1) / THREADS);
  const long long blocks = static_cast<long long>(B) * C * a.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(blocks);
  switch ((elu ? 4 : 0) | (r ? 2 : 0) | (keep ? 1 : 0)) {
    case 0: return launch<E, false, false, false, ZERO>(a, n, s);
    case 1: return launch<E, false, false, true, ZERO>(a, n, s);
    case 2: return launch<E, false, true, false, ZERO>(a, n, s);
    case 3: return launch<E, false, true, true, ZERO>(a, n, s);
    case 4: return launch<E, true, false, false, ZERO>(a, n, s);
    case 5: return launch<E, true, false, true, ZERO>(a, n, s);
    case 6: return launch<E, true, true, false, ZERO>(a, n, s);
    default: return launch<E, true, true, true, ZERO>(a, n, s);
  }
}

}  // namespace

// x [B, C, T] at element strides (sb, sc, st); r [B, C, T] contiguous or
// null; out [B, C, T + L + R] and keep [B, C, T] (or null) contiguous and
// aligned to a vector of 4 elements. elu: 0 or 1.
extern "C" int elu_pad_f32(const float* x, const float* r, float* out, float* keep, int B, int C,
                           int T, int L, int R, int sb, int sc, int st, int elu, void* stream) {
  return run<float, false>(x, r, out, keep, B, C, T, L, R, sb, sc, st, elu, stream);
}

// As elu_pad_f32, with zeros in place of the reflection.
extern "C" int elu_pad_zero_f32(const float* x, const float* r, float* out, float* keep, int B,
                                int C, int T, int L, int R, int sb, int sc, int st, int elu,
                                void* stream) {
  return run<float, true>(x, r, out, keep, B, C, T, L, R, sb, sc, st, elu, stream);
}

extern "C" int elu_pad_bf16(const __nv_bfloat16* x, const __nv_bfloat16* r, __nv_bfloat16* out,
                            __nv_bfloat16* keep, int B, int C, int T, int L, int R, int sb, int sc,
                            int st, int elu, void* stream) {
  return run<__nv_bfloat16, false>(x, r, out, keep, B, C, T, L, R, sb, sc, st, elu, stream);
}
