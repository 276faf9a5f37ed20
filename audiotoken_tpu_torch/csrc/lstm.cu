// K2: one LSTM layer's recurrence, h and c kept on chip for all steps.
//
// Replaces audiotoken_tpu/ops/lstm_pallas.py:lstm_layer_pallas (Pallas
// kernel `_lstm_kernel`), which lstm_skip_pallas wraps. Per step t:
//
//   gates = xi[t] + h @ Whh^T     torch gate order (i, f, g, o)
//   c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h     = sigmoid(o) * tanh(c)
//
// The input projection xi = x @ Wih^T + (bih + bhh) is a large matmul and
// stays outside, as it stayed with XLA in the JAX package.
//
// What bounds it on this card: the steps are sequential, and each needs all
// of Whh ([4H, H] f32, 4 MB at H = 512), which does not fit in one SM's
// shared memory or registers. This simple design runs one block per pair
// of batch rows through all T steps and streams Whh from L2 (where it stays
// resident) at every step, so a step costs one SM's read of 4 MB from L2:
// that read, not the 2 x 4H x H FMAs, bounds it. Two rows per block is the
// measured best of 1, 2, 4 and 8 (fewer rows spread a batch over more SMs,
// each pulling its own copy of Whh from L2); 32 warps keep enough loads in
// flight. h is double-buffered in shared memory (one barrier per step) and
// c stays in shared memory. A warp owns one hidden unit at a time: it
// computes that unit's four gate rows for both batch rows (8 dot products,
// reduced across the warp), so the cell update needs no second pass.
// Spreading Whh over many SMs with a grid-wide barrier per step is the
// faster, persistent design, left for later.

#include <cuda_runtime.h>

namespace {

constexpr int H = 512;       // hidden size of the SEANet LSTMs
constexpr int ROWS = 2;      // batch rows per block
constexpr int N = 4 * ROWS;  // dot products per hidden unit: 4 gates x ROWS
constexpr int WARPS = 32;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// One butterfly step of reducing N partial sums across the warp. While
// S >= N every lane adds its partner's copy of all N values; below that,
// the lanes with bit S set keep index i + S and the others index i. After
// the steps 16, 8, 4, 2, 1, v[0] of lane l holds the total of index l % N.
template <int S>
__device__ __forceinline__ void reduce_step(float (&v)[N], int lane) {
  if constexpr (S >= N) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(FULL, v[i], S);
  } else {
    const bool upper = (lane & S) != 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float send = upper ? v[i] : v[i + S];
      const float keep = upper ? v[i + S] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, S);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
lstm_layer_kernel(const float* __restrict__ xi, const float* __restrict__ whh,
                  float* __restrict__ out, int B, int T) {
  __shared__ __align__(16) float hbuf[2][ROWS][H];
  __shared__ float cbuf[ROWS][H];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * ROWS;
  constexpr size_t G = 4 * H;

  for (int e = threadIdx.x; e < ROWS * H; e += THREADS) {
    hbuf[0][e / H][e % H] = 0.f;
    cbuf[e / H][e % H] = 0.f;
  }
  __syncthreads();

  // Lane l reduces dot product q = l % N: gate q / ROWS, batch row q % ROWS.
  const int q = lane % N;
  const int my_gate = q / ROWS;
  const int my_row = q % ROWS;
  const bool loads_xi = lane < N && b0 + my_row < B;

  for (int t = 0; t < T; ++t) {
    const float(*hp)[H] = hbuf[t & 1];
    float(*hn)[H] = hbuf[(t + 1) & 1];
    for (int j = warp; j < H; j += WARPS) {
      // Load xi first: it does not depend on h.
      const float xv =
          loads_xi ? __ldg(xi + ((size_t)(b0 + my_row) * T + t) * G + my_gate * H + j) : 0.f;
      float v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = 0.f;
#pragma unroll
      for (int m = 0; m < H / 128; ++m) {
        const int d = m * 128 + lane * 4;
        float4 wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wv[g] = __ldg(reinterpret_cast<const float4*>(whh + ((size_t)g * H + j) * H + d));
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(&hp[r][d]);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float s = v[g * ROWS + r];
            s = fmaf(wv[g].x, hv.x, s);
            s = fmaf(wv[g].y, hv.y, s);
            s = fmaf(wv[g].z, hv.z, s);
            s = fmaf(wv[g].w, hv.w, s);
            v[g * ROWS + r] = s;
          }
        }
      }
      reduce_step<16>(v, lane);
      reduce_step<8>(v, lane);
      reduce_step<4>(v, lane);
      reduce_step<2>(v, lane);
      reduce_step<1>(v, lane);
      const float pre = xv + v[0];
      const int row = lane % ROWS;
      const float gi = __shfl_sync(FULL, pre, row);
      const float gf = __shfl_sync(FULL, pre, ROWS + row);
      const float gg = __shfl_sync(FULL, pre, 2 * ROWS + row);
      const float go = __shfl_sync(FULL, pre, 3 * ROWS + row);
      if (lane < ROWS && b0 + lane < B) {
        const float c = sigmoid(gf) * cbuf[lane][j] + sigmoid(gi) * tanhf(gg);
        const float h = sigmoid(go) * tanhf(c);
        cbuf[lane][j] = c;
        hn[lane][j] = h;
        out[((size_t)(b0 + lane) * T + t) * H + j] = h;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// xi [B, T, 4H] f32 (input projections with both biases), whh [4H, H] f32
// (torch layout) -> out [B, T, H] f32, for H = 512.
extern "C" int lstm_layer_f32(const float* xi, const float* whh, float* out,
                              int B, int T, void* stream) {
  const int blocks = (B + ROWS - 1) / ROWS;
  lstm_layer_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xi, whh, out, B, T);
  return static_cast<int>(cudaGetLastError());
}
