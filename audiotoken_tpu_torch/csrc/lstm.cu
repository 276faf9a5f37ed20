// K2: one LSTM layer's recurrence as one persistent, grid-synchronised kernel.
//
// Replaces audiotoken_tpu/ops/lstm_pallas.py:lstm_layer_pallas (Pallas
// kernel `_lstm_kernel`), which lstm_skip_pallas wraps. Per step t:
//
//   gates = xi[t] + h @ Whh^T     torch gate order (i, f, g, o)
//   c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h     = sigmoid(o) * tanh(c)
//
// The input projection xi = x @ Wih^T + (bih + bhh) is a large matmul and
// stays outside, as it stayed with XLA in the JAX package. IEEE f32 FMAs,
// expf and tanhf throughout.
//
// What bounds it on this card: the steps are sequential. The roofline bound
// of the two layers at [8, 2250, 512] (4H x H FMAs a row a step: 1.127 ms at
// 67 TFLOP/s) ignores that dependency; the floor of a step is one grid-wide
// barrier (a few microseconds) plus one read of h from L2, so about 10-25 ms
// for the two layers of a 30 s row (4,500 steps) is what this design aims at.
// The design keeps Whh where it is used and moves only h:
//   * a cooperative launch of 128 blocks, one an SM, each owning 4 hidden
//     units: their 16 gate rows of Whh (32 KB) sit in registers for all T
//     steps. Warp w of a block owns unit w % 4 and the batch rows of its row
//     group (w / 4, 8 rows); lane l holds columns l*4 + 128*m (m < 4) of the
//     unit's four gate rows, 64 floats;
//   * each step reads h_{t-1} of the launch's rows (at most 32) from a
//     global ping-pong buffer [2, R, 512] into shared memory, with
//     L1-bypassing loads (other SMs wrote it), computes the warp's 4 x 8
//     partial dot products, reduces them across the warp with shuffles, and
//     lets the lane that ends up holding gate i of a (unit, row) update that
//     row's cell: c stays in that lane's register for the whole sequence.
//     xi of the next step is loaded one step ahead (it does not depend on
//     h). h_t goes to the ping-pong buffer and to `out`, then the grid
//     synchronises (cooperative_groups::this_grid().sync());
//   * one launch takes up to 32 batch rows; the wrapper runs a larger batch
//     as row groups.
// Layer 2's input projection is a matmul between the layers, so the two
// layers are not fused into one wavefront.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int H = 512;              // hidden size of the SEANet LSTMs
constexpr int UNITS = 4;            // hidden units a block owns
constexpr int BLOCKS = H / UNITS;   // 128: one an SM
constexpr int RW = 8;               // batch rows a warp computes
constexpr int MAX_ROWS = 32;        // batch rows a launch takes
constexpr int N = 4 * RW;           // dot products a warp reduces: 4 gates x RW rows
constexpr int KQ = H / 128;         // float4 columns of a gate row a lane holds
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

// NRG row groups of RW rows: the launch's R rows fit NRG * RW.
template <int NRG>
__global__ void __launch_bounds__(UNITS * NRG * 32, 1)
lstm_persistent_kernel(const float* __restrict__ xi, const float* __restrict__ whh,
                       float* __restrict__ out, float* __restrict__ hbuf, int R, int T) {
  extern __shared__ __align__(16) float4 hs[];  // [NRG * RW][H / 4]: h_{t-1}, zero past R
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int unit = blockIdx.x * UNITS + warp % UNITS;
  const int rg = warp / UNITS;
  constexpr size_t G = 4 * H;

  float4 w[4][KQ];  // the unit's gate rows g * H + unit, columns m * 128 + lane * 4 ..
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int m = 0; m < KQ; ++m)
      w[g][m] = __ldg(reinterpret_cast<const float4*>(whh + ((size_t)g * H + unit) * H +
                                                      m * 128 + lane * 4));

  // After the reduction lane l holds gate l % 4 of the group's row l / 4.
  const int row = rg * RW + lane / 4;
  const bool live = row < R;
  const bool owner = live && (lane & 3) == 0;
  const float* xrow = xi + (size_t)row * T * G + (lane & 3) * H + unit;
  float x_next = live ? __ldg(xrow) : 0.f;
  float c = 0.f;

  for (int e = threadIdx.x; e < NRG * RW * (H / 4); e += blockDim.x)
    hs[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < T; ++t) {
    const float x_cur = x_next;
    if (live && t + 1 < T) x_next = __ldg(xrow + (size_t)(t + 1) * G);
    if (t > 0) {
      const float4* src = reinterpret_cast<const float4*>(hbuf + (size_t)((t - 1) & 1) * R * H);
      for (int e = threadIdx.x; e < R * (H / 4); e += blockDim.x) hs[e] = __ldcg(src + e);
    }
    __syncthreads();

    float v[N];  // index r * 4 + g: gate g of the group's row r
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float4* hr = hs + (rg * RW + r) * (H / 4);
#pragma unroll
      for (int m = 0; m < KQ; ++m) {
        const float4 hv = hr[m * 32 + lane];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = v[r * 4 + g];
          s = fmaf(w[g][m].x, hv.x, s);
          s = fmaf(w[g][m].y, hv.y, s);
          s = fmaf(w[g][m].z, hv.z, s);
          s = fmaf(w[g][m].w, hv.w, s);
          v[r * 4 + g] = s;
        }
      }
    }
    reduce_step<16>(v, lane);
    reduce_step<8>(v, lane);
    reduce_step<4>(v, lane);
    reduce_step<2>(v, lane);
    reduce_step<1>(v, lane);
    const float pre = x_cur + v[0];
    const int q0 = lane & ~3;
    const float gi = __shfl_sync(FULL, pre, q0);
    const float gf = __shfl_sync(FULL, pre, q0 + 1);
    const float gg = __shfl_sync(FULL, pre, q0 + 2);
    const float go = __shfl_sync(FULL, pre, q0 + 3);
    if (owner) {
      c = sigmoid(gf) * c + sigmoid(gi) * tanhf(gg);
      const float h = sigmoid(go) * tanhf(c);
      out[((size_t)row * T + t) * H + unit] = h;
      hbuf[(size_t)(t & 1) * R * H + (size_t)row * H + unit] = h;
    }
    // every block's h_t is written, and every block is done with hs
    if (t + 1 < T) grid.sync();
  }
}

template <int NRG>
int launch(const float* xi, const float* whh, float* out, float* hbuf, int R, int T,
           cudaStream_t stream) {
  auto kernel = lstm_persistent_kernel<NRG>;
  const size_t smem = (size_t)NRG * RW * H * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {(void*)&xi, (void*)&whh, (void*)&out, (void*)&hbuf, (void*)&R, (void*)&T};
  // refused (cudaErrorCooperativeLaunchTooLarge) unless all blocks fit the card at once
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(BLOCKS), dim3(UNITS * NRG * 32),
                                    args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xi [R, T, 4H] f32 (input projections with both biases), whh [4H, H] f32
// (torch layout) -> out [R, T, H] f32, for H = 512 and 1 <= R <= 32; hbuf
// [2, R, H] f32 is scratch for the exchange of h between blocks.
extern "C" int lstm_layer_f32(const float* xi, const float* whh, float* out, float* hbuf, int R,
                              int T, void* stream) {
  if (R < 1 || R > MAX_ROWS || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((R + RW - 1) / RW) {
    case 1: return launch<1>(xi, whh, out, hbuf, R, T, s);
    case 2: return launch<2>(xi, whh, out, hbuf, R, T, s);
    case 3: return launch<3>(xi, whh, out, hbuf, R, T, s);
    default: return launch<4>(xi, whh, out, hbuf, R, T, s);
  }
}
