"""The tensor cores' rate through mma.sync on an NVIDIA GPU: the ceiling of
the port's kernels that use it (K3 and K4 in 3xTF32, K5 and K7 in bf16).

    python scripts/profile_mma_rate_torch.py

Builds one small CUDA kernel with ``nvcc`` (into a temporary directory)
that issues nothing but ``mma.sync`` on register operands: m16n8k8 TF32
and m16n8k16 bf16, with 4 or 8 independent accumulators a warp, 4, 8 or 16
warps a block and two blocks an SM. Prints each case's rate in TFLOP/s
(CUDA events around one launch, after a warm-up), beside the card's name
and power limit. Needs a CUDA device and ``nvcc``; imports no JAX.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile

import torch

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <bool BF>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if (BF)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CHAINS, bool BF>
__global__ void bench(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float d[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma<BF>(d[c], a, i, c);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// milliseconds of one launch of `blocks` blocks of `threads` threads
extern "C" float run(int chains, int bf, int blocks, int threads, int iters) {
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  auto go = [&]() {
    if (bf) {
      if (chains == 4) bench<4, true><<<blocks, threads>>>(out, iters);
      else bench<8, true><<<blocks, threads>>>(out, iters);
    } else {
      if (chains == 4) bench<4, false><<<blocks, threads>>>(out, iters);
      else bench<8, false><<<blocks, threads>>>(out, iters);
    }
  };
  go();
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  go();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaFree(out);
  return ms;
}
"""


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs on an NVIDIA GPU")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    tmp = tempfile.mkdtemp()
    try:
        src, so = os.path.join(tmp, "mma_rate.cu"), os.path.join(tmp, "mma_rate.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", so, src], check=True)
        lib = ctypes.CDLL(so)
        lib.run.restype = ctypes.c_float
        lib.run.argtypes = [ctypes.c_int] * 5
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        iters = 4096
        for bf, name, flop in ((0, "tf32 m16n8k8", 2048), (1, "bf16 m16n8k16", 4096)):
            for chains in (4, 8):
                for warps in (4, 8, 16):
                    ms = lib.run(chains, bf, 2 * sms, 32 * warps, iters)
                    total = 2 * sms * warps * iters * chains * flop
                    print(f"{name}: {chains} accumulators a warp, {warps} warps a block, "
                          f"2 blocks an SM: {total / ms / 1e9:.1f} TFLOP/s")
    finally:
        shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
