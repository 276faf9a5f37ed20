"""K3 (csrc/rvq.cu) at each cluster split of the codewords, on an NVIDIA GPU:
the measurement behind ``ops/rvq.py:rvq_plan``.

    python scripts/profile_rvq_torch.py [--rounds 9]

For 1 to 32 rows of 30 s (N = 2250 to 72000 latent frames, 16 codebooks
of 1024 x 128) it launches K3 with the codewords split
over clusters of 1, 2 and 4 blocks, in alternating order, each round timing
every split with CUDA events around one call. Prints the card's name and
power limit, then per N and split the median and the fastest round in ms,
the row tiles an SM, which split ``rvq_plan`` picks, and that every split
gave the same codes (and their agreement with the plain version). Needs a
CUDA device and ``nvcc``; imports no JAX.
"""

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audiotoken_tpu_torch.nn.rvq import RVQConfig, init_codebooks  # noqa: E402
from audiotoken_tpu_torch.ops import rvq  # noqa: E402


def _ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=9)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs on an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cb = torch.from_numpy(init_codebooks(np.random.default_rng(0), RVQConfig())).to(dev)
    for rows in (1, 2, 3, 4, 6, 8, 12, 16, 32):
        N = rows * 2250
        z = torch.from_numpy(
            np.random.default_rng(N).standard_normal((1, N, 128)).astype(np.float32)).to(dev)
        codes = {s: rvq._launch(cb, z, 16, s) for s in rvq.SPLITS}  # also the warm-up
        same = all(torch.equal(codes[s], codes[1]) for s in rvq.SPLITS)
        agree = (codes[1] == rvq.rvq_encode_plain(cb, z, 16)).float().mean().item()
        times = {s: [] for s in rvq.SPLITS}
        for r in range(args.rounds):
            order = rvq.SPLITS if r % 2 == 0 else rvq.SPLITS[::-1]
            for s in order:
                times[s].append(_ms(lambda: rvq._launch(cb, z, 16, s)))
        tiles = -(-N // rvq.BLOCK_ROWS)
        cells = "  ".join(f"split {s}: {statistics.median(times[s]):.3f} ms "
                          f"(fastest {min(times[s]):.3f})" for s in rvq.SPLITS)
        print(f"K3 N={N} ({rows} x 30 s, {tiles} row tiles, {tiles / sms:.2f} an SM): {cells}  "
              f"plan: split {rvq.rvq_plan(N, sms)}  every split the same codes: {same}  "
              f"agreement with plain {agree:.6f}")


if __name__ == "__main__":
    main()
