"""Mimi's encoder with its linears on ``linear_3xtf32``: evidence for wiring
the 3xTF32 GEMM into ``nn/mimi.py``, which this script does not do.

Inside this process only, ``nn/mimi.py``'s ``F.linear`` (the transformer's
``in_proj``, ``out_proj``, ``fc1`` and ``fc2``, and the two projections
before the RVQ) is replaced by ``ops/linear.py``'s dispatch: the kernel
where ``kernel_takes`` holds (a CUDA f32 input with the TF32 switch off),
``F.linear`` elsewhere. It reads, on the card:

  * ``code_gap`` of ``mimi.encode.b32x30s`` on each seed through
    ``portbench/calibrate.py`` with the kernel, beside the program as it is
    and the ``high`` control, against the configuration's limit;
  * one B = 32 x 30 s forward's time with and without the kernel, in
    turns, and the kernel's launches a forward.

    python scripts/mimi_linear_3xtf32_torch.py --seeds 3141592653,2718281828

One JSON line a seed, then one of the times and a summary.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from audiotoken_tpu_torch import AudioToken, Tokenizers  # noqa: E402
from audiotoken_tpu_torch.nn import mimi  # noqa: E402
from audiotoken_tpu_torch.ops.linear import kernel_takes, linear_3xtf32  # noqa: E402
from portbench import calibrate  # noqa: E402

CELL = "mimi.encode.b32x30s"


class _Functional:
    """``torch.nn.functional`` for ``nn/mimi.py``, its ``linear`` sent to the
    kernel while ``on``."""

    on = False

    def __getattr__(self, name):
        return getattr(F, name)

    def linear(self, x, weight, bias=None):
        if self.on and kernel_takes(x, weight):
            return linear_3xtf32(x, weight, bias)
        return F.linear(x, weight, bias)


def _forward_ms(dev, reps):
    """Walls of one B = 32 x 30 s forward without and with the kernel, in
    turns (off, on, on, off ...), and the kernel's launches a forward."""
    at = AudioToken(Tokenizers.mimi, num_codebooks=32, weights="random", device=dev)
    at.load_encoder()
    enc = at.encoder
    pcm = (np.random.default_rng(9).standard_normal((32, 30 * 24_000)) * 3000).clip(
        -32768, 32767).astype(np.int16)
    walls = {False: [], True: []}
    launches = 0
    for on in (False, True):
        mimi.F.on = on
        enc(pcm)  # warm up
    for i in range(reps):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            mimi.F.on = on
            n0 = linear_3xtf32.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc(pcm)
            torch.cuda.synchronize()
            walls[on].append(1e3 * (time.perf_counter() - t0))
            if on:
                launches = linear_3xtf32.launches - n0
    mimi.F.on = False
    return walls, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="3141592653,2718281828,1618033988",
                    help="comma-separated seeds of the cell's calibration")
    ap.add_argument("--reps", type=int, default=4, help="forwards timed each way")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this script measures the card: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    mimi.F = _Functional()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seeds = [int(s) for s in args.seeds.split(",")]
    gaps = {}
    for on in (True, False):
        mimi.F.on = on
        rows, limits = calibrate.readings(bench, CELL, seeds)
        gaps[on] = rows
        torch.cuda.empty_cache()
    mimi.F.on = False
    for (seed, kernel, ctrl), (_, program, _) in zip(gaps[True], gaps[False]):
        print(json.dumps({"seed": seed, "kernel": kernel, "program": program, "control": ctrl}),
              flush=True)
    walls, launches = _forward_ms(torch.device("cuda"), args.reps)
    cublas, kernel = statistics.median(walls[False]), statistics.median(walls[True])
    print(json.dumps({"forward_ms": {"cublas": walls[False], "kernel": walls[True]},
                      "launches_a_forward": launches}), flush=True)
    print(json.dumps({
        "code_gap": {"kernel": max(k["code_gap"] for _, k, _ in gaps[True]),
                     "program": max(p["code_gap"] for _, p, _ in gaps[False]),
                     "control": min(c["code_gap"] for _, _, c in gaps[True]),
                     "limit": limits["code_gap"]},
        "median_ms": {"cublas": cublas, "kernel": kernel, "saved": cublas - kernel}}))


if __name__ == "__main__":
    main()
