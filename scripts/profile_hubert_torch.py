"""Where the time of one semantic_s encode goes, on an NVIDIA GPU.

    python scripts/profile_hubert_torch.py [--batch 8] [--attn flash|xla]

Builds the port's ``HubertEncoder`` (random weights, seed 0, ``highest``),
warms it up on ``--batch`` rows of 30 s int16 PCM, then encodes them once
more under ``torch.profiler``. Prints the wall time and real-time factor
(``runtime/profiling.py:StageTimers``, synchronised), the device busy time
(the union of the kernels' spans) and so the device's idle share, then the
kernels that took the most device time. Needs a CUDA device; imports no JAX.
"""

import argparse
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audiotoken_tpu_torch import HubertEncoder  # noqa: E402
from audiotoken_tpu_torch.runtime.profiling import StageTimers  # noqa: E402

SR, SECONDS = 16_000, 30


def _union_s(spans):
    """Seconds covered by the union of (start, end) spans in microseconds:
    device work that overlaps (cuDNN and cuBLAS may use side streams)
    counts once."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--attn", choices=["flash", "xla"], default=None,
                    help="attention form (default: HubertConfig's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    enc = HubertEncoder(weights="random", seed=0, device=dev, attn_impl=args.attn)
    rng = np.random.default_rng(10)
    pcm = (rng.standard_normal((args.batch, SECONDS * SR)) * 3000).clip(-32768, 32767)
    pcm = pcm.astype(np.int16)
    enc(pcm)  # warm-up
    torch.cuda.synchronize(dev)

    timers = StageTimers(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with timers.span("encode", sync=True):
            enc(pcm)
    wall = timers.totals["encode"]
    busy = _union_s([(e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type.name == "CUDA"])
    print(f"{torch.cuda.get_device_name(0)}; HubertEncoder attn_impl="
          f"{enc.model_cfg.attn_impl!r}, {args.batch} x {SECONDS} s int16")
    print(f"  wall {wall * 1e3:.1f} ms under the profiler (RTFx {args.batch * SECONDS / wall:.1f}), "
          f"device busy {busy * 1e3:.1f} ms, idle {100 * (1 - busy / wall):.1f} %")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=20))


if __name__ == "__main__":
    main()
