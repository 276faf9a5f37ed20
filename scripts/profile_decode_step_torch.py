"""Where the time of K7 (the GPT decode step's products) goes, on an NVIDIA GPU.

    python scripts/profile_decode_step_torch.py [--batch 8]

At the semantic decode's GPT width (768, MLP 3072, bf16) it prints:
  * the device time of one trivial kernel (an add on 8 floats), queued
    behind a device sleep: the floor that every kernel launch costs here;
  * one ``decode_qkv`` and one ``decode_ffn`` call, each with weights that
    no earlier call of the run read (cold), queued behind a device sleep
    under ``torch.profiler``: every kernel's start and end relative to the
    call's first kernel, and the call's span. The profiler slows the host's
    launches enough that the device may wait between two kernels even so:
    read each kernel's own duration, and the span as an upper bound. A
    kernel that starts before its predecessor ends was launched early
    (programmatic dependent launch) and waits inside;
  * the chain of one decode step's layers, decode_qkv -> K6 -> decode_ffn
    over 12 layers with a 1024-slot cache at slot 1023, weights cold, its
    device time a step with the queue filled behind a device sleep: K6
    chained by programmatic dependent launch (as the decode step runs it)
    and launched after its predecessor ends, in turns, so that the two can
    be compared within one run.
Needs a CUDA device; imports no JAX.
"""

import argparse
import os
import statistics
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audiotoken_tpu_torch.ops.decode_attention import decode_attention  # noqa: E402
from audiotoken_tpu_torch.ops.decode_step import decode_ffn, decode_qkv  # noqa: E402

C, SETS = 768, 8  # 8 layers' weights: 113 MB, more than the 50 MB L2
N_LAYER, NH, SLOTS = 12, 12, 1024


def floor_us(dev, n=200):
    """Device time of one trivial kernel, the queue filled behind a sleep."""
    x = torch.zeros(8, device=dev)
    for _ in range(3):
        x.add_(1)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(n):
        x.add_(1)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def timeline(fn):
    """The device kernels of one ``fn()`` call, queued behind a device
    sleep: (name, start us, end us) relative to the first kernel's start."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(5_000_000)
        fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type.name == "CUDA" and "sleep" not in e.name
                 and "spin" not in e.name), key=lambda e: e.time_range.start)
    t0 = ev[0].time_range.start
    name = lambda e: e.name.replace("(anonymous namespace)::", "").split("(")[0]  # noqa: E731
    return [(name(e), e.time_range.start - t0, e.time_range.end - t0) for e in ev]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs on an NVIDIA GPU")
    dev, dt, B = torch.device("cuda", 0), torch.bfloat16, args.batch
    g = torch.Generator(device=dev).manual_seed(0)

    def w(*shape, scale=0.02):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    layers = [dict(qkv=w(3 * C, C), out=w(C, C), fc=w(4 * C, C), proj=w(C, 4 * C))
              for _ in range(SETS)]
    x, a = w(B, C, scale=1.0), w(B, C, scale=1.0)
    ln = 1 + w(C, scale=0.1)
    print(f"{torch.cuda.get_device_name(0)}; B={B}, 768 wide, bf16")
    print(f"  one trivial kernel: {floor_us(dev):.2f} us of device time")
    for i in range(2):  # warm-up: the build, the launch paths
        decode_qkv(x, ln, None, layers[i]["qkv"])
        decode_ffn(x, a, layers[i]["out"], ln, None, layers[i]["fc"], layers[i]["proj"])
    for name, fn in (("decode_qkv", lambda L: decode_qkv(x, ln, None, L["qkv"])),
                     ("decode_ffn", lambda L: decode_ffn(x, a, L["out"], ln, None, L["fc"],
                                                         L["proj"]))):
        spans = []
        for L in layers[2:]:  # each call's weights cold
            tl = timeline(lambda: fn(L))
            spans.append(max(t1 for _, _, t1 in tl))
        print(f"  {name}: span {sorted(spans)[len(spans) // 2]:.2f} us with the host's gaps "
              f"(median of {len(spans)} calls); kernels of the last call:")
        for kname, t0, t1 in tl:
            print(f"    {kname:20s} {t0:6.2f} .. {t1:6.2f} us ({t1 - t0:.2f})")
    times = {True: [], False: []}
    for i in range(10):  # in turns, each side first in half the pairs
        for chained in ((False, True) if i % 2 else (True, False)):
            times[chained].append(step_us(dev, layers, x, ln, B, chained))
    for chained in (True, False):
        print(f"  decode step, 12 layers of qkv -> K6 -> ffn, slot {SLOTS - 1}, K6 "
              f"{'chained' if chained else 'after its predecessor'}: median "
              f"{statistics.median(times[chained]):.1f} us of device time (runs "
              + ", ".join(f"{t:.1f}" for t in times[chained]) + ")")
    wins = sum(c < u for c, u in zip(times[True], times[False]))
    print(f"  chained faster in {wins} of {len(times[True])} pairs")


def step_us(dev, layers, x, ln, B, chained, n=6):
    """Device time of one decode step's 12 layers of qkv -> K6 -> ffn, in
    us, the queue filled behind a device sleep (``n`` steps, 84 launches
    each: more would fill the launch queue, and the host would show)."""
    g = torch.Generator(device=dev).manual_seed(1)
    kc = [torch.randn((B, NH, SLOTS, 64), generator=g, device=dev).to(x.dtype)
          for _ in range(N_LAYER)]
    vc = [torch.randn((B, NH, SLOTS, 64), generator=g, device=dev).to(x.dtype)
          for _ in range(N_LAYER)]
    start = torch.zeros(B, dtype=torch.int32, device=dev)

    def step():
        h = x
        for li in range(N_LAYER):
            L = layers[li % len(layers)]
            qkv = decode_qkv(h, ln, None, L["qkv"])
            a = decode_attention(qkv[:, :C], kc[li], vc[li], start, SLOTS - 1, qkv[:, C:2 * C],
                                 qkv[:, 2 * C:], chained=chained)
            h = decode_ffn(h, a, L["out"], ln, None, L["fc"], L["proj"])

    step()
    torch.cuda.synchronize()
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start_ev.record()
    for _ in range(n):
        step()
    end_ev.record()
    end_ev.synchronize()
    return start_ev.elapsed_time(end_ev) * 1e3 / n


if __name__ == "__main__":
    main()
