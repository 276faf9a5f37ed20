"""Attention micro-profile at Bark-fine shapes [B, 16, 1024, 64] bf16, on
an NVIDIA GPU.

    python scripts/profile_attn_micro_torch.py [--batch 16 --heads 16 --seq 1024 --dh 64 --layers 24]

Splits K5's time (``csrc/flash_attention_bf16.cu``, Bark-fine's attention,
bf16 on the tensor cores) between its two dot products and its online
softmax, by timing K8's ablations of it (``ops/attn_ablation.py``; not
valid attention, cost attribution only). Each ablation is K5's kernel with
one part taken out, at K5's tiles, copies and occupancy (the 128-key
steps and onepass excepted), so ``plain`` minus an ablation is what that
part costs in K5. Beside them the other attention routes:

  plain                  K5 itself
  full64                 K5's instantiation reached through K8's entry:
                         the check that the ablations are K5's design
  noexp64, noexp128      exp replaced by the identity, no rescale of the
                         accumulator, 64 / 128 keys a recurrence step (128:
                         64 score registers a thread, one block an SM)
  dotsonly64, dotsonly128  both products, the softmax replaced by a scaled copy
  onepass16, onepass32   exact softmax over whole score rows kept in shared
                         memory, 16 / 32 query rows a block, on the same
                         tensor-core building blocks
  xla                    materialised f32 scores, softmax, bf16 probabilities
  xla_bf16s              the same with exp taken in bf16 (bf16 probabilities)
  sdpa                   F.scaled_dot_product_attention, the library yardstick

Each case runs ``--layers`` times between two CUDA events after a warm-up,
alternating two sets of inputs, and is reported in ms per launch. q is
scaled by dh^-0.5 once, before the timing. Needs a CUDA device; imports no
JAX. Counterpart of ``scripts/profile_attn_micro.py``, whose chain of calls
against XLA's common-subexpression elimination has no counterpart in eager
PyTorch.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audiotoken_tpu_torch.ops.attn_ablation import KERNEL_TILES, attn_ablation  # noqa: E402
from audiotoken_tpu_torch.ops.flash_attention import flash_attention_plain  # noqa: E402

WARMUP = 2


def xla_attn(q, k, v):
    """Materialised-scores attention: f32 scores, f32 softmax, bf16
    probabilities, bf16 output (q pre-scaled)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def xla_bf16_scores(q, k, v):
    """The same with exp over bf16 shifted scores: the probabilities buffer
    is bf16, the row sums f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp((s - s.amax(dim=-1, keepdim=True)).to(torch.bfloat16))
    l = p.float().sum(dim=-1, keepdim=True)
    a = torch.matmul(p, v).float()
    return (a / l.clamp_min(1e-30)).to(q.dtype)


def cases():
    """(name, fn(q, k, v)) for every case, in the order printed."""
    out = [("plain", flash_attention_plain)]
    for mode, tiles in KERNEL_TILES.items():
        for tile in tiles:
            out.append((f"{mode}{tile}",
                        lambda q, k, v, m=mode, t=tile: attn_ablation(q, k, v, m, t)))
    out += [("xla", xla_attn), ("xla_bf16s", xla_bf16_scores),
            ("sdpa", lambda q, k, v: F.scaled_dot_product_attention(q, k, v, scale=1.0))]
    return out


def inputs(batch, heads, seq, dh, device, seed):
    """q (pre-scaled by dh^-0.5), k, v [batch, heads, seq, dh] bf16."""
    r = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((r.standard_normal((batch, heads, seq, dh)) * 0.3)
                                .astype(np.float32)).to(device).to(torch.bfloat16)
               for _ in range(3))
    return q * dh**-0.5, k, v


def micro_profile(batch=16, heads=16, seq=1024, dh=64, layers=24, device=None):
    """{case: ms per launch} on the current CUDA device (or ``device``);
    raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the attention micro-profile runs on an NVIDIA GPU")
    device = torch.device(device or "cuda")
    variants = [inputs(batch, heads, seq, dh, device, seed) for seed in range(2)]
    times = {}
    for name, fn in cases():
        for i in range(WARMUP):
            fn(*variants[i % 2])
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(layers):
            fn(*variants[i % 2])
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end) / layers
    return times


def k5_split(times):
    """K5's own time (``plain``) split by its ablations, in ms: the two
    products alone (``dotsonly64``), the softmax on top of them (``plain``
    minus ``dotsonly64``), and exp with the accumulator's rescale (``plain``
    minus ``noexp64``). Each ablation is K5's kernel at K5's tiles and
    occupancy with that part taken out."""
    plain = times["plain"]
    return {"dots_ms": times["dotsonly64"], "softmax_ms": plain - times["dotsonly64"],
            "exp_and_rescale_ms": plain - times["noexp64"]}


def split_lines(times):
    """K5 beside ``full64`` (one kernel: their times agree within run to
    run) and SDPA, and K5's split with each term's share of ``plain``."""
    plain = times["plain"]
    return [f"K5 (plain) {plain:.4f} ms, K5 through K8's entry (full64) "
            f"{times['full64']:.4f} ms, SDPA {times['sdpa']:.4f} ms",
            "K5 split: " + ", ".join(f"{k} {v:.4f} ({100 * v / plain:.1f} %)"
                                     for k, v in k5_split(times).items())]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--dh", type=int, default=64)
    ap.add_argument("--layers", type=int, default=24,
                    help="launches timed per case, between two CUDA events")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs on an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"shape [{args.batch}, {args.heads}, {args.seq}, {args.dh}] bf16, "
          f"{args.layers} launches a case", flush=True)
    times = micro_profile(args.batch, args.heads, args.seq, args.dh, args.layers)
    for name, ms in times.items():
        print(f"{name:12s}: {ms:8.4f} ms/layer  ({ms * args.layers:8.2f} ms / "
              f"{args.layers} calls)", flush=True)
    for line in split_lines(times):
        print(line, flush=True)


if __name__ == "__main__":
    main()
