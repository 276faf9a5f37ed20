"""Where the time of the Bark-fine stage goes, on an NVIDIA GPU.

    python scripts/profile_fine_stages_torch.py [--batch 8]

Bark-fine at its real size (24 layers x 1024, 16 heads, 8 codebooks, bf16,
random weights from seed 0) on windows of 1024 frames, as the semantic
decode runs it. Device times (CUDA events, a warm-up, the median of 5):
  * one forward (24 layers + the f32 lm_head) with K5 as its attention, and
    with K5's plain version in its place; the 24 K5 calls of a forward
    alone, the lm_head alone;
  * the sampling alone on the [B, 1024, 1024] logits of one codebook
    (softmax at temperature 0.5, one draw a frame);
  * the 6-codebook cascade of one window (``_fill_window``: six forwards,
    six samplings), and the whole fine stage on 8 rows of 250 semantic ids'
    worth of coarse frames (376, one window) and of 1500 frames (3 windows),
    host included.
Needs a CUDA device; imports no JAX.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audiotoken_tpu_torch.decoders import _module_from_state  # noqa: E402
from audiotoken_tpu_torch.nn import bark_fine  # noqa: E402
from audiotoken_tpu_torch.nn.bark_fine import (  # noqa: E402
    BarkFine,
    BarkFineConfig,
    BarkFineGenerator,
    init_bark_fine_params,
)
from audiotoken_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_plain,
    noncausal_attention_plain,
)
from audiotoken_tpu_torch.weights import bark_fine_from_numpy  # noqa: E402


def cuda_ms(fn, warmup=2, reps=5):
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    with torch.inference_mode():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_s(fn, reps=3):
    """Median wall time of ``fn`` in s, synchronised."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs on an NVIDIA GPU")
    dev, B = torch.device("cuda", 0), args.batch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0], flush=True)
    cfg = BarkFineConfig()
    state = bark_fine_from_numpy(init_bark_fine_params(np.random.default_rng(0), cfg))
    model = _module_from_state(BarkFine, cfg, state, dev, torch.bfloat16)
    gen_obj = BarkFineGenerator(model)
    rng = np.random.default_rng(1)
    W, C, nh = cfg.block_size, cfg.n_embd, cfg.n_head
    buf = torch.from_numpy(rng.integers(0, 1024, (B, W, cfg.n_codes_total))).to(dev)
    print(f"Bark-fine 24 x 1024, bf16, B={B} windows of {W} frames", flush=True)

    fwd = cuda_ms(lambda: model(buf, 2))
    bark_fine.flash_attention_plain = lambda q, k, v, precision: noncausal_attention_plain(q, k, v)
    try:
        fwd_plain = cuda_ms(lambda: model(buf, 2))
    finally:
        bark_fine.flash_attention_plain = flash_attention_plain
    q, k, v = (torch.randn((B, nh, W, C // nh), device=dev).to(torch.bfloat16) * 0.125
               for _ in range(3))
    k5 = cuda_ms(lambda: [flash_attention_plain(q, k, v) for _ in range(cfg.n_layer)])
    x = torch.randn((B, W, C), device=dev).to(torch.bfloat16)
    head = model.lm_heads[0]
    head_ms = cuda_ms(lambda: F.linear(x.float(), head.float()))
    print(f"forward (24 layers + lm_head) with K5 {fwd:.3f} ms; with the plain attention "
          f"{fwd_plain:.3f} ms; K5 x 24 alone {k5:.3f} ms ({100 * k5 / fwd:.1f} % of the "
          f"forward); the f32 lm_head alone {head_ms:.3f} ms", flush=True)

    logits = torch.randn((B, W, cfg.vocab_size), device=dev)[:, :, :cfg.codebook_size]
    g = torch.Generator(device=dev).manual_seed(0)

    def sample():
        probs = torch.softmax(logits / 0.5, dim=-1)
        return torch.multinomial(probs.reshape(-1, cfg.codebook_size), 1, generator=g)

    print(f"sampling alone on [{B}, {W}, {cfg.codebook_size}] logits {cuda_ms(sample):.3f} ms",
          flush=True)
    cascade = cuda_ms(lambda: gen_obj._fill_window(buf.clone(), 0, 2, 0.5, g), reps=3)
    print(f"6-codebook cascade of one window {cascade:.3f} ms (6 forwards {6 * fwd:.3f} ms)",
          flush=True)
    for T in (376, 1500):
        coarse = rng.integers(0, 1024, (B, 2, T))
        s = wall_s(lambda: gen_obj.generate_fine_batch(coarse, seed=0))
        print(f"fine stage, {B} rows of {T} coarse frames: {s * 1e3:.1f} ms wall", flush=True)


if __name__ == "__main__":
    main()
