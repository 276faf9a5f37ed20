"""Where the time of one GPT decode step goes, by ablation, on an NVIDIA GPU.

    python scripts/profile_ar_step_torch.py [--batch 8] [--slot 768] [--steps 30]

The semantic decode's GPT at its real size (12 layers x 768, 12 heads,
vocab 53,376, bf16, random weights from seed 0) with a 1024-slot cache
filled at random, one token a row at cache slot ``--slot``. The variants
are those of ``scripts/profile_ar_step.py``:

  full      the decode step as the sampler runs it: 12 layers, ln_f, the
            lm_head over the whole vocab and a top-k 100 draw at 0.8
  nohead    the 12 layers only
  headonly  ln_f, the lm_head and the draw, from a fixed hidden state
  noattn    the layers with the cache attention replaced by the token's
            own value (the attention over one key)
  attnonly  the layers without the MLP halves (the out-projection and its
            residual kept)

each with the kernels (K7 ``decode_qkv`` and ``decode_ffn``, K6 chained
after ``decode_qkv``) and with their plain chains of PyTorch calls. For
each it prints:
  * device ms a step: four steps queued behind a device sleep, CUDA events
    around them, so the device runs them back to back (the median of 5;
    marked when the host could not queue them within the sleep);
  * host ms a step: the host's time to issue one step's launches while the
    device sleeps, the floor a step cannot go below while it is launched
    kernel by kernel;
  * wall ms a step: ``--steps`` steps issued one after the other and
    synchronised at the end, as the sampler runs them; about the larger of
    the two above.
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
from audiotoken_tpu_torch.nn.gpt import GPT, GPTConfig, _sample, init_gpt_params  # noqa: E402
from audiotoken_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_plain,
)
from audiotoken_tpu_torch.ops.decode_step import (  # noqa: E402
    decode_ffn,
    decode_ffn_plain,
    decode_qkv,
    decode_qkv_plain,
)
from audiotoken_tpu_torch.weights import gpt_from_numpy  # noqa: E402

VARIANTS = ("full", "nohead", "headonly", "noattn", "attnonly")
SLOTS, VOCAB = 1024, 53_376
SLEEP_CYCLES = 100_000_000  # the device's sleep while the host queues the steps
#: steps queued behind the sleep: their launches fit the launch queue, which
#: blocks the host when full (30 steps of the plain chains did not)
QUEUED_STEPS = 4


def make_caches(model, B):
    """Random k and v caches [n_layer, B, nh, SLOTS, dh] in the model's dtype."""
    cfg, dev = model.cfg, model.wpe.device
    shape = (cfg.n_layer, B, cfg.n_head, SLOTS, cfg.n_embd // cfg.n_head)
    gen = torch.Generator(device=dev).manual_seed(1)
    return [torch.randn(shape, generator=gen, device=dev).to(model.wte.dtype) for _ in range(2)]


def make_step(model, caches, mode, kernels, B, pos, gen):
    """One decode step of ``mode`` -> a function of the token ids [B]."""
    cfg, dev = model.cfg, model.wpe.device
    C, eps = cfg.n_embd, cfg.layer_norm_eps
    start = torch.zeros((B,), dtype=torch.int32, device=dev)
    weights = model.decode_weights()
    qkv_f = decode_qkv if kernels else decode_qkv_plain
    ffn_f = decode_ffn if kernels else decode_ffn_plain
    x_fixed = torch.randn((B, C), device=dev).to(model.wte.dtype)

    def attend(li, qkv):
        args = (qkv[:, :C], caches[0][li], caches[1][li], start, pos, qkv[:, C:2 * C],
                qkv[:, 2 * C:])
        return decode_attention(*args, chained=True) if kernels else decode_attention_plain(*args)

    def layers(x):
        for li, (ln1_w, ln1_b, w_qkv, b_qkv, w_out, b_out, ln2_w, ln2_b, w_in, b_in, w_out2,
                 b_out2) in enumerate(weights):
            qkv = qkv_f(x, ln1_w, ln1_b, w_qkv, b_qkv, eps)
            a = qkv[:, 2 * C:].contiguous() if mode == "noattn" else attend(li, qkv)
            if mode == "attnonly":
                x = x + F.linear(a, w_out, b_out)
            else:
                x = ffn_f(x, a, w_out, ln2_w, ln2_b, w_in, w_out2, b_out, b_in, b_out2, eps)
        return x

    def head(x):
        logits = model.full_logits(F.layer_norm(x, (C,), model.ln_f.weight, model.ln_f.bias,
                                                eps))
        return _sample(logits, 0.8, 100, gen)

    def step(tok):
        if mode == "headonly":
            return head(x_fixed)
        x = model._embed(tok, (pos - start).long())
        x = layers(x)
        return x if mode == "nohead" else head(x)

    return step


def sleep_ms():
    """How long the device sleep lasts, in ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_step(step, tok, n, slept_ms, queued=QUEUED_STEPS, reps=5):
    """(device ms, host ms, wall ms) a step, and whether the host queued
    its steps before the device woke. Device and host time come from
    ``queued`` steps behind a device sleep (few enough that the launch
    queue holds them without blocking the host), median of ``reps``; the
    wall from ``n`` steps synchronised at the end."""
    with torch.inference_mode():
        for _ in range(3):
            step(tok)
        devices, hosts = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            t0 = time.perf_counter()
            for _ in range(queued):
                step(tok)
            hosts.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            devices.append(start.elapsed_time(end) / queued)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(tok)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    return (statistics.median(devices), statistics.median(hosts) / queued, wall,
            max(hosts) < slept_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--slot", type=int, default=768, help="the cache slot of the new token")
    ap.add_argument("--steps", type=int, default=30, help="steps of the wall run")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs on an NVIDIA GPU")
    dev, B = torch.device("cuda", 0), args.batch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0], flush=True)
    cfg = GPTConfig(block_size=SLOTS, vocab_size=VOCAB, n_layer=12, n_head=12, n_embd=768)
    state = gpt_from_numpy(init_gpt_params(np.random.default_rng(0), cfg))
    model = _module_from_state(GPT, cfg, state, dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    caches = make_caches(model, B)
    tok = torch.full((B,), 7, dtype=torch.long, device=dev)
    slept = sleep_ms()
    print(f"GPT 12 x 768, vocab {VOCAB}, bf16, B={B}, slot {args.slot} of {SLOTS}; "
          f"{args.steps} steps a wall run; the device sleep lasts {slept:.1f} ms", flush=True)
    for mode in args.variants.split(","):
        for kernels in (True, False):
            step = make_step(model, caches, mode, kernels, B, args.slot, gen)
            device, host, wall, queued = time_step(step, tok, args.steps, slept)
            print(f"{mode:9s} {'kernels' if kernels else 'plain':7s} device {device:.4f} ms "
                  f"a step{'' if queued else ' (host fell behind the sleep)'}  host "
                  f"{host:.4f} ms a step  wall {wall:.4f} ms a step", flush=True)


if __name__ == "__main__":
    main()
