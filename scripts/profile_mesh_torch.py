"""Data and tensor parallel across the cards of one host, over NCCL.

    python scripts/profile_mesh_torch.py

Spawns one rank a card (``audiotoken_tpu_torch/parallel/launch.py``; the
world is every card present) and measures, at full width with random
weights from seed 0, each parallel path beside the same work on one card
with no mesh, every rank running its one-card copy at the same time:

  * the acoustic encoder, 32 rows of 30 s int16 PCM a rank, data parallel
    over ("dp",): RTFx of the whole batch against one card's;
  * the semantic_m encoder, 8 rows a rank, the same way;
  * ``TrainStep`` on the GPT (12 x 768, block 1024, vocab 53,376) under
    "default", B=8 x T=1024 a dp rank: one card, dp = cards, tp = cards
    (B=8 in all), tokens/s over the median of 5 steps after a warm-up; and
    one card on the whole dp batch (8 rows a card), whose losses the dp
    run's must repeat;
  * the GPT sampler in bf16 (the decoders' default), B=8 prompts of 256
    ids, greedy: one card against tp = cards, tokens/s, and the share of
    the tp rollout's tokens equal to one card's; and one rollout of 32
    tokens each way under ``torch.profiler`` (rank 0's ops of most device
    time, the device's busy time against the wall).

Every rank's walls are synchronised (``torch.cuda.synchronize`` and a
barrier before each timed run). The first line is the card's name and
power limit; the last a JSON object of the numbers. Needs CUDA; imports
no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audiotoken_tpu_torch.parallel.launch import run_world  # noqa: E402

SR, SR_M = 24_000, 16_000
ACOUSTIC_ROWS, SEMANTIC_ROWS, GPT_B, GPT_T, PROMPT = 32, 8, 8, 1024, 256
TRAIN_STEPS = 5
WORLD_TIMEOUT = 900.0  # seconds the spawned world may take


def _walls(fn, reps):
    """Walls of ``reps`` runs of ``fn``, each started together on every rank
    (a barrier) and waited for on this rank's card; one warm-up first."""
    import torch.distributed as dist

    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _profiled(fn, dev):
    """``fn`` once under ``torch.profiler`` -> (wall s, the device's busy
    seconds, the 12 ops of most device time and the 8 of most host time,
    each as (name, calls, device s, host s))."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    events = prof.key_averages()

    def row(e):
        return e.key[:60], e.count, device_us(e) * 1e-6, e.self_cpu_time_total * 1e-6

    top = sorted(events, key=device_us, reverse=True)[:12]
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return (wall, sum(device_us(e) for e in events) * 1e-6, [row(e) for e in top],
            [row(e) for e in host])


def _pcm(rows, sr, seconds, seed):
    x = np.random.default_rng(seed).standard_normal((rows, seconds * sr)) * 3000
    return x.clip(-32768, 32767).astype(np.int16)


def rank_main(seconds=30, steps=5, new_tokens=PROMPT, device="cuda"):
    """One rank: every measurement of the module docstring -> a dict of
    walls and checks."""
    from audiotoken_tpu_torch.configs import COMMONS, Wav2VecBertDecoderConfig
    from audiotoken_tpu_torch.decoders import _module_from_state
    from audiotoken_tpu_torch.encoders import AcousticEncoder, Wav2VecBertEncoder
    from audiotoken_tpu_torch.nn.gpt import GPT, GPTConfig, GPTSampler
    from audiotoken_tpu_torch.parallel.mesh import make_mesh
    from audiotoken_tpu_torch.runtime.precision import get_policy
    from audiotoken_tpu_torch.train.gpt_train import TrainStep
    from audiotoken_tpu_torch.weights import get_semantic_gpt_params, gpt_from_numpy

    mesh = make_mesh(("dp",), device=device)
    n, r, dev = mesh.size, mesh.rank, mesh.device
    out = {"ranks": n}
    with get_policy("highest").numerics():
        for name, cls, rows, sr in (("acoustic", AcousticEncoder, ACOUSTIC_ROWS, SR),
                                    ("semantic_m", Wav2VecBertEncoder, SEMANTIC_ROWS, SR_M)):
            pcm = _pcm(rows * n, sr, seconds, 7)
            mine = pcm[r * rows:(r + 1) * rows]
            enc = cls(weights="random", seed=0, device=device, mesh=mesh)
            toks = enc(pcm)
            w_n = _walls(lambda: enc(pcm), 3)
            enc.mesh = None  # the same encoder and weights on this card alone
            same = bool(np.array_equal(enc(mine), toks[r * rows:(r + 1) * rows]))
            w_1 = _walls(lambda: enc(mine), 3)
            out[name] = {"rows_a_rank": rows, "wall_1": w_1, "wall_n": w_n, "same_tokens": same}
            del enc
            torch.cuda.empty_cache()

    cfg = GPTConfig()
    params, _ = get_semantic_gpt_params("random", 0, "gpt_semantic_s_en", cfg.vocab_size)
    idx = np.random.default_rng(0).integers(0, cfg.vocab_size, (GPT_B * n, GPT_T))
    tgt = np.roll(idx, -1, axis=1)
    tgt[:, -1] = -1
    out["train"] = {}
    for label, shape, rows in (("1 card", None, GPT_B), (f"dp={n}", (n, 1), GPT_B * n),
                               (f"tp={n}", (1, n), GPT_B), ("1 card, the dp batch", None,
                                                             GPT_B * n)):
        m = None if shape is None else make_mesh(("dp", "tp"), shape, device=device)
        ts = TrainStep(cfg, params=params, device=dev, precision="default", mesh=m)
        batch = (idx[r * rows:(r + 1) * rows], tgt[r * rows:(r + 1) * rows]) \
            if label == "1 card" else (idx[:rows], tgt[:rows])
        losses = []
        w = _walls(lambda: losses.append(float(ts.step(*batch))), steps)
        out["train"][label] = {"tokens": rows * GPT_T, "walls": w, "losses": losses}
        del ts
        torch.cuda.empty_cache()
    del params

    dcfg = Wav2VecBertDecoderConfig
    gp, gcfg = get_semantic_gpt_params("random", 0, dict(dcfg.model_artifacts)[COMMONS.HI],
                                       dcfg.vocab.vocab_size)
    model = _module_from_state(GPT, gcfg, gpt_from_numpy(gp), dev, torch.bfloat16)
    del gp
    prompts = np.random.default_rng(1).integers(0, gcfg.vocab_size, (GPT_B, PROMPT))
    out["sampler"] = {}
    with get_policy("default").numerics():
        for label, m in (("1 card", None),
                         (f"tp={n}", make_mesh(("dp", "tp"), (1, n), device=device))):
            sp = GPTSampler(model, mesh=m)
            toks = []
            w = _walls(lambda: toks.append(sp.generate_batch(
                prompts, max_new_tokens=new_tokens, top_k=1)), 2)
            out["sampler"][label] = {"tokens": int((toks[-1] >= 0).sum()), "walls": w,
                                     "rollout": toks[-1], "profile": _profiled(
                                         lambda: sp.generate_batch(prompts, max_new_tokens=32,
                                                                   top_k=1), dev)}
            del sp
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_mesh_torch: needs CUDA devices")
    from audiotoken_tpu_torch.ops import _build

    _build.library()  # built here once, before any rank starts
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    n = torch.cuda.device_count()
    outs = run_world("profile_mesh_torch:rank_main", n, (30, TRAIN_STEPS, PROMPT),
                     backend="nccl", timeout=WORLD_TIMEOUT)
    o = outs[0]
    res = {"cards": n}
    for name in ("acoustic", "semantic_m"):
        e = o[name]
        w1, wn = statistics.median(e["wall_1"]), statistics.median(e["wall_n"])
        one, many = e["rows_a_rank"] * 30 / w1, e["rows_a_rank"] * n * 30 / wn
        same = all(x[name]["same_tokens"] for x in outs)
        res[name] = {"rtfx_1_card": one, "rtfx_mesh": many, "efficiency": many / (n * one),
                     "tokens_equal": same}
        print(f"{name} encode, {e['rows_a_rank']} x 30 s int16 a rank: one card RTFx "
              f"{one:.1f} (median wall {w1 * 1e3:.1f} ms), dp={n} RTFx {many:.1f} (median "
              f"{wn * 1e3:.1f} ms), {many / (n * one):.3f} of {n} cards; each rank's rows "
              f"{'equal' if same else 'NOT equal'} to its one-card tokens", flush=True)
    res["train"] = {}
    for label, t in o["train"].items():
        step = statistics.median(t["walls"][1:] or t["walls"])
        res["train"][label] = {"ms_a_step": step * 1e3, "tokens_s": t["tokens"] / step,
                               "losses": t["losses"]}
        print(f"TrainStep {label}: {t['tokens']} tokens a step, median {step * 1e3:.1f} ms, "
              f"{t['tokens'] / step:.0f} tokens/s; losses "
              f"{' '.join(f'{v:.4f}' for v in t['losses'])}", flush=True)
    dp, whole = res["train"][f"dp={n}"]["losses"], res["train"]["1 card, the dp batch"]["losses"]
    gap = max(abs(a - b) for a, b in zip(dp, whole))
    res["train"]["dp_loss_gap_to_1_card"] = gap
    print(f"TrainStep dp={n} against one card on the same {GPT_B * n} rows, step by step: largest "
          f"loss gap {gap:.3e}", flush=True)
    res["sampler"] = {}
    base = o["sampler"]["1 card"]["rollout"]
    for label, s in o["sampler"].items():
        wall = statistics.median(s["walls"])
        agree = float((s["rollout"] == base).mean())
        ranks_agree = all(np.array_equal(x["sampler"][label]["rollout"], s["rollout"])
                          for x in outs)
        res["sampler"][label] = {"tokens_s": s["tokens"] / wall, "wall_s": wall,
                                 "equal_to_1_card": agree, "ranks_agree": ranks_agree}
        print(f"GPTSampler bf16 {label}: B={GPT_B}, {s['tokens']} greedy tokens in "
              f"{wall:.2f} s, {s['tokens'] / wall:.1f} tokens/s; {agree:.4f} of them equal "
              f"to one card's; the ranks {'agree' if ranks_agree else 'DISAGREE'}", flush=True)
        p_wall, busy, top, host = s["profile"]
        res["sampler"][label]["profiled_32"] = {"wall_s": p_wall, "device_busy_s": busy}
        print(f"  profiled, 32 new tokens, rank 0: wall {p_wall:.3f} s, device busy "
              f"{busy:.3f} s (summed over streams); most device time, then most host time:",
              flush=True)
        for name, calls, dev_s, host_s in top + host:
            print(f"    {name:60s} {calls:6d} calls  device {dev_s * 1e3:8.2f} ms  "
                  f"host {host_s * 1e3:8.2f} ms", flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
