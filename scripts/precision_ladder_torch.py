"""Precision ladder of the port's encoders: agreement with the golden
batteries and device RTFx, per precision mode, on an NVIDIA GPU.

    python scripts/precision_ladder_torch.py [--tokenizers acoustic,semantic_s,semantic_m]
        [--seeds 0,7,13,42] [--batches 8,32]

Counterpart of ``scripts/precision_ladder.py``, through the production
encoders of ``audiotoken_tpu_torch.encoders``. For each tokenizer it draws
each weight seed's random weights once and, for each mode (acoustic and
semantic_s: highest, high, default, bfloat16; semantic_m: those and
mixed), switches the encoders' precision (``set_precision``), then:

  - encodes the 12-case battery (``scripts/golden_cases.py``) and compares
    the ids with ``tests/goldens/battery_<tokenizer>.npz`` case by case: per
    seed, the worst exactness row, the probes (the stability and degenerate
    cases of ``scripts/verify_tpu_parity.py``, their mean agreement) and
    the cases below the per-case contract;
  - measures the device RTFx with the first seed's weights at B=8 and 32 x
    30 s of int16 PCM (``__call__``, host array in and host ids out,
    synchronised; median of 3 after a warm-up).

The last line is a JSON object of the numbers. Imports no JAX;
``--device cpu`` runs the kernels' plain versions (slow at full width).
``chip_smoke.py`` phase 5f runs :func:`run_ladder` over the encoders of its
golden phases.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import verify_tpu_parity as parity  # noqa: E402  (numpy-only at import)
from golden_cases import WEIGHT_SEEDS, battery  # noqa: E402

from audiotoken_tpu_torch.encoders import (  # noqa: E402
    AcousticEncoder,
    HubertEncoder,
    Wav2VecBertEncoder,
)

MODES = {
    "acoustic": ("highest", "high", "default", "bfloat16"),
    "semantic_s": ("highest", "high", "default", "bfloat16"),
    "semantic_m": ("highest", "mixed", "high", "default", "bfloat16"),
}
SAMPLE_RATE = {"acoustic": 24_000, "semantic_s": 16_000, "semantic_m": 16_000}
ENCODERS = {"acoustic": AcousticEncoder, "semantic_s": HubertEncoder,
            "semantic_m": Wav2VecBertEncoder}


def hubert_host_norm(audio, lengths):
    """The host normalisation over each row's valid prefix, zeros after it."""
    out = np.zeros_like(audio, np.float32)
    for i, n in enumerate(lengths):
        out[i, :n] = HubertEncoder.host_transform(audio[i, :n][None])[0]
    return out


def battery_inputs(tok):
    """(audio, lengths, names, golden ids by seed) of ``tok``'s battery."""
    audio, lengths, names = battery(SAMPLE_RATE[tok])
    if tok == "semantic_s":
        audio = hubert_host_norm(audio, lengths)
    golden = np.load(os.path.join(parity.GOLD, f"battery_{tok}.npz"))
    return audio, lengths, names, golden


def encode_battery(tok, enc, audio, lengths):
    """The battery's ids through ``enc``: the acoustic path is causal and
    takes no mask."""
    return enc(audio) if tok == "acoustic" else enc(audio, attention_mask=lengths)


def agreement(ids, ref):
    """Per-case agreement of ids [cases, ...] with the golden's."""
    n = ref.shape[0]
    return (ids.reshape(n, -1) == ref.reshape(n, -1)).mean(axis=1)


def probe_cases(tok, names):
    """Indices of the cases reported, not exactness-gated, by the contract."""
    probes = parity.STABILITY_CASES | parity.DEGENERATE_CASES
    return [i for i, n in enumerate(names) if (tok, n) in probes]


def exact_cases(tok, names):
    probes = set(probe_cases(tok, names))
    return [i for i in range(len(names)) if i not in probes]


def below_contract(tok, names, agree):
    """Names of the cases that fail the per-case contract."""
    bad = []
    for name, a in zip(names, agree):
        if (tok, name) in parity.DEGENERATE_CASES:
            ok = parity.degenerate_ok(float(a))
        else:
            ok = a >= parity.case_thresh(tok, name)
        if not ok:
            bad.append(name)
    return bad


def summarize(tok, names, agree):
    """{"worst": (case, agreement) of the exactness rows, "probes": mean
    agreement of the probes or None, "below": cases under the contract}."""
    ex = exact_cases(tok, names)
    w = min(ex, key=lambda i: agree[i])
    pr = probe_cases(tok, names)
    return {"worst": (names[w], float(agree[w])),
            "probes": float(np.mean(agree[pr])) if pr else None,
            "below": below_contract(tok, names, agree)}


def synchronize(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def device_rtfx(enc, pcm, sr, reps=3):
    """(RTFx, walls in s): audio seconds over the median wall of ``enc``'s
    ``__call__`` on the int16 rows ``pcm``, after one warm-up call."""
    enc(pcm)  # warm-up: cuDNN's algorithm choice for this mode, the allocator
    walls = []
    for _ in range(reps):
        synchronize(enc.device)
        t0 = time.perf_counter()
        enc(pcm)
        synchronize(enc.device)
        walls.append(time.perf_counter() - t0)
    return pcm.shape[0] * pcm.shape[1] / sr / statistics.median(walls), walls


def run_ladder(tok, encs, batches=(8, 32), say=print, tag="[ladder]", modes=None,
               counts=None):
    """The ladder over ``encs`` ({seed: encoder of ``tok``}), which are left
    at "highest". -> {mode: {"lines": {seed: per-case agreement},
    "ids": {seed: ids}, "summary": {seed: summarize()}, "rtfx": {B: RTFx}}};
    RTFx with the first seed's encoder. With ``counts`` (a callable giving
    {name: launch count}), each mode's entry also has "launches": how much
    each count rose while that mode ran."""
    audio, lengths, names, golden = battery_inputs(tok)
    sr = SAMPLE_RATE[tok]
    rng = np.random.default_rng(11)
    pcm = (rng.standard_normal((max(batches or (1,)), 30 * sr)) * 3000).clip(
        -32768, 32767).astype(np.int16)
    first = next(iter(encs))
    out = {}
    try:
        for mode in modes or MODES[tok]:
            res = out[mode] = {"lines": {}, "ids": {}, "summary": {}, "rtfx": {}}
            before = counts() if counts else {}
            for seed, enc in encs.items():
                enc.set_precision(mode)
                t0 = time.perf_counter()
                ids = encode_battery(tok, enc, audio, lengths)
                agree = agreement(ids, golden[f"ids_s{seed}"])
                res["lines"][seed], res["ids"][seed] = agree, ids
                s = res["summary"][seed] = summarize(tok, names, agree)
                probes = "" if s["probes"] is None else f", probes {s['probes']:.6f}"
                say(f"{tag} {tok} {mode:8s} s{seed:<2d} worst exactness row "
                    f"{s['worst'][0]} {s['worst'][1]:.6f}{probes}; below the contract: "
                    f"{', '.join(s['below']) or 'none'} ({time.perf_counter() - t0:.1f} s)")
            encs[first].set_precision(mode)
            for B in batches:
                rtfx, walls = device_rtfx(encs[first], pcm[:B], sr)
                res["rtfx"][B] = rtfx
                say(f"{tag} {tok} {mode:8s} B={B} x 30 s int16: RTFx {rtfx:.1f} (walls "
                    f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms)")
            if counts:
                res["launches"] = {n: c - before[n] for n, c in counts().items()}
    finally:
        for enc in encs.values():
            enc.set_precision("highest")
    return out


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokenizers", default="acoustic,semantic_s,semantic_m")
    ap.add_argument("--seeds", default=",".join(map(str, WEIGHT_SEEDS)))
    ap.add_argument("--batches", default="8,32", help="RTFx batches (rows of 30 s)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"card: {card_line()}", flush=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    batches = tuple(int(b) for b in args.batches.split(",") if b)
    result = {}
    for tok in args.tokenizers.split(","):
        t0 = time.perf_counter()
        encs = {s: ENCODERS[tok](weights="random", seed=s, device=dev) for s in seeds}
        print(f"[ladder] {tok}: {len(seeds)} weight draws in {time.perf_counter() - t0:.1f} s",
              flush=True)
        lad = run_ladder(tok, encs, batches, say=lambda *a: print(*a, flush=True))
        result[tok] = {mode: {"worst": {s: r["summary"][s]["worst"] for s in seeds},
                              "probes": {s: r["summary"][s]["probes"] for s in seeds},
                              "below": {s: r["summary"][s]["below"] for s in seeds},
                              "rtfx": r["rtfx"]} for mode, r in lad.items()}
        del encs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
