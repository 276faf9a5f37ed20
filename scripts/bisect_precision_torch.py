"""Bisect which semantic_m stages' TF32 rounding moves tokens, on an NVIDIA
GPU, and derive the "mixed" stage map from it.

    python scripts/bisect_precision_torch.py [--seeds 0,7,13,42]
        [--sweep demote,promote] [--mix stage=policy,...] [--rtfx]
        [--log tests/torch_goldens/BISECT_H100.log]

Counterpart of ``scripts/bisect_precision.py``, through the production
``Wav2VecBertEncoder`` with a per-stage map (``runtime/precision.py:
StagePrecision``). Each seed's random weights are drawn once; each
configuration switches the encoders' precision (``set_precision``) and
encodes the 12-case battery of ``scripts/golden_cases.py``:

  baselines      "highest" and "high"
  demote sweep   "highest" + ONE stage group at "high" (TF32): a group whose
                 demotion alone moves an exactness row's ids originates
                 token moves
  promote sweep  "high" + ONE stage group at "highest": a group whose
                 promotion alone gives "highest"'s ids on every exactness
                 row is the only origin
  derived        "high" + every group the demote sweep found at "highest",
                 checked against "highest" on every seed; where it moves,
                 the groups that the promote sweep ranks first are added
                 until it holds (at worst every stage at "highest")
  --mix          a named override map on "high"

Stage groups (``StagePrecision.STAGES``): front = fbank, proj; ffn =
ffn_in, ffn_out; attn = attn_qkv, attn_out and the four attention-kernel
stages (K4 is 3xTF32 under every setting); conv = conv; vq = vq.

A configuration's line per seed: its worst exactness row against the golden
(``tests/goldens/battery_semantic_m.npz``; the exactness rows are all cases
but the stability and degenerate probes of ``scripts/verify_tpu_parity.py``)
and the exactness rows whose ids differ from "highest"'s on the same
weights. ``--rtfx`` adds device RTFx at B=8 x 30 s int16 (median of 3).
``--log`` writes everything printed to a file as well, the card's name and
power limit at its head. Imports no JAX.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from golden_cases import WEIGHT_SEEDS  # noqa: E402
from precision_ladder_torch import (  # noqa: E402
    agreement,
    battery_inputs,
    card_line,
    device_rtfx,
    exact_cases,
)

from audiotoken_tpu_torch.encoders import Wav2VecBertEncoder  # noqa: E402
from audiotoken_tpu_torch.runtime.precision import StagePrecision  # noqa: E402

GROUPS = {
    "front": ("fbank", "proj"),
    "ffn": ("ffn_in", "ffn_out"),
    "attn": ("attn_qkv", "attn_kernel", "attn_scores", "attn_pos", "attn_pv", "attn_out"),
    "conv": ("conv",),
    "vq": ("vq",),
}
SR = 16_000


class Bisect:
    def __init__(self, encs, say):
        self.encs, self.say = encs, say
        self.audio, self.lengths, self.names, self.golden = battery_inputs("semantic_m")
        self.exact = exact_cases("semantic_m", self.names)
        # seed -> "highest"'s ids
        self.ref = {seed: self.ids(seed, "highest", None) for seed in encs}
        self.pcm = (np.random.default_rng(11).standard_normal((8, 30 * SR)) * 3000).clip(
            -32768, 32767).astype(np.int16)

    def ids(self, seed, default, overrides):
        enc = self.encs[seed]
        enc.set_precision(default, overrides)
        try:
            return enc(self.audio, attention_mask=self.lengths)
        finally:
            enc.set_precision("highest")

    def run(self, label, default, overrides, rtfx=False):
        """-> the exactness rows (case names) whose ids moved from
        "highest"'s on any seed."""
        moved_any = set()
        for seed in self.encs:
            t0 = time.perf_counter()
            ids = self.ids(seed, default, overrides)
            agree = agreement(ids, self.golden[f"ids_s{seed}"])
            worst = min(agree[i] for i in self.exact)
            moved = [self.names[i] for i in self.exact
                     if not np.array_equal(ids[i], self.ref[seed][i])]
            moved_any.update(moved)
            line = (f"{label:24s} s{seed:<2d} exactness-worst {worst:.6f}; moved from "
                    f"highest: {', '.join(moved) or 'none'}")
            flips = [f"{self.names[i]}={agree[i]:.6f}" for i in self.exact if agree[i] < 1.0]
            if flips:
                line += "; below 1 against the golden: " + ", ".join(flips)
            self.say(f"{line} ({time.perf_counter() - t0:.1f} s)")
        tail = ""
        if rtfx:
            enc = next(iter(self.encs.values()))
            enc.set_precision(default, overrides)
            r, _ = device_rtfx(enc, self.pcm, SR)
            enc.set_precision("highest")
            tail = f"; device RTFx B=8 x 30 s {r:.1f}"
        self.say(f"{label:24s} {'EQUAL to highest' if not moved_any else 'MOVES'}{tail}")
        return moved_any


def parse_mix(s):
    return dict((kv.split("=")[0].strip(), kv.split("=")[1].strip()) for kv in s.split(","))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default=",".join(map(str, WEIGHT_SEEDS)))
    ap.add_argument("--sweep", default="demote,promote")
    ap.add_argument("--mix", action="append", default=[])
    ap.add_argument("--rtfx", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log", default=None)
    args = ap.parse_args()
    log = open(args.log, "w") if args.log else None

    def say(*a):
        line = " ".join(str(x) for x in a)
        print(line, flush=True)
        if log:
            log.write(line + "\n")
            log.flush()

    dev = torch.device(args.device)
    say("bisect_precision_torch.py: semantic_m stage groups, TF32 against IEEE f32")
    if dev.type == "cuda":
        say(f"card: {card_line()}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    t0 = time.perf_counter()
    encs = {s: Wav2VecBertEncoder(weights="random", seed=s, device=dev) for s in seeds}
    say(f"{len(seeds)} weight draws in {time.perf_counter() - t0:.1f} s")
    b = Bisect(encs, say)
    sweeps = {s for s in args.sweep.split(",") if s}

    b.run("baseline highest", "highest", None, rtfx=args.rtfx)
    b.run("baseline high", "high", None, rtfx=args.rtfx)
    demoted, promoted = {}, {}
    if "demote" in sweeps:
        say("-- demote sweep: highest + one group at high (TF32)")
        for g, stages in GROUPS.items():
            demoted[g] = b.run(f"demote {g}", "highest", {s: "high" for s in stages})
    if "promote" in sweeps:
        say("-- promote sweep: high + one group at highest")
        for g, stages in GROUPS.items():
            promoted[g] = b.run(f"promote {g}", "high", {s: "highest" for s in stages})
    for mix in args.mix:
        b.run(f"mix {mix}"[:24], "high", parse_mix(mix), rtfx=args.rtfx)

    if demoted and promoted:
        say("-- derived map: high + the demote sweep's origins at highest")
        chosen = [g for g in GROUPS if demoted[g]]
        # the groups left, those whose promotion alone leaves fewest rows moved first
        rest = sorted((g for g in GROUPS if g not in chosen), key=lambda g: len(promoted[g]))
        while True:
            overrides = {s: "highest" for g in chosen for s in GROUPS[g]}
            label = "derived " + ("+".join(chosen) or "(none)")
            if not b.run(label[:24], "high", overrides, rtfx=args.rtfx) or not rest:
                break
            chosen.append(rest.pop(0))
        if len(chosen) == len(GROUPS):
            overrides = {s: "highest" for s in StagePrecision.STAGES}
        say(f"DERIVED W2VBERT_MIXED_OVERRIDES = {overrides!r}")
        say(f"groups at highest: {chosen or 'none'}")
    if log:
        log.close()


if __name__ == "__main__":
    main()
