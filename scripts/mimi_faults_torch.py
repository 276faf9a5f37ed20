"""The Mimi cell's check against planted faults at the cell's own size:
``portbench/calibrate.py``'s readings (the program's ``code_gap`` and the
control's at ``high``, on each seed's weights and traffic: 32 rows of 30 s,
750 frames at 25 Hz in a window of 250) with one fault planted in the
program at a time.

    python scripts/mimi_faults_torch.py --seeds 1,2 [--faults window_widened,...]

The faults: ``window_widened`` (the window of 250 frames made 10,000, full
causal attention), ``mlp_dropped`` (layer 1's MLP output left out: its
LayerScale ``scale2`` zeroed after the weights are loaded) and
``acoustic_code_altered`` (one code of the second acoustic codebook moved to
the next codeword in every answer). One JSON line a seed and fault, then a
summary: each fault's smallest reading beside the configuration's limit,
which a fault the check catches lies above.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import calibrate, harness  # noqa: E402

CELL = "mimi.encode.b32x30s"


def _window_widened():
    import audiotoken_tpu_torch.encoders as encoders
    from audiotoken_tpu_torch.nn.mimi import MimiConfig

    cfg = MimiConfig(sliding_window=10_000)
    encoders.MimiConfig = lambda: cfg


def _mlp_dropped():
    model = harness.load_module("models", "mimi_24khz")
    load = model.Program.load

    def dropped(self, weights):
        load(self, weights)
        self.at.encoder.model.layers[1].scale2.zero_()

    model.Program.load = dropped


def _acoustic_code_altered():
    model = harness.load_module("models", "mimi_24khz")
    call = model.Program.__call__

    def altered(self, req):
        out = call(self, req).copy()
        out[0, 2, 3] = (int(out[0, 2, 3]) + 1) % 2048
        return out

    model.Program.__call__ = altered


FAULTS = {"window_widened": _window_widened, "mlp_dropped": _mlp_dropped,
          "acoustic_code_altered": _acoustic_code_altered}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--faults", default=",".join(FAULTS), help="comma-separated faults")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = args.faults.split(",")
    # each fault patches the program's modules: run it in a process of its own
    if len(faults) > 1:
        import subprocess

        for name in faults:
            subprocess.run([sys.executable, __file__, "--seeds", args.seeds, "--faults", name],
                           check=True)
        return
    name = faults[0]
    FAULTS[name]()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    t0 = time.perf_counter()
    rows, limits = calibrate.readings(bench, CELL, seeds)
    for seed, prog, ctrl in rows:
        print(json.dumps({"fault": name, "seed": seed, "program": prog, "control": ctrl}),
              flush=True)
    summary = {k: {"faulty_least": min(p[k] for _, p, _ in rows), "limit": limits[k],
                   "caught": all(not p[k] <= limits[k] for _, p, _ in rows)} for k in limits}
    print(json.dumps({"fault": name, "workload": CELL, "seeds": len(rows), "summary": summary,
                      "seconds": time.perf_counter() - t0, "power_limit": harness.power_limit()}),
          flush=True)


if __name__ == "__main__":
    main()
