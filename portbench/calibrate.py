"""The readings that a cell's check limits are set from: the program's
check numbers on many seeds at the cell's size, and the control's on the
same weights and inputs. The control is the reference's
(``reference/<config>.py:<path>_control``) where the configuration has
one, else the program at its own lower precision, ``high`` (TF32 in cuBLAS
and cuDNN and one TF32 pass in the attention kernels, for a configuration
that states f32).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3

One JSON line a seed with both readings, then a summary line: the largest
reading of the program (the lower reading) and the smallest of the
control (the upper one), beside the configuration's limit.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness, synth  # noqa: E402


def _worst(a: dict, b: dict) -> dict:
    return {k: max(a.get(k, float("-inf")), b.get(k, float("-inf"))) for k in a.keys() | b.keys()}


def readings(bench, name: str, seeds, device="cuda", overrides=None):
    """[(seed, program numbers, control numbers)] for cell ``name``: each
    seed's weights and one request of each kind (sampled, greedy) through
    the program at the configuration's precision, then the control."""
    c = harness.load_cell(harness.resolve_cell(bench, name)["entry"], overrides)
    cfg, path, ref, model = c.cfg, c.path, c.ref, c.model
    mix = {**c.mix, "pool": max(1, int(c.mix.get("greedy_every", 1)))}
    control = getattr(ref, f"{mix['path']}_control", None)
    dev = torch.device(device)
    program = model.Program(cfg, mix["path"], dev)
    out = []
    for seed in seeds:
        pool = synth.make_pool(mix, cfg, seed, dev)
        weights = ref.make_weights(cfg, mix, seed, dev)
        fit = getattr(ref, "fit", None)
        weights.update(fit(cfg, mix, weights, pool, seed, dev) if fit else {})
        program.load(weights)
        prog, ctrl = {}, {}
        for req in pool:
            print(f"seed {seed}: a {'greedy' if req.greedy else 'sampled'} request", file=sys.stderr,
                  flush=True)
            answer = program(req)
            prog = _worst(prog, path.check(ref, cfg, weights, req, answer, dev))
            if control is not None:
                ctrl = _worst(ctrl, control(weights, cfg, req, answer, dev))
            else:
                program.set_precision("high")
                ctrl = _worst(ctrl, path.check(ref, cfg, weights, req, program(req), dev))
                program.set_precision(cfg["precision"])
        out.append((seed, prog, ctrl))
    program.close()
    return out, cfg["limits"][mix["path"]]


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args()
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    t0 = time.perf_counter()
    rows, limits = readings(bench, args.workload, [int(s) for s in args.seeds.split(",")])
    for seed, prog, ctrl in rows:
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl}), flush=True)
    summary = {k: {"lower": max(p[k] for _, p, _ in rows), "upper": min(c[k] for _, _, c in rows),
                   "limit": limits[k]} for k in limits}
    print(json.dumps({"workload": args.workload, "seeds": len(rows), "summary": summary,
                      "seconds": time.perf_counter() - t0, "power_limit": harness.power_limit()}))


if __name__ == "__main__":
    main()
