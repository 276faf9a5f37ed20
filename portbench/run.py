"""The benchmark of audiotoken_tpu_torch on one NVIDIA H100: one run of one
cell, one JSON object as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window. The numbers that decide
``correct`` are printed last on standard error and under ``checks``.
Exits with code 2, printing no result, without a CUDA card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent

# Caches of the program and its libraries at fixed paths inside the
# checkout, so that only a checkout's first run builds; no library may pull
# in JAX or Flax behind the program's back.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CHECKOUT / ".portbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    try:
        result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except harness.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 2
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.as_json_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
