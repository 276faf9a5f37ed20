"""One run of one cell: build it, warm it up, drive the entry for the
window, check what the window produced against the plain reference, and
reduce the window to the cell's metrics.

Everything that belongs to one configuration, mix, entry or metric is a
file of its own, found by name:

  * ``configs/<config>.json``: the configuration as it is run, with the
    limits of its check numbers;
  * ``traffic/<mix>.json``: a mix's parameters for ``synth.py`` and the
    entry (``path``) it drives;
  * ``generators/<generator>.py``: one kind of traffic, ``make(...)``;
  * ``paths/<path>.py``: an entry's audio seconds and its check;
  * ``models/<config>.py``: how the program is built for the
    configuration (``Program``); the only files that import the program;
  * ``reference/<config>.py``: the plain reference, its weights
    (``make_weights``) and what it fits to them (``fit``, optional);
  * ``counts/<config>.py``: operations and bytes of a call, from its
    rows' lengths (None for an entry it does not count);
  * ``metrics/<name>.py`` (else ``metrics/<name before the first dot>.py``):
    one reader a metric, ``read(ctx) -> float | None``;
  * ``prepared/<cell>.json``: a cell built and measured but not yet listed
    in ``BENCHMARK.json``, with the metrics it would report.
"""

import contextlib
import gc
import json
import math
import random
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from portbench import devtrace, synth
from portbench.registry import ROOT, CellError, load_json, load_module  # noqa: F401

#: top-level modules that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "audiotoken_tpu")


def resolve_cell(bench: dict, name: str) -> dict:
    """The workload entry of ``name`` and the metric entries it reports:
    from ``BENCHMARK.json``, else from ``prepared/<name>.json``."""
    metrics = bench["end_to_end"] + bench["per_layer"]
    for w in bench["workloads"]:
        if w["name"] == name:
            mine = [m for m in metrics if "workloads" not in m or name in m["workloads"]]
            return {"entry": w, "metrics": mine}
    prepared = load_json("prepared", name)
    wanted = set(prepared["end_to_end"]) | set(prepared["per_layer"])
    return {"entry": prepared["workload"], "metrics": [m for m in metrics if m["name"] in wanted]}


def load_cell(entry: dict, overrides=None) -> SimpleNamespace:
    """A workload entry's files: its configuration and mix (with the tests'
    ``overrides``, ``{"config": {...}, "traffic": {...}}``, merged in), and
    its path, reference, model and counts modules."""
    overrides = overrides or {}
    cfg = {**load_json("configs", entry["config"]), **overrides.get("config", {})}
    mix = {**load_json("traffic", entry["traffic"]), **overrides.get("traffic", {})}
    c = SimpleNamespace(cfg=cfg, mix=mix, path=load_module("paths", mix["path"]),
                        ref=load_module("reference", entry["config"]),
                        model=load_module("models", entry["config"]),
                        counts=load_module("counts", entry["config"]))
    if None in (c.path, c.ref, c.model, c.counts):
        raise CellError(f"cell {entry['name']}: a path, reference, model or counts file is missing")
    return c


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def program_counters() -> dict:
    """The program's own launch counters (``launches``, ``launches_1pass``
    of the kernel wrappers in ``audiotoken_tpu_torch.ops``), by name."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("audiotoken_tpu_torch.ops.") or mod is None:
            continue
        for attr, fn in vars(mod).items():
            if callable(fn) and getattr(fn, "__module__", None) == mod_name:
                for key in ("launches", "launches_1pass"):
                    v = getattr(fn, key, None)
                    if isinstance(v, int):
                        out[f"{attr}.{key}"] = v
    return out


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def say(*args):
    print(*args, file=sys.stderr, flush=True)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", overrides=None) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``t_start`` is the host clock (``time.perf_counter``) when the process
    began: set-up is counted from it. ``device="cpu"`` and ``overrides``
    (``{"config": {...}, "traffic": {...}}`` merged into the files) are for
    the tests, which run the whole of a run at a tiny size on the CPU."""
    cell = resolve_cell(bench, name)
    chips = int(cell["entry"]["chips"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise CellError("torch.cuda.is_available() is false: this benchmark runs on the card")
        if torch.cuda.device_count() < chips:
            raise CellError(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found")
    c = load_cell(cell["entry"], overrides)
    cfg, mix, path, ref, model = c.cfg, c.mix, c.path, c.ref, c.model
    limits = cfg["limits"][mix["path"]]

    # --- set-up: the traffic, the program with the seed's weights, warm-up.
    # What the reference fits to the weights (``fit``) is the benchmark's
    # own work: timed apart and left out of set-up, and kept for the check.
    marks = [("imports", time.perf_counter())]
    pool = synth.make_pool(mix, cfg, seed, dev)
    marks.append(("traffic", time.perf_counter()))
    weights = ref.make_weights(cfg, mix, seed, dev)
    marks.append(("weights", time.perf_counter()))
    fit = getattr(ref, "fit", None)
    fitted = fit(cfg, mix, weights, pool, seed, dev) if fit else {}
    marks.append(("reference fit", time.perf_counter()))
    program = model.Program(cfg, mix["path"], dev)
    program.load({**weights, **fitted})
    del weights
    marks.append(("program", time.perf_counter()))
    for i in range(int(mix.get("warmup_calls", 2))):
        program(pool[i % len(pool)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    steps = [(name, t - t0) for (name, t), t0 in zip(marks, [t_start] + [t for _, t in marks[:-1]])]
    setup_s = marks[-1][1] - t_start - dict(steps)["reference fit"]
    say("set-up " + ", ".join(f"{name} {s:.2f} s" for name, s in steps)
        + f"; setup_s {setup_s:.2f} s (without the reference fit)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # --- the window: one caller, calls back to back, for ``seconds`` and
    # at least once through the pool
    rng = random.Random(seed)
    keep = int(mix.get("checked_calls", 2))
    kept, seen, calls, failed = {}, {}, [], 0  # a sample of each kind of request
    counters0 = program_counters()
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = stack.enter_context(profile(activities=acts))
        stack.enter_context(torch.profiler.record_function(devtrace.WINDOW))
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds or len(calls) < len(pool):
            k = len(calls)
            req = pool[k % len(pool)]
            try:
                with torch.profiler.record_function(devtrace.CALL):
                    t0 = time.perf_counter()
                    out = program(req)
                    t1 = time.perf_counter()
            except Exception:  # noqa: BLE001  (a call that fails fails the run; the window stops)
                say(traceback.format_exc())
                failed += 1
                break
            calls.append((t0, t1, path.audio_seconds(cfg, req, out), req.lengths))
            # reservoir samples of the calls whose answers are checked, one a kind
            mine, n = kept.setdefault(req.greedy, []), seen.get(req.greedy, 0)
            seen[req.greedy] = n + 1
            if len(mine) < keep:
                mine.append((k, out))
            else:
                j = rng.randrange(n + 1)
                if j < keep:
                    mine[j] = (k, out)
        w1 = time.perf_counter()
    attempted = len(calls) + failed
    launches = {key: v - counters0.get(key, 0) for key, v in program_counters().items()
                if v != counters0.get(key, 0)}
    mem_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    # --- the check, after the program's state is freed
    program.close()
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept = sorted(sum(kept.values(), []), key=lambda x: x[0])
    checks = {key: float("-inf") for key in limits}
    try:
        weights = {**ref.make_weights(cfg, mix, seed, dev), **fitted}
        for k, out in kept:
            numbers = path.check(ref, cfg, weights, pool[k % len(pool)], out, dev)
            for key, v in numbers.items():
                checks[key] = max(checks.get(key, float("-inf")), v)
        del weights
    except Exception:  # noqa: BLE001  (an answer that cannot be judged is not correct)
        say(traceback.format_exc())
        checks = {key: float("inf") for key in limits}
    correct = (failed == 0 and bool(kept) and set(checks) == set(limits)
               and all(math.isfinite(checks[k]) and checks[k] <= limits[k] for k in limits))

    # --- the metrics
    ctx = SimpleNamespace(cfg=cfg, mix=mix, path=mix["path"], counts=c.counts, calls=calls,
                          window_s=w1 - w0, setup_s=setup_s, launches=launches, trace=None)
    kinds = ("per_layer",) if trace else ("end_to_end",)
    wanted = [m for m in cell["metrics"] if m in sum((bench[k] for k in kinds), [])]
    result_device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                     "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                     "count": chips, "memory_peak_bytes": int(mem_peak)}
    breakdown = None
    if trace:
        ctx.trace = devtrace.DeviceTrace(prof.profiler.kineto_results.events())
        result_device["busy_s"] = ctx.trace.busy_s
        result_device["window_s"] = ctx.trace.window_s
        breakdown = {"device_ops": ctx.trace.device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
    metrics = {}
    for m in wanted:
        reader = load_module("metrics", m["name"], fallback=True)
        value = None if reader is None else reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            say(f"metric {m['name']}: nothing to read in this run")

    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["launches"] = launches
    result["power_limit"] = power_limit() if dev.type == "cuda" else "n/a"
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    return result


def check_lines(result: dict):
    """The numbers compared, each beside its limit, as plain lines."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}"
            for k, v in result["checks"].items()]


def as_json_line(result: dict) -> str:
    def clean(x):
        if isinstance(x, float) and not math.isfinite(x):
            return str(x)
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, list):
            return [clean(v) for v in x]
        if isinstance(x, np.generic):
            return x.item()
        return x

    return json.dumps(clean(result))
