"""Run a function on every rank of a fresh ``torch.distributed`` world.

:func:`run_world` starts one new interpreter per rank (spawned, never
forked: CUDA does not survive a fork), joins them in a process group whose
rendezvous is a file in a temporary directory of the call's own (so worlds
started side by side never meet), calls ``module:function`` on each rank
and returns what every rank returned. A rank that raises while the others
wait in a collective would hang them all, so the call has a deadline: when
a rank fails or the deadline passes, every rank still running is killed
and the error carries each rank's output.

Run as ``python -m audiotoken_tpu_torch.parallel.launch DIR RANK``, this
module is the rank's side of that.
"""

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Sequence


class WorldError(RuntimeError):
    """A rank of a world failed or the world outlived its deadline."""


def run_world(target: str, world: int, args: Sequence[Any] = (), backend: str = "gloo",
              timeout: float = 120.0) -> List[Any]:
    """``target(*args)`` ("package.module:function") on each of ``world``
    ranks -> the ranks' return values, in rank order. ``backend``: "gloo" or
    "nccl". Each rank runs torch's CPU ops on one thread: the ranks share
    the host's cores."""
    with tempfile.TemporaryDirectory(prefix="world_") as d:
        d = Path(d)
        with open(d / "job.pkl", "wb") as f:
            pickle.dump((target, tuple(args), backend, world), f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        env.pop("LOCAL_RANK", None)  # a rank's card is its rank modulo the cards
        logs = [open(d / f"rank{r}.log", "wb") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, "-m", __name__, str(d), str(r)], env=env,
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), failed)
        finally:
            hung = [r for r, p in enumerate(procs) if p.poll() is None]
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for f in logs:
                f.close()
        if failed is not None or hung:
            out = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n"
                            + (d / f"rank{r}.log").read_text(errors="replace")[-4000:]
                            for r, p in enumerate(procs))
            why = (f"rank {failed} failed" if failed is not None
                   else f"ranks {hung} still running after {timeout:.0f} s")
            raise WorldError(f"{target} on {world} ranks: {why}; killed the rest\n{out}")
        results = []
        for r in range(world):
            with open(d / f"out{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_main(d: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    d = Path(d)
    with open(d / "job.pkl", "rb") as f:
        target, args, backend, world = pickle.load(f)
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group(backend, init_method=f"file://{d / 'store'}", rank=rank,
                            world_size=world)
    try:
        module, fn = target.split(":")
        out = getattr(importlib.import_module(module), fn)(*args)
        with open(d / f"out{rank}.pkl.tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(d / f"out{rank}.pkl.tmp", d / f"out{rank}.pkl")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
