"""On the card: each cell's control (the program at its own lower precision,
``high``: TF32; for the prepared semantic decode, the reference with fp8
leaves in the GPT and Bark-fine and EnCodec in TF32) fails the cell's check
on three seeds at the cell's own size, while the program at the
configuration's precision passes it on the same weights and inputs; and a
traced run reads every per-layer metric of its cell.

    python -m pytest --noconftest -q portbench/tests/test_portbench_card.py

(from the checkout's root, on a machine with the card; ``--noconftest``
keeps the repository's own ``tests/conftest.py``, which imports JAX, out).
Skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))

from portbench import calibrate, harness  # noqa: E402

CELLS = ["acoustic.encode.b32x30s", "semantic_m.encode.b8x30s", "acoustic.decode.b32x30s",
         "semantic_m.decode.b32x250"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _bench():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(card, name):
    rows, limits = calibrate.readings(_bench(), name, [71, 2**31 + 72, 3_000_000_073])
    for seed, program, control in rows:
        for key, limit in limits.items():
            assert program[key] <= limit, (seed, key, program[key])
        assert any(control[k] > limits[k] for k in limits), (seed, control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(card, name):
    proc = subprocess.run([sys.executable, str(CHECKOUT / "portbench" / "run.py"), "--workload",
                           name, "--seed", "81", "--seconds", "3", "--trace", "1"],
                          capture_output=True, text=True, timeout=600, cwd=CHECKOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    bench = _bench()
    wanted = {m["name"] for m in harness.resolve_cell(bench, name)["metrics"]
              if m in bench["per_layer"]}
    assert line["correct"] is True and set(line["metrics"]) == wanted
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for key, m in line["metrics"].items():
        if "roofline" in key or "mfu" in key:
            assert 0 < m["value"] <= 100
