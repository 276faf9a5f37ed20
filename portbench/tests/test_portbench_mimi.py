"""The Mimi cell (``mimi.encode.b32x30s``) through the whole of a run on the
CPU at a tiny size, traced and untraced; its counts against a direct count;
its reference's imports; and three faults the check must refuse, with rows
longer than the window."""

import dataclasses
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness

CELL = "mimi.encode.b32x30s"
SEED = 2**31 + 4321
#: the configuration's widths for a run on the CPU; a window of 6 frames
#: against rows of 40 (1.6 s at 25 Hz)
TINY_CFG = {"num_filters": 8, "hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 4, "head_dim": 8, "intermediate_size": 64,
            "codebook_size": 64, "codebook_dim": 16, "vector_quantization_hidden_dimension": 16,
            "num_quantizers": 4, "encode_codebooks": 4, "sliding_window": 6}
TINY_TRAFFIC = {"rows": 2, "seconds": 1.6, "pool": 2}
COUNTS = harness.load_module("counts", "mimi_24khz")
REF = harness.load_module("reference", "mimi_24khz")


def _port_cfg(window=6):
    from audiotoken_tpu_torch.nn.mimi import MimiConfig

    return MimiConfig(num_filters=8, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=64, codebook_size=64, codebook_dim=16, num_quantizers=4,
                      sliding_window=window)


@pytest.fixture
def tiny(monkeypatch):
    """The port's Mimi at the tiny widths; returns the cell's overrides."""
    import audiotoken_tpu_torch.encoders as encoders

    cfg = _port_cfg()
    monkeypatch.setattr(encoders, "MimiConfig", lambda: cfg)
    return {"config": dict(TINY_CFG), "traffic": dict(TINY_TRAFFIC)}


def _run(bench, tiny, trace=False):
    return harness.run_cell(bench, CELL, SEED, 0.3, trace, time.perf_counter(), device="cpu",
                            overrides=tiny)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_on_the_cpu(bench, tiny, trace):
    r = _run(bench, tiny, trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert r["checks"]["code_gap"]["value"] <= r["checks"]["code_gap"]["limit"]
    kind = "per_layer" if trace else "end_to_end"
    mine = {m["name"] for m in harness.resolve_cell(bench, CELL)["metrics"] if m in bench[kind]}
    assert set(r["metrics"]) <= mine
    if trace:
        assert "breakdown" in r and {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == mine == {"encode_rtfx", "call_p90_ms", "setup_s"}
    # the CPU takes the kernels' twins: no launch is counted
    assert "flash_attention_window.launches" not in r["launches"]


def test_the_cell_lists_its_metrics(bench):
    mine = {m["name"] for m in harness.resolve_cell(bench, CELL)["metrics"]}
    assert {"window_attn_roofline", "rvq_roofline", "mfu_pct.encode", "device_idle_pct.encode",
            "library_ms.encode", "copy_ms.encode", "host_gap_ms.encode",
            "launch_gap_ms.encode", "encode_rtfx", "call_p90_ms", "setup_s"} == mine


def _cfg():
    return {**harness.load_json("configs", "mimi_24khz"), **TINY_CFG}


@pytest.mark.parametrize("frames", [5, 40])
def test_counts_match_a_direct_count(frames):
    """The whole call's operations against PyTorch's count of the
    reference's products, its dense scores (2 T^2 dh a head, twice) swapped
    for the band's pairs; the window kernel's and K3's counts by hand."""
    cfg = _cfg()
    n = frames * 960
    w = REF.make_weights(cfg, {"path": "encode"}, 1, "cpu")["encoder"]
    g = torch.Generator().manual_seed(2)
    books = {"semantic_codebooks": torch.randn((1, 64, 16), generator=g),
             "acoustic_codebooks": torch.randn((3, 64, 16), generator=g)}
    with FlopCounterMode(display=False) as fc, torch.inference_mode():
        REF.encode({**w, **books}, cfg, torch.randn((2, n), generator=g) * 0.1, 4)
    H, dh, L = 4, 8, 2
    dense = L * 2 * (2 * 2 * H * frames * frames * dh)
    band = COUNTS.pairs(frames, 6)
    assert band == sum(min(i + 1, 6) for i in range(frames))
    assert COUNTS.step_flops(cfg, "encode", [n, n]) == fc.get_total_flops() - dense + 2 * L * H * 4 * dh * band
    assert COUNTS.window_attention(cfg, "encode", [n]) == (L * H * 4 * dh * band,
                                                          L * H * 4 * 4 * frames * dh)
    rows = -(-frames // 2)
    # 4 codebooks of 64 x 16 over `rows` rows: rows in twice (two launches),
    # codebooks and codes once
    assert COUNTS.rvq(cfg, "encode", [n]) == (2 * rows * 4 * 64 * 16,
                                             4 * (2 * rows * 16 + 4 * 64 * 16 + 4 * rows))
    assert COUNTS.step_flops(cfg, "decode", [n]) is None


def test_the_reference_loads_without_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r); from portbench import harness\n"
            "harness.load_module('reference', 'mimi_24khz')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'audiotoken_tpu_torch', "
            "'audiotoken_tpu', 'jax', 'jaxlib', 'flax'}))") % str(harness.ROOT.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _wide_window(monkeypatch):
    """The program's window widened to full causal attention."""
    import audiotoken_tpu_torch.encoders as encoders

    cfg = _port_cfg(window=10_000)
    monkeypatch.setattr(encoders, "MimiConfig", lambda: cfg)


def _mlp_dropped(monkeypatch):
    """The second layer's MLP output left out."""
    model = harness.load_module("models", "mimi_24khz")
    load = model.Program.load

    def dropped(self, weights):
        load(self, weights)
        self.at.encoder.model.layers[1].scale2.zero_()

    monkeypatch.setattr(model.Program, "load", dropped)


def _acoustic_code_altered(monkeypatch):
    """One code of the second acoustic codebook altered in every answer."""
    model = harness.load_module("models", "mimi_24khz")
    call = model.Program.__call__

    def altered(self, req):
        out = call(self, req).copy()
        out[0, 2, 3] = (out[0, 2, 3] + 1) % 64
        return out

    monkeypatch.setattr(model.Program, "__call__", altered)


@pytest.mark.parametrize("fault", [_wide_window, _mlp_dropped, _acoustic_code_altered],
                         ids=["window_widened", "mlp_dropped", "acoustic_code_altered"])
def test_a_fault_is_not_correct(bench, tiny, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(bench, tiny)
    assert r["correct"] is False
    assert not r["checks"]["code_gap"]["value"] <= r["checks"]["code_gap"]["limit"]


def test_same_seed_same_codebooks():
    """The fitted codebooks are the seed's: the same twice, another seed's
    differ; their frames spread over the codewords."""
    from portbench import synth

    cfg = _cfg()
    mix = {**harness.load_json("traffic", "pcm24k_b32x30s"), **TINY_TRAFFIC}
    pool = synth.make_pool(mix, cfg, SEED, "cpu")
    w = REF.make_weights(cfg, mix, SEED, "cpu")
    a, b = (REF.fit(cfg, mix, w, pool, SEED, "cpu") for _ in range(2))
    c = REF.fit(cfg, mix, w, pool, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["acoustic_codebooks"], c["acoustic_codebooks"])
    with torch.inference_mode():
        codes = REF.encode({**w["encoder"], **a}, cfg,
                           torch.from_numpy(pool[0].batch).float() / 32768.0, 4)
    for k in (0, 1):
        assert len(np.unique(codes[:, k].numpy())) > codes[:, k].numel() // 3
