"""Every cell through the whole of a run on the CPU at a tiny size: the
program built with the seed's weights, warm-up, the window, the check
against the plain reference, and the result line of the contract; and the
faults the check must catch."""

import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness

CELLS = ["acoustic.encode.b32x30s", "semantic_m.encode.b8x30s", "acoustic.decode.b32x30s"]
#: built and measured, not yet listed in BENCHMARK.json
PREPARED = ["semantic_m.decode.b32x250"]
SEED = 2**31 + 12345
#: windows long enough for a call of each kind of request (0.3 s else)
WINDOW = {"semantic_m.decode.b32x250": 8.0}


def _run(bench, name, tiny, trace=False, overrides=None):
    return harness.run_cell(bench, name, SEED, WINDOW.get(name, 0.3), trace, time.perf_counter(),
                            device="cpu", overrides=overrides or tiny[name])


@pytest.mark.parametrize("name", CELLS + PREPARED)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu(bench, tiny, name, trace):
    r = _run(bench, name, tiny, trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    line = json.loads(harness.as_json_line(r))
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert line["device"]["platform"] == "cpu"
    kind = "per_layer" if trace else "end_to_end"
    mine = {m["name"] for m in harness.resolve_cell(bench, name)["metrics"] if m in bench[kind]}
    assert set(line["metrics"]) <= mine
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:  # every end-to-end metric is read from the host clock, on the CPU too
        assert set(line["metrics"]) == mine
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_same_seed_same_inputs_and_weights(bench, tiny):
    from portbench import synth

    cfg = harness.load_json("configs", "encodec_24khz")
    mix = {**harness.load_json("traffic", "pcm24k_b32x30s"), **tiny["acoustic.encode.b32x30s"]["traffic"]}
    a, b = synth.make_pool(mix, cfg, SEED, "cpu"), synth.make_pool(mix, cfg, SEED, "cpu")
    c = synth.make_pool(mix, cfg, SEED + 1, "cpu")
    assert all(np.array_equal(x.batch, y.batch) for x, y in zip(a, b))
    assert not np.array_equal(a[0].batch, c[0].batch) and a[0].batch.shape == c[0].batch.shape
    assert a[0].batch.dtype == np.int16 and 0 < np.abs(a[0].batch).max() <= 16384
    assert a[0].lengths == [a[0].batch.shape[1]] * a[0].batch.shape[0]
    ref = harness.load_module("reference", "encodec_24khz")
    w1, w2 = (ref.make_weights(cfg, mix, SEED, "cpu") for _ in range(2))
    assert all((w1["encoder"][k] == w2["encoder"][k]).all() for k in w1["encoder"])


def _broken(monkeypatch, model_name, fault):
    """The cell's program with ``fault`` applied to every answer, where it
    is produced."""
    model = harness.load_module("models", model_name)
    call = model.Program.__call__
    monkeypatch.setattr(model.Program, "__call__", lambda self, req: fault(call(self, req)))


def _alter_token(out):
    if isinstance(out, list):  # decode: one sample of the first waveform
        out[:] = [w.copy() for w in out]
        out[0][0, len(out[0][0]) // 2] += 1000
        return out
    out = out.copy()
    flat = out.reshape(-1)
    flat[flat.size // 2] = (flat[flat.size // 2] + 1) % 7
    return out


def _half_batch(out):
    """Half of the batch left out: its rows repeat the other half's."""
    if isinstance(out, list):
        n = len(out) // 2
        out[:] = out[:n] + out[:len(out) - n]
        return out
    n = out.shape[0] // 2
    return np.concatenate([out[:n], out[:out.shape[0] - n]])


@pytest.mark.parametrize("name", CELLS + PREPARED)
@pytest.mark.parametrize("fault", [_alter_token, _half_batch], ids=["token_altered", "half_batch"])
def test_a_broken_answer_is_not_correct(bench, tiny, monkeypatch, name, fault):
    entry = harness.resolve_cell(bench, name)["entry"]
    _broken(monkeypatch, entry["config"], fault)
    r = _run(bench, name, tiny)
    assert r["correct"] is False
    assert any(not v["value"] <= v["limit"] for v in r["checks"].values())


def test_an_altered_ar_token_is_not_correct(bench, tiny, monkeypatch):
    """One token of each row's AR stage altered where the sampler returns
    it: the later stages decode it as they would any token, and only
    ``ar_gap`` sees it."""
    from audiotoken_tpu_torch.nn import gpt

    generate = gpt.GPTSampler.generate_batch

    def altered(self, *args, **kw):
        out = generate(self, *args, **kw).copy()
        out[:, 3] = (out[:, 3] + 1) % self.cfg.vocab_size
        return out

    monkeypatch.setattr(gpt.GPTSampler, "generate_batch", altered)
    r = _run(bench, PREPARED[0], tiny)
    checks = r["checks"]
    assert r["correct"] is False and checks["ar_gap"]["value"] > checks["ar_gap"]["limit"]
    assert checks["fine_gap"]["value"] <= checks["fine_gap"]["limit"]
    assert checks["pcm16_err"]["value"] <= checks["pcm16_err"]["limit"]


def test_an_altered_fine_codebook_is_not_correct(bench, tiny, monkeypatch):
    """Bark-fine's last codebook altered in its window once the window is
    filled (every frame of every row, as a wrong head would): only
    ``fine_gap`` sees it."""
    from audiotoken_tpu_torch.nn import bark_fine

    fill = bark_fine.BarkFineGenerator._fill_window

    def altered(self, *args, **kw):
        out = fill(self, *args, **kw)
        out[:, :, -1] = (out[:, :, -1] + 1) % self.cfg.codebook_size
        return out

    monkeypatch.setattr(bark_fine.BarkFineGenerator, "_fill_window", altered)
    r = _run(bench, PREPARED[0], tiny)
    checks = r["checks"]
    assert r["correct"] is False and checks["fine_gap"]["value"] > checks["fine_gap"]["limit"]
    assert checks["ar_gap"]["value"] <= checks["ar_gap"]["limit"]


@pytest.mark.parametrize("name, traffic", [
    ("acoustic.encode.b32x30s", {"rows": 3, "min_seconds": 0.1}),
    ("acoustic.decode.b32x30s", {"rows": 3, "min_frames": 4}),
    ("semantic_m.decode.b32x250", {"rows": 3, "min_length": 5}),
])
def test_a_mix_of_row_lengths_is_data_alone(bench, tiny, name, traffic):
    """Rows of different lengths, from the mix's data alone: each cell's
    check judges every row on its own length, and the rate counts each
    row's audio, not the padding. (EnCodec's rows are 0.1 s or longer: a
    row shorter than its last conv's reflect padding, 7 frames of 320
    samples, is encoded differently alone than zero-padded in a batch.
    semantic_m's encoder is left out: on a row with an odd number of fbank
    frames the program departs from the reference, PERF.md.)"""
    over = {kind: dict(v) for kind, v in tiny[name].items()}
    over["traffic"].update(traffic)
    r = _run(bench, name, tiny, overrides=over)
    assert r["correct"] is True, r["checks"]
    c = harness.load_cell(harness.resolve_cell(bench, name)["entry"], over)
    from portbench import synth

    req = synth.make_pool(c.mix, c.cfg, SEED, "cpu")[0]
    assert len(set(req.lengths)) == 3


def test_a_call_that_raises_is_counted_failed(bench, tiny, monkeypatch):
    calls = []

    def boom(out):  # the warm-up's two calls pass, the window's first raises
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("broken")
        return out

    _broken(monkeypatch, "encodec_24khz", boom)
    r = _run(bench, "acoustic.encode.b32x30s", tiny)
    assert r["correct"] is False and r["failed"] == 1 and r["attempted"] == 1


def test_run_refuses_without_a_card_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(harness.ROOT / "run.py"), "--workload",
                           CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_json_line_has_no_bare_nan():
    r = {"correct": False, "checks": {"x": {"value": math.inf, "limit": 1.0}}}
    assert json.loads(harness.as_json_line(r))["checks"]["x"]["value"] == "inf"
