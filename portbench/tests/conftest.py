"""Fixtures of the benchmark's tests: the checkout on ``sys.path``, the
benchmark file, and the port's semantic_m encoder patched narrow so that a
whole run fits the CPU in seconds."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

#: the semantic_m encoder's widths for a run on the CPU
NARROW_W2VBERT = {"hidden_size": 64, "num_attention_heads": 2, "intermediate_size": 128}
NARROW_SEMANTIC_M = {**NARROW_W2VBERT, "output_layer": 2, "num_clusters": 32}


@pytest.fixture
def bench():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


@pytest.fixture
def narrow_semantic_m(monkeypatch):
    """The port's w2v-BERT 64 wide, 2 heads, FFN 128, read at block 2, VQ
    32; returns the matching configuration overrides."""
    import audiotoken_tpu_torch.api as api
    import audiotoken_tpu_torch.encoders as encoders
    import audiotoken_tpu_torch.nn.conformer as conformer

    w = dataclasses.make_dataclass("NarrowW2VBert", [(k, int, v) for k, v in NARROW_W2VBERT.items()],
                                   bases=(conformer.W2VBertConfig,), frozen=True)
    c = dataclasses.make_dataclass("NarrowSemanticM", [("hidden_dim", int, 64), ("num_clusters", int, 32),
                                                       ("output_layer", int, 2)],
                                   bases=(api.Wav2VecBertConfig,), frozen=True)
    monkeypatch.setattr(conformer, "W2VBertConfig", w)
    monkeypatch.setattr(encoders, "W2VBertConfig", w)
    monkeypatch.setattr(api, "Wav2VecBertConfig", c)
    return dict(NARROW_SEMANTIC_M)


#: the semantic decoder's GPT and Bark-fine for a run on the CPU: 2 layers,
#: 64 wide; the GPT's context so short that 70 new tokens make the sampler
#: cut it twice, Bark-fine's window 64 frames, more than the rows' 35
NARROW_GPT = {"n_layer": 2, "n_head": 2, "n_embd": 64, "block_size": 64}
NARROW_BARK = {"n_layer": 2, "n_head": 2, "n_embd": 64, "block_size": 64, "max_history": 32}


@pytest.fixture
def narrow_semantic_decode(monkeypatch):
    """The port's semantic decoder with the narrow GPT and Bark-fine;
    returns the matching configuration overrides (70 new tokens a row)."""
    import audiotoken_tpu_torch.nn.bark_fine as bark_fine
    import audiotoken_tpu_torch.nn.gpt as gpt

    for mod, cls, narrow in ((gpt, "GPTConfig", NARROW_GPT), (bark_fine, "BarkFineConfig", NARROW_BARK)):
        narrow = dataclasses.make_dataclass(f"Narrow{cls}", [(k, int, v) for k, v in narrow.items()],
                                            bases=(getattr(mod, cls),), frozen=True)
        monkeypatch.setattr(mod, cls, narrow)
    from portbench import harness

    dec = harness.load_json("configs", "semantic_m_w2vbert2")["decoder"]
    return {"decoder": {**dec, "gpt": {**dec["gpt"], **NARROW_GPT},
                        "bark_fine": {**dec["bark_fine"], **NARROW_BARK}, "max_new_tokens": 70}}


#: each cell at a size the CPU runs in about a second a call
TINY = {
    "acoustic.encode.b32x30s": {"traffic": {"rows": 2, "seconds": 0.2, "pool": 2}},
    "semantic_m.encode.b8x30s": {"traffic": {"rows": 2, "seconds": 0.5, "pool": 2}},
    "acoustic.decode.b32x30s": {"traffic": {"rows": 2, "frames": 15, "pool": 2}},
    "semantic_m.decode.b32x250": {"traffic": {"rows": 2, "length": 20}},
}


@pytest.fixture
def tiny(narrow_semantic_m, narrow_semantic_decode):
    """Overrides of each cell for a run on the CPU."""
    out = {k: {kind: dict(v) for kind, v in ov.items()} for k, ov in TINY.items()}
    out["semantic_m.encode.b8x30s"]["config"] = narrow_semantic_m
    out["semantic_m.decode.b32x250"]["config"] = narrow_semantic_decode
    return out
