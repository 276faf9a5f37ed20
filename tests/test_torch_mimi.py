"""Mimi's encode side (``nn/mimi.py``, ``encoders.py:MimiEncoder``) against
the benchmark's plain reference (``portbench/reference/mimi_24khz.py``), on
the CPU at a tiny size: 8 filters, hidden 32, 2 layers of 4 heads, 4
codebooks of 64 x 16, seeded. The window kernel's twin and ``elu_pad``'s
zero mode against their direct forms. The anchor against transformers'
``MimiModel`` is in ``test_torch_convert.py``, beside the other tests that
build ``transformers`` models."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import audiotoken_tpu_torch.encoders as encoders
from audiotoken_tpu_torch import AudioToken, Tokenizers
from audiotoken_tpu_torch.nn.mimi import MimiConfig
from audiotoken_tpu_torch.ops.elu_pad import elu_pad, elu_pad_plain
from audiotoken_tpu_torch.ops.flash_attention import (
    flash_attention_window,
    flash_attention_window_plain,
)
from portbench.reference import mimi_24khz as ref

ROOT = Path(__file__).resolve().parents[1]
#: frames of the tiny window: rows of 5 and 40 frames at 25 Hz lie below and
#: above it
WINDOW = 6
TINY = MimiConfig(num_filters=8, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, codebook_size=64, codebook_dim=16, num_quantizers=4,
                  sliding_window=WINDOW)
HOP = TINY.hop_length // TINY.downsample_stride  # samples a 25 Hz frame


def _ref_cfg(window=WINDOW):
    """The benchmark's configuration at the tiny size."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "mimi_24khz.json").read_text())
    return {**cfg, "num_filters": 8, "hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 4, "head_dim": 8, "intermediate_size": 64,
            "codebook_size": 64, "codebook_dim": 16, "vector_quantization_hidden_dimension": 16,
            "num_quantizers": 4, "encode_codebooks": 4, "sliding_window": window}


def _pcm(rows, n, seed):
    """int16 rows of noise shaped by a slow envelope, [rows, n]."""
    rng = np.random.default_rng(seed)
    env = 0.3 + 0.2 * np.sin(np.arange(n) / 700.0 + rng.uniform(0, 6, (rows, 1)))
    return np.round(rng.standard_normal((rows, n)) * env * 8000).astype(np.int16)


def _weights(cfg, seed, pool):
    w = ref.make_weights(cfg, {"path": "encode"}, seed, "cpu")
    return {**w, **ref.fit(cfg, {"path": "encode"}, w, pool, seed, "cpu")}


@pytest.fixture
def port(monkeypatch):
    """A function that builds the port's Mimi encoder at the tiny size on the
    CPU with the given reference weights."""
    monkeypatch.setattr(encoders, "MimiConfig", lambda: TINY)

    def build(weights):
        at = AudioToken(Tokenizers.mimi, device="cpu", num_codebooks=4, weights="random")
        at.load_encoder()
        at.encoder.model.load_state_dict(
            {**weights["encoder"], "semantic_codebooks": weights["semantic_codebooks"],
             "acoustic_codebooks": weights["acoustic_codebooks"]}, strict=True)
        return at.encoder

    return build


@pytest.mark.parametrize("frames", [5, 40], ids=["below_window", "above_window"])
def test_codes_match_the_reference(port, frames):
    cfg = _ref_cfg()
    pcm = _pcm(2, frames * HOP, frames)
    req = SimpleNamespace(batch=pcm, lengths=[pcm.shape[1]] * 2)
    w = _weights(cfg, 7 + frames, [req])
    codes = port(w)(pcm, np.asarray(req.lengths, np.int32))
    assert codes.shape == (2, 4, -(-frames // 2)) and codes.dtype == np.int16
    with torch.inference_mode():
        want = ref.encode({**w["encoder"], **w}, cfg, torch.from_numpy(pcm).float() / 32768.0, 4)
    whole = pcm.shape[1] // TINY.hop_length
    assert np.array_equal(codes[:, :, :whole], want[:, :, :whole].numpy())
    assert ref.encode_check(w, cfg, req, codes, "cpu")["code_gap"] <= cfg["limits"]["encode"]["code_gap"]
    # the fitted codebooks spread the frames over the codewords
    assert len(np.unique(codes[:, 0])) > codes[:, 0].size // 3


def test_rows_of_different_lengths_give_each_rows_codes(port):
    """A row shorter than the batch, zero-padded, gives on its whole frames
    the codes it gives alone and the reference's."""
    cfg = _ref_cfg()
    long, short = 40 * HOP, 23 * HOP + 517
    pcm = _pcm(2, long, 3)
    pcm[1, short:] = 0
    req = SimpleNamespace(batch=pcm, lengths=[long, short])
    w = _weights(cfg, 11, [req])
    enc = port(w)
    both = enc(pcm, np.asarray(req.lengths, np.int32))
    alone = enc(pcm[1:, :short], np.asarray([short], np.int32))
    whole = short // TINY.hop_length
    assert np.array_equal(both[1, :, :whole], alone[0, :, :whole])
    assert ref.encode_check(w, cfg, req, both, "cpu")["code_gap"] <= cfg["limits"]["encode"]["code_gap"]


def test_the_window_bounds_the_reference_attention():
    """Past the window the reference's latents move with it; within the
    window they are the full causal attention's (transformers' eager form)."""
    pcm = _pcm(1, 40 * HOP, 5)
    wav = torch.from_numpy(pcm).float() / 32768.0
    w = ref.make_weights(_ref_cfg(), {"path": "encode"}, 13, "cpu")["encoder"]
    with torch.inference_mode():
        banded = ref.latents(w, _ref_cfg(), wav)
        full = ref.latents(w, _ref_cfg(window=10_000), wav)
    inside = (WINDOW - 2) // 2  # code frames whose 25 Hz frames all lie inside the window
    assert torch.equal(banded[:, :inside], full[:, :inside])
    assert (banded[:, inside + 2:] - full[:, inside + 2:]).abs().amin(-1).gt(0).all()


@pytest.mark.parametrize("T,window", [(20, 5), (20, 1), (7, 50), (65, 17)])
def test_window_twin_matches_a_masked_softmax(T, window):
    """The twin (and the wrapper on the CPU) against each query's softmax
    over its own visible keys, in float64."""
    g = torch.Generator().manual_seed(T * 100 + window)
    q, k, v = (torch.randn((2, 3, T, 8), generator=g) for _ in range(3))
    out = flash_attention_window_plain(q, k, v, window)
    assert torch.equal(flash_attention_window(q, k, v, window), out)
    want = torch.empty((2, 3, T, 8), dtype=torch.float64)
    for i in range(T):
        j = slice(max(0, i - window + 1), i + 1)
        s = q[:, :, i:i + 1].double() @ k[:, :, j].double().transpose(-1, -2) / 8**0.5
        want[:, :, i] = (torch.softmax(s, -1) @ v[:, :, j].double())[:, :, 0]
    assert torch.allclose(out.double(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("pads", [(6, 0), (2, 3), (0, 0), (9, 9)])
@pytest.mark.parametrize("res", [True, False], ids=["residual", "bare"])
@pytest.mark.parametrize("elu", [True, False], ids=["elu", "noelu"])
def test_elu_pad_zero_mode(pads, res, elu):
    """``pad_mode="constant"`` is ``F.pad(F.elu(x + r))`` with zeros, on a
    row shorter than its pads too; the wrapper on the CPU is the twin."""
    g = torch.Generator().manual_seed(sum(pads) + 2 * res + elu)
    x, r = (torch.randn((2, 3, 7), generator=g) for _ in range(2))
    v = x + r if res else x
    want = F.pad(F.elu(v) if elu else v, pads)
    out, kept = elu_pad(x, *pads, residual=r if res else None, elu=elu, keep_input=True,
                        pad_mode="constant")
    assert torch.equal(out, want) and torch.equal(kept, v)
    assert torch.equal(elu_pad_plain(x, *pads, r if res else None, elu, pad_mode="constant"), want)
    with pytest.raises(ValueError, match="pad_mode"):
        elu_pad(x, *pads, pad_mode="circular")


def test_mimi_refuses_other_precisions_and_decode(port):
    with pytest.raises(ValueError, match="precision"):
        AudioToken(Tokenizers.mimi, device="cpu", num_codebooks=4, weights="random",
                   precision="bfloat16").load_encoder()
    with pytest.raises(ValueError, match="num_codebooks"):
        AudioToken(Tokenizers.mimi, device="cpu", num_codebooks=33)
    with pytest.raises(NotImplementedError, match="Queue 4"):
        AudioToken(Tokenizers.mimi, device="cpu", weights="random").load_decoder()


def test_mimi_weights_are_random_or_artifacts(tmp_path):
    from audiotoken_tpu_torch.weights import get_mimi_params

    with pytest.raises(ValueError, match="'random' or 'artifacts'"):
        get_mimi_params(str(tmp_path))



def test_chip_smoke_lists_every_launch_of_a_mimi_forward(monkeypatch):
    """chip_smoke 4g times the elu_pad launches its MIMI_ELU_PAD_LAUNCHES
    lists at B=32 x 30 s; a SEANet forward of 1 s at Mimi's widths (every
    stage's length divides by its stride, as at 30 s, so the pads are the
    same) makes the same calls in the same order, the lengths scaled by 30,
    all of them zero pads."""
    import chip_smoke
    import audiotoken_tpu_torch.nn.seanet as seanet
    from audiotoken_tpu_torch.nn.seanet import SeanetEncoder

    calls = []

    def recorded(x, left, right, residual=None, elu=True, keep_input=False, pad_mode="reflect"):
        assert pad_mode == "constant" and x.is_contiguous()
        calls.append((x.shape[1], 30 * x.shape[2], 0, (left, right), residual is not None, elu,
                      keep_input))
        return elu_pad(x, left, right, residual=residual, elu=elu, keep_input=keep_input,
                       pad_mode=pad_mode)

    monkeypatch.setattr(seanet, "elu_pad", recorded)
    with torch.inference_mode():
        SeanetEncoder(MimiConfig().seanet)(torch.zeros(1, 24000))
    assert calls == chip_smoke.MIMI_ELU_PAD_LAUNCHES
