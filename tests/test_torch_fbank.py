"""The port's fbank front-end against the JAX package's, on the CPU.

Features within 1e-4 abs (f32 matmuls summed in another order; the
normalised features are O(1)), masks equal. Silence and dims that are
constant over time must be exact zeros, as on the JAX side. On a DC-offset
input the spectrum's terms cancel, so the port's features are held to an
f64 computation instead.
"""

import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.fbank import FbankConfig as JaxFbankConfig
from audiotoken_tpu.nn.fbank import fbank_features as jax_fbank_features
from audiotoken_tpu_torch.nn.fbank import FbankConfig, _folded_dft, fbank_features

ATOL = 1e-4


def _both(audio, mask, pad_to_multiple_of=2):
    ref = jax_fbank_features(audio, mask, JaxFbankConfig(), pad_to_multiple_of=pad_to_multiple_of)
    out = fbank_features(torch.from_numpy(audio), torch.from_numpy(mask), FbankConfig(),
                         pad_to_multiple_of=pad_to_multiple_of)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in out.items()})


def test_folded_dft_equals_jax():
    from audiotoken_tpu.nn.fbank import _folded_dft as jax_folded_dft

    for a, b in zip(_folded_dft(FbankConfig()), jax_folded_dft(JaxFbankConfig())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pad_to_multiple_of", [0, 2])
@pytest.mark.parametrize("n", [16_000, 16_000 + 159, 16_000 + 161, 7_777])
def test_ragged_masks(n, pad_to_multiple_of):
    """Lengths one short of and one past a hop, and ragged prefix masks."""
    rng = np.random.default_rng(n + pad_to_multiple_of)
    audio = (rng.standard_normal((3, n)) * 0.2).astype(np.float32)
    mask = np.ones((3, n), np.float32)
    mask[1, n - 1234:] = 0.0
    mask[2, n // 2 + 17:] = 0.0
    ref, out = _both(audio * mask, mask, pad_to_multiple_of)
    assert out["input_features"].shape == ref["input_features"].shape
    assert out["input_features"].dtype == np.float32
    np.testing.assert_array_equal(out["attention_mask"], ref["attention_mask"])
    np.testing.assert_allclose(out["input_features"], ref["input_features"], rtol=0, atol=ATOL)


def test_non_prefix_mask():
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal((2, 12_000)) * 0.2).astype(np.float32)
    mask = np.ones_like(audio)
    mask[0, 3_000:4_000] = 0.0  # a hole, not a prefix
    ref, out = _both(audio, mask)
    np.testing.assert_array_equal(out["attention_mask"], ref["attention_mask"])
    np.testing.assert_allclose(out["input_features"], ref["input_features"], rtol=0, atol=ATOL)


def test_silence_exactly_zero():
    audio = np.zeros((1, 32_000), np.float32)
    ref, out = _both(audio, np.ones_like(audio))
    valid = out["attention_mask"] > 0
    assert valid.any() and (out["input_features"][valid] == 0.0).all()
    assert (ref["input_features"][valid] == 0.0).all()


def test_constant_dims_exact_under_ragged_mask():
    """Silence padded past its valid prefix with other samples: the masked
    moments are still exact zeros on the valid frames."""
    audio = np.zeros((1, 32_000), np.float32)
    audio[0, 24_000:] = 0.5
    mask = np.zeros_like(audio)
    mask[0, :24_000] = 1.0
    ref, out = _both(audio, mask)
    valid = out["attention_mask"] > 0
    np.testing.assert_array_equal(out["attention_mask"], ref["attention_mask"])
    assert (out["input_features"][valid] == 0.0).all()
    np.testing.assert_allclose(out["input_features"], ref["input_features"], rtol=0, atol=ATOL)


def _f64_features(audio, mask, cfg=FbankConfig()):
    """The same fbank in numpy float64, on the same f32 folded matrix."""
    fold, mel = (a.astype(np.float64) for a in _folded_dft(cfg))
    idx = np.arange(0, audio.shape[-1] - 400 + 1, 160)[:, None] + np.arange(400)
    spec = audio.astype(np.float64)[:, idx] @ fold
    feats = np.log(np.maximum((spec[..., :257] ** 2 + spec[..., 257:] ** 2) @ mel, cfg.mel_floor))
    fm = (mask.astype(np.float64)[:, idx].mean(-1) == 1.0)[:, :, None]
    count = np.maximum(fm.sum(1, keepdims=True), 1)
    fs = (feats - feats[:, :1]) * fm
    mean = fs.sum(1, keepdims=True) / count
    var = ((fs - mean) ** 2 * fm).sum(1, keepdims=True) / count
    f = (feats - feats[:, :1] - mean) / np.sqrt(var + 1e-7)
    keep = f.shape[1] - f.shape[1] % 2
    return f[:, :keep].reshape(f.shape[0], keep // 2, 160)


def test_dc_offset_spectrum_exact():
    """A constant offset plus a few LSB of dither, after an int16 roundtrip
    (the golden battery's dc_offset_i16 row): within 1e-4 of the f64
    computation. An f32 spectrum product summed in torch's order is off by
    about 0.15 here."""
    rng = np.random.default_rng(7)
    x = 0.35 + 1e-4 * rng.standard_normal((1, 48_000))
    x = (np.round(x * 32768.0) / 32768.0).astype(np.float32)
    mask = np.ones_like(x)
    out = fbank_features(torch.from_numpy(x), torch.from_numpy(mask), pad_to_multiple_of=0)
    np.testing.assert_allclose(out["input_features"].numpy(), _f64_features(x, mask),
                               rtol=0, atol=ATOL)
