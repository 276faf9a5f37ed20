"""``ops/linear.py`` on the CPU: the conformer's ``Linear`` modules give
``nn.Linear``'s bits and keys, ``linear_3xtf32`` refuses what its kernel
does not take (CPU tensors among them), and the dispatch follows the TF32
switch. The kernel itself
runs on the card (``tests/test_torch_linear_cuda.py``)."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from audiotoken_tpu_torch.nn import conformer
from audiotoken_tpu_torch.nn.conformer import W2VBertConfig, W2VBertFeatures, init_w2vbert_params
from audiotoken_tpu_torch.ops.flash_attention import tf32_round
from audiotoken_tpu_torch.ops.linear import (
    Linear,
    kernel_takes,
    linear_3xtf32,
    linear_3xtf32_twin,
)
from audiotoken_tpu_torch.runtime.precision import StagePrecision, tf32_numerics
from audiotoken_tpu_torch.weights import w2vbert_from_numpy

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            feature_projection_input_dim=160, left_max_position_embeddings=8,
            right_max_position_embeddings=4, conv_depthwise_kernel_size=7)


def _features(linear_cls, monkeypatch):
    """The tiny conformer built with ``linear_cls`` as its linears, the seed-3
    numpy draw loaded strictly."""
    monkeypatch.setattr(conformer, "Linear", linear_cls)
    cfg = W2VBertConfig(**TINY)
    m = W2VBertFeatures(cfg, 2)
    m.load_state_dict(w2vbert_from_numpy(init_w2vbert_params(np.random.default_rng(3), cfg), 2),
                      strict=True)
    return m.eval()


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_conformer_on_the_cpu_is_nn_linear_bit_for_bit(monkeypatch, precision):
    """On CPU tensors the conformer's linears are ``nn.Linear``'s, bit for
    bit, padded rows and all."""
    new, old = _features(Linear, monkeypatch), _features(nn.Linear, monkeypatch)
    assert all(type(m) is Linear for m in new.modules() if isinstance(m, nn.Linear))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 37, 160)).astype(np.float32))
    mask = torch.ones(2, 37)
    mask[1, 20:] = 0
    with torch.inference_mode():
        assert torch.equal(new(x, mask, precision), old(x, mask, precision))


def test_state_dict_keys_are_nn_linears(monkeypatch):
    new, old = _features(Linear, monkeypatch), _features(nn.Linear, monkeypatch)
    assert list(new.state_dict()) == list(old.state_dict())
    assert sum(isinstance(m, Linear) for m in new.modules()) == 2 * 10 + 1


def test_cpu_takes_f_linear_and_launches_nothing():
    """``Linear`` makes the device choice: a CPU tensor takes ``F.linear``
    (at any width, with or without a gradient), and the kernel's wrapper
    refuses it."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    before = linear_3xtf32.launches
    with pytest.raises(ValueError, match="device"):
        linear_3xtf32(x, w)
    with tf32_numerics(False):
        for lin in (Linear(64, 128), Linear(48, 100)):
            xi = x[..., :lin.in_features]
            assert torch.equal(lin(xi), F.linear(xi, lin.weight, lin.bias))
            with torch.no_grad():
                assert torch.equal(lin(xi), F.linear(xi, lin.weight, lin.bias))
    assert linear_3xtf32.launches == before


def test_twin_is_f32_accurate():
    """The kernel's arithmetic, three TF32 products of split parts, is within
    a few f32 units of the float64 product, where one TF32 pass is not."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 256)) / 16).astype(np.float32))
    ref = F.linear(x.double(), w.double())
    twin = (linear_3xtf32_twin(x, w).double() - ref).abs().max().item()
    ieee = (F.linear(x, w).double() - ref).abs().max().item()
    one = (F.linear(tf32_round(x), tf32_round(w)).double() - ref).abs().max().item()
    assert twin < 4 * ieee and twin < one / 100


def _x(shape=(8, 1024), dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("case", [
    "x_bf16", "weight_f16", "bias_f64", "meta_device", "weight_1d", "weight_other_k",
    "bias_shape", "k_not_32", "n_not_128", "cpu_device", "weight_needs_grad",
])
def test_wrapper_refuses(case):
    x, w, b = _x(), torch.zeros(1024, 1024), torch.zeros(1024)
    if case == "x_bf16":
        x = x.bfloat16()
    elif case == "weight_f16":
        w = w.half()
    elif case == "bias_f64":
        b = b.double()
    elif case == "meta_device":
        x, w, b = x.to("meta"), w.to("meta"), b.to("meta")
    elif case == "weight_1d":
        w = torch.zeros(1024)
    elif case == "weight_other_k":
        w = torch.zeros(1024, 512)
    elif case == "bias_shape":
        b = torch.zeros(512)
    elif case == "k_not_32":
        x, w = _x((8, 48)), torch.zeros(1024, 48)
    elif case == "n_not_128":
        w, b = torch.zeros(1000, 1024), torch.zeros(1000)
    elif case == "weight_needs_grad":  # refused before the device is looked at
        w.requires_grad_(True)
    with pytest.raises(ValueError):
        linear_3xtf32(x, w, b)


def _cuda_input(shape=(8, 1024), dtype=torch.float32):
    """What ``kernel_takes`` reads of a CUDA tensor, without a card."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=shape)


def test_dispatch_follows_the_tf32_switch():
    """The kernel runs where cuBLAS's TF32 switch is off (a stage at
    ``highest``) and cuBLAS's TF32 runs where it is on, as each stage of the
    map sets it; on the CPU neither."""
    w = torch.zeros(1024, 1024)
    with tf32_numerics(False):
        assert kernel_takes(_cuda_input(), w)
        assert not kernel_takes(_x(), w)
    with tf32_numerics(True):
        assert not kernel_takes(_cuda_input(), w)
    P = StagePrecision("high", {"ffn_in": "highest"})
    with P.numerics("ffn_in"):
        assert kernel_takes(_cuda_input(), w)
    with P.numerics("ffn_out"):
        assert not kernel_takes(_cuda_input(), w)
    for mode in ("high", "default", "bfloat16"):
        with StagePrecision(mode).numerics("conv"):
            assert not kernel_takes(_cuda_input(), w), mode


def test_dispatch_refuses_other_inputs():
    """Other dtypes keep ``F.linear``. A width or a gradient that the kernel
    does not take is not a reason to fall back: such an input goes to the
    wrapper, which raises (``test_wrapper_refuses``)."""
    with tf32_numerics(False):
        assert not kernel_takes(_cuda_input(dtype=torch.bfloat16), torch.zeros(1024, 1024))
        assert not kernel_takes(_cuda_input(), torch.zeros(1024, 1024, dtype=torch.float64))
        assert kernel_takes(_cuda_input((8, 48)), torch.zeros(1024, 48))
        assert kernel_takes(_cuda_input(), torch.zeros(1000, 1024))
        assert kernel_takes(_cuda_input(), torch.zeros(1024, 1024, requires_grad=True))
