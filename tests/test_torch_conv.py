"""The port's EnCodec-padded conv1d against the JAX package's (NCH and NHC)."""

import numpy as np
import pytest
import torch

from audiotoken_tpu.ops.conv import conv1d as jax_conv1d
from audiotoken_tpu.ops.conv import pad_amounts as jax_pad_amounts
from audiotoken_tpu_torch.ops.conv import conv1d, pad_amounts

ATOL = 1e-5

# (K, stride, dilation) of every conv on the encoder path: conv_in and
# conv_out (k7), the residual k3 and 1x1 convs, and the four downsamplers.
ENCODER_CONVS = [(7, 1, 1), (3, 1, 1), (1, 1, 1), (4, 2, 1), (8, 4, 1), (10, 5, 1), (16, 8, 1)]


def _case(K, stride, length, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, length)).astype(np.float32)  # [B, C, T]
    w = (rng.standard_normal((K, 3, 5)) * 0.3).astype(np.float32)  # JAX [K, C_in, C_out]
    b = rng.standard_normal(5).astype(np.float32)
    return x, w, b


def _port(x, w, b, stride, dilation):
    out = conv1d(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                 torch.from_numpy(b), stride=stride, dilation=dilation)
    return out.numpy()


@pytest.mark.parametrize("K,stride,dilation", ENCODER_CONVS)
@pytest.mark.parametrize("kind", ["multiple", "ragged", "short"])
def test_conv1d_matches_jax(K, stride, dilation, kind):
    k_eff = (K - 1) * dilation + 1
    length = {"multiple": 24 * stride, "ragged": 24 * stride + 3,
              "short": max(1, k_eff - stride)}[kind]  # "short": length <= pad
    x, w, b = _case(K, stride, length, seed=K * 100 + stride + length)
    out = _port(x, w, b, stride, dilation)
    ref_nch = np.asarray(jax_conv1d(x, w, b, stride=stride, dilation=dilation, layout="NCH"))
    ref_nhc = np.asarray(jax_conv1d(x.transpose(0, 2, 1), w, b, stride=stride,
                                    dilation=dilation, layout="NHC"))
    assert out.shape == ref_nch.shape
    np.testing.assert_allclose(out, ref_nch, atol=ATOL)
    np.testing.assert_allclose(out, ref_nhc.transpose(0, 2, 1), atol=ATOL)


def test_conv1d_dilated_matches_jax():
    x, w, b = _case(3, 1, 50, seed=1)
    ref = np.asarray(jax_conv1d(x, w, b, dilation=2, layout="NCH"))
    np.testing.assert_allclose(_port(x, w, b, 1, 2), ref, atol=ATOL)


def test_pad_amounts_equal():
    for length in list(range(1, 40)) + [24000, 36001, 720000]:
        for K, stride, dilation in ENCODER_CONVS + [(3, 1, 2)]:
            for causal in (True, False):
                args = (length, K, stride, dilation, causal)
                assert pad_amounts(*args) == jax_pad_amounts(*args), args
