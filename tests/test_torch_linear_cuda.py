"""``linear_3xtf32`` (``csrc/linear_3xtf32.cu``) on the card: its error
against a float64 product beside cuBLAS's IEEE SGEMM at the semantic_m
encoder's shapes, the bias, the launch count, and weights written in place.

Every test here needs an NVIDIA GPU and skips without one:

    python -m pytest --noconftest -q tests/test_torch_linear_cuda.py
"""

import pytest
import torch
import torch.nn.functional as F

from audiotoken_tpu_torch.nn.conformer import W2VBertConfig, W2VBertFeatures
from audiotoken_tpu_torch.ops.linear import Linear, linear_3xtf32
from audiotoken_tpu_torch.runtime.precision import get_policy

pytestmark = pytest.mark.cuda

#: (K, N) of the semantic_m encoder's linears: q, k, v, out and pw2; the
#: projection; pw1; each FFN's input; each FFN's output
SHAPES = [(1024, 1024), (160, 1024), (1024, 2048), (1024, 4096), (4096, 1024)]
#: rows: a B=8 x 30 s call's frames, one row, ragged tiles, one 30 s row
ROWS = [11992, 1, 63, 1499]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with get_policy("highest").numerics():
        yield torch.device("cuda")


def _operands(dev, M, K, N, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, device=dev, generator=g)
    w = torch.randn(N, K, device=dev, generator=g) * K ** -0.5
    b = torch.randn(N, device=dev, generator=g)
    return x, w, b


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("K,N", SHAPES)
def test_error_within_four_times_cublas(dev, K, N, M):
    """The largest error against float64 is at most 4 times cuBLAS IEEE
    SGEMM's on the same inputs (the ratio is printed)."""
    x, w, b = _operands(dev, M, K, N, seed=K + N + M)
    ref = F.linear(x.double(), w.double(), b.double())
    err = (linear_3xtf32(x, w, b).double() - ref).abs().max().item()
    cublas = (F.linear(x, w, b).double() - ref).abs().max().item()
    print(f"K={K} N={N} M={M}: kernel {err:.3e}, cuBLAS {cublas:.3e}, ratio {err / cublas:.2f}")
    assert err <= 4 * cublas


def test_bias_is_added(dev):
    x, w, b = _operands(dev, 300, 1024, 1024)
    assert torch.equal(linear_3xtf32(x, w, b), linear_3xtf32(x, w) + b)


def test_leading_dims_strides_and_empty(dev):
    """x of any leading shape, a column slice (not contiguous) and no rows."""
    x, w, b = _operands(dev, 2 * 37, 2048, 1024)
    xs = x[:, 512:1536]  # rows of 2048, every row's 1024 columns from 512 on
    y = linear_3xtf32(xs.reshape(2, 37, 1024), w[:, :1024].contiguous(), b)
    assert y.shape == (2, 37, 1024)
    ref = linear_3xtf32(xs.contiguous(), w[:, :1024].contiguous(), b)
    assert torch.equal(y.reshape(74, 1024), ref)
    assert linear_3xtf32(x[:0, :1024], w[:, :1024].contiguous(), b).shape == (0, 1024)


def test_counter_counts_the_conformers_linears(dev):
    """One launch a linear of a forward at ``highest``: 10 a block and the
    projection; none under TF32 (``high``) or on the CPU."""
    cfg = W2VBertConfig(num_hidden_layers=2)
    m = W2VBertFeatures(cfg, 2).to(dev).eval()
    x = torch.randn(1, 50, 160, device=dev)
    for precision, want in (("highest", 21), ("high", 0)):
        before = linear_3xtf32.launches
        with torch.inference_mode():
            m(x, None, precision)
        assert linear_3xtf32.launches - before == want, precision
    lin = Linear(1024, 1024).to(dev)
    before = linear_3xtf32.launches
    with torch.no_grad():
        lin(x.new_ones(3, 1024))
    assert linear_3xtf32.launches == before + 1


def test_misfit_width_or_gradient_raises_at_highest(dev):
    """At ``highest`` a width the kernel does not take, or a gradient asked
    for, raises rather than fall back to cuBLAS; under TF32 cuBLAS runs."""
    x = torch.randn(64, 1024, device=dev)
    for lin in (Linear(1024, 1000), Linear(1000, 1024)):
        lin = lin.to(dev)
        xi = x[:, :lin.in_features]
        with torch.no_grad(), pytest.raises(ValueError, match="multiples"):
            lin(xi)
        with get_policy("high").numerics(), torch.no_grad():
            assert lin(xi).shape == (64, lin.out_features)
    lin = Linear(1024, 1024).to(dev)
    with pytest.raises(ValueError, match="backward"):
        lin(x)
    with torch.no_grad():
        assert lin(x).shape == (64, 1024)


def test_weights_written_in_place_are_seen(dev):
    """The weights are split on every call: a write through the parameter or
    through ``.data`` (which keeps ``_version``) shows in the next call."""
    lin = Linear(1024, 1024).to(dev)
    x = torch.randn(64, 1024, device=dev)
    with torch.no_grad():
        y0 = lin(x)
        lin.weight.mul_(2)
        y1 = lin(x)
        version = lin.weight._version
        lin.weight.data.copy_(torch.randn(1024, 1024, device=dev))
        assert lin.weight._version == version
        y2 = lin(x)
        ref = F.linear(x.double(), lin.weight.double(), lin.bias.double())
    assert not torch.equal(y0, y1)
    assert (y2.double() - ref).abs().max().item() < 1e-3  # |y| up to about 150
