"""Mimi's kernels on the card against their plain versions: K3 at D = 256
(``csrc/rvq.cu``) at the cell's row count, the window attention kernel
(``csrc/flash_attention.cu``) at the cell's shape and below its window,
``elu_pad``'s zero mode, the whole encoder against the CPU's twins; and
the kernels Mimi shares with EnCodec (K3 at D = 128, the reflect
``elu_pad``) giving the bits they gave before, on fixed inputs.

Every test needs an NVIDIA GPU and skips without one:

    python -m pytest --noconftest -q tests/test_torch_mimi_cuda.py
"""

import hashlib

import numpy as np
import pytest
import torch

from audiotoken_tpu_torch.ops import rvq as rvq_ops
from audiotoken_tpu_torch.ops.elu_pad import elu_pad, elu_pad_plain
from audiotoken_tpu_torch.ops.flash_attention import (
    flash_attention_window,
    flash_attention_window_plain,
)
from audiotoken_tpu_torch.ops.rvq import rvq_encode, rvq_encode_plain
from audiotoken_tpu_torch.runtime.precision import get_policy

pytestmark = pytest.mark.cuda

# Kernel and plain version sum in different orders; the kernels' products
# are 3xTF32 (about 2^-22 relative dropped), the plain versions' IEEE f32.
ATOL = 1e-4
# K3 against its plain version: late-codebook near-ties may flip
RVQ_AGREEMENT = 0.999
#: rows of the cell's RVQ: 32 rows of 375 code frames
CELL_ROWS = 32 * 375


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with get_policy("highest").numerics():
        yield torch.device("cuda")


def _randn(dev, shape, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev) * scale


@pytest.mark.parametrize("num_q", [1, 31])
def test_rvq_d256_matches_plain(dev, num_q):
    """The cell's two launches: 1 semantic and 31 acoustic codebooks of
    2048 x 256 over 12,000 rows. Codewords 600-699 repeat 100-199 exactly:
    a later copy is never chosen."""
    cb = _randn(dev, (num_q, 2048, 256), num_q)
    cb[:, 600:700] = cb[:, 100:200]
    x = _randn(dev, (32, 375, 256), 100 + num_q, 2.0)
    before = rvq_encode.launches
    out = rvq_encode(cb, x, num_q)
    torch.cuda.synchronize()
    assert rvq_encode.launches == before + 1
    assert rvq_ops.rvq_plan(CELL_ROWS, torch.cuda.get_device_properties(dev).multi_processor_count,
                            128) == 4
    ref = rvq_encode_plain(cb, x, num_q)
    assert out.shape == ref.shape == (32, num_q, 375)
    assert (out == ref).float().mean().item() >= RVQ_AGREEMENT
    assert not ((out >= 600) & (out < 700)).any()


@pytest.mark.parametrize("N", [1, 127, 129, 2250])
def test_rvq_d256_plans_agree(dev, N):
    """Every cluster split computes each distance with the same products in
    the same order, at row counts around a block's 128 rows."""
    cb = _randn(dev, (4, 2048, 256), 7)
    x = _randn(dev, (1, N, 256), N)
    codes = [rvq_ops._launch(cb, x, 4, split) for split in rvq_ops.SPLITS]
    torch.cuda.synchronize()
    for c in codes[1:]:
        assert torch.equal(c, codes[0])
    assert (codes[0] == rvq_encode_plain(cb, x, 4)).float().mean().item() >= RVQ_AGREEMENT


def test_rvq_d256_tie_takes_first_index(dev):
    cb = _randn(dev, (1, 2048, 256), 3)
    cb[0, 1700] = cb[0, 5]
    x = cb[0, [5, 1700, 5]][None] + 0.01 * _randn(dev, (1, 3, 256), 4)
    assert rvq_encode(cb, x, 1)[0, 0].tolist() == [5, 5, 5]


@pytest.mark.parametrize("B,T,window", [(32, 750, 250), (2, 200, 250), (2, 250, 250),
                                        (2, 1, 250), (3, 129, 64), (2, 777, 1), (2, 300, 17)])
def test_window_matches_plain(dev, B, T, window):
    """The cell's shape, [32, 8, 750, 64] in a window of 250, rows shorter
    than the window, a window of one key, and ragged tiles."""
    q, k, v = (_randn(dev, (B, 8, T, 64), 10 * T + i) for i in range(3))
    before = flash_attention_window.launches
    out = flash_attention_window(q, k, v, window)
    torch.cuda.synchronize()
    assert flash_attention_window.launches == before + 1
    ref = flash_attention_window_plain(q, k, v, window)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= ATOL


def test_window_refuses_what_it_does_not_take(dev):
    q = _randn(dev, (1, 2, 10, 32), 1)
    with pytest.raises(ValueError, match="head size"):
        flash_attention_window(q, q, q, 4)
    with pytest.raises(ValueError, match="window"):
        flash_attention_window(q, q, q, 0)


@pytest.mark.parametrize("shape,pads,res", [
    ((32, 1, 720000), (6, 0), False),   # conv_in
    ((32, 64, 720000), (2, 0), False),  # stage 1's conv1
    ((32, 64, 180000), (4, 0), True),   # stage 1's down conv (stride 4)
    ((32, 512, 3000), (8, 0), True),    # stage 4's down conv
    ((3, 5, 1001), (5, 4), True),
    ((2, 3, 1), (8, 7), True),
])
@pytest.mark.parametrize("elu", [True, False], ids=["elu", "bare"])
def test_elu_pad_zero_matches_plain(dev, shape, pads, res, elu):
    x = _randn(dev, shape, 1)
    r = _randn(dev, shape, 2) if res else None
    out, kept = elu_pad(x, *pads, residual=r, elu=elu, keep_input=True, pad_mode="constant")
    torch.cuda.synchronize()
    ref, ref_kept = elu_pad_plain(x, *pads, r, elu, keep_input=True, pad_mode="constant")
    assert torch.equal(out, ref) and torch.equal(kept, ref_kept)


def test_elu_pad_zero_refuses_bf16(dev):
    with pytest.raises(ValueError, match="dtype"):
        elu_pad(_randn(dev, (1, 2, 9), 1).bfloat16(), 2, 0, pad_mode="constant")


def test_mimi_encoder_on_the_card(dev):
    """The encoder at published widths, 2 rows of 3 s: the kernels run (8
    window launches, 2 of K3, 14 of ``elu_pad`` a forward), and the codes
    agree with the CPU's twins on all but near ties."""
    from audiotoken_tpu_torch.encoders import MimiEncoder

    x = (np.random.default_rng(1).standard_normal((2, 72000)) * 3000).astype(np.int16)
    counts = (flash_attention_window.launches, rvq_encode.launches, elu_pad.launches)
    enc = MimiEncoder(weights="random", seed=0, device=dev)
    codes = enc(x)
    assert codes.shape == (2, 32, 38) and codes.dtype == np.int16
    assert (flash_attention_window.launches - counts[0], rvq_encode.launches - counts[1],
            elu_pad.launches - counts[2]) == (8, 2, 14)
    cpu = MimiEncoder(weights="random", seed=0, device="cpu")(x)
    assert (codes[:, 0] == cpu[:, 0]).mean() >= 0.99


# --- the kernels EnCodec shares with Mimi, on fixed inputs --------------------

#: sha256 of K3's D = 128 codes and the reflect ``elu_pad``'s outputs on the
#: inputs of ``_fixed_shared``, as the kernels gave them before the D = 256
#: form and the zero mode were added (one H100 80GB HBM3, torch 2.11 with
#: CUDA 12.8; a new nvcc may change them: recompute from the older tree)
SHARED_SHA256 = {
    "rvq128": "52df8a01cbce1fbaf4cfcf18f7fbaefb29772fa9108d83187011ed36fe2af068",
    "elu_pad_reflect": "cd964c580e0439ba2c7c8ca8018bacf6af13ceddd4cc1ad66c80d29dbf7c5ab0",
    "elu_pad_reflect_keep": "0ccfd2532860d5af497fc3f69c9e8ac9d81ca89a4a903bc050242a96f095b1a5",
}


def _fixed_shared(dev):
    cb = _randn(dev, (16, 1024, 128), 5)
    x = _randn(dev, (32, 2250, 128), 6)
    h = _randn(dev, (32, 64, 360000), 7)
    r = _randn(dev, (32, 64, 360000), 8)
    out = {"rvq128": rvq_encode(cb, x, 16),
           "elu_pad_reflect": elu_pad(h, 4, 0, residual=r),
           "elu_pad_reflect_keep": torch.cat([t.flatten() for t in elu_pad(
               h[:, :, :90001], 2, 0, keep_input=True)])}
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest() for name, t in out.items()}


def test_shared_kernels_give_the_bits_they_gave(dev):
    assert _fixed_shared(dev) == SHARED_SHA256
