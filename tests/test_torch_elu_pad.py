"""``ops/elu_pad.py`` and the SEANet modules rewired onto it, on the CPU.

The plain twin against the chain it replaces (``F.elu`` of the sum, then
``F.pad(mode="reflect")`` as ``pad1d_reflect`` composes it) at every pad
of the configuration's convs; the CUDA kernel's addressing transcribed in
numpy (its index rule, its 16-byte vectors, shifts and partial vectors)
against the same chain; and ``SeanetEncoder`` / ``SeanetDecoder`` bit for
bit against the chain they ran before (``tests/torch_seanet_chain.py``).
The kernel itself is compared on the card (``test_torch_kernels_cuda.py``).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiotoken_tpu_torch.nn import seanet
from audiotoken_tpu_torch.nn.seanet import (
    SConv1d,
    SeanetConfig,
    SeanetDecoder,
    SeanetEncoder,
    init_decoder_params,
    init_encoder_params,
)
from audiotoken_tpu_torch.ops.elu_pad import elu_pad, elu_pad_plain
from audiotoken_tpu_torch.weights import acoustic_decoder_from_numpy, acoustic_from_numpy
from torch_seanet_chain import decoder_chain, encoder_chain


def _seanet_pads():
    """(left, right) of every conv of the configuration, at every remainder
    of the input length by its stride: (0, 0) for the 1x1 convs."""
    pads = set()
    for model in (SeanetEncoder(), SeanetDecoder()):
        for conv in model.modules():
            if isinstance(conv, SConv1d):
                pads.update(conv.pads(T) for T in range(64, 64 + conv.stride))
    return sorted(pads)


PADS = _seanet_pads()
LENGTHS = (1, 2, 3, 5, 8, 9, 16, 17, 41)  # rows not longer than a pad, and longer


def _chain(x, left, right, r=None, elu=True):
    """The chain written out: the sum, F.elu, zero-extension of a row not
    longer than its pad, F.pad(mode="reflect"), the extension cut off."""
    v = x if r is None else x + r
    h = F.elu(v) if elu else v
    extra = max(0, max(left, right) - h.shape[-1] + 1)
    out = F.pad(F.pad(h, (0, extra)), (left, right), mode="reflect")
    return out[..., : out.shape[-1] - extra]


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_the_pads_hold_every_seanet_conv():
    assert (0, 0) in PADS and (2, 0) in PADS and (6, 0) in PADS
    assert {left for left, _ in PADS} == {0, 2, 4, 5, 6, 8}


@pytest.mark.parametrize("form", ["sum_elu", "elu", "bare"])
@pytest.mark.parametrize("left,right", PADS)
def test_plain_is_the_chain(left, right, form):
    for T in LENGTHS:
        x = _rand((2, 3, T), T)
        r = _rand((2, 3, T), T + 1) if form == "sum_elu" else None
        elu = form != "bare"
        ref = _chain(x, left, right, r, elu)
        out = elu_pad(x, left, right, residual=r, elu=elu)
        assert out.shape == (2, 3, T + left + right)
        assert torch.equal(out, ref), (T, left, right)
        assert torch.equal(elu_pad_plain(x, left, right, r, elu), ref)


# ---------------------------------------------------------------------------
# The kernel's addressing (csrc/elu_pad.cu), transcribed
# ---------------------------------------------------------------------------


def _kernel(xbuf, xoff, strides, shape, left, right, rbuf=None, roff=0, keep=False, tile=256):
    """elu_pad_kernel's addressing over flat float32 buffers, block by
    block, vector by vector: x at element offset ``xoff`` with ``strides``;
    r contiguous at ``roff`` in ``rbuf``; out (and keep) from offset 0.
    ``tile`` is the kernel's THREADS, 16-byte vectors a block. The ELU is left
    out: it acts on each sample alone, where the addressing has put it."""
    B, C, T = shape
    sb, sc, st = strides
    To = T + left + right
    Te = T + max(0, max(left, right) - T + 1)
    out = np.full(B * C * To, np.nan, np.float32)
    kbuf = np.full(B * C * T, np.nan, np.float32) if keep else None
    tiles = ((To + 3) // 4 + 1 + tile - 1) // tile

    def load4(buf, p):  # the aligned vectors that hold buf[p:p + 4], shifted
        a = p - p % 4
        pair = buf[a:a + 8] if p % 4 else buf[a:a + 4]
        return pair[p % 4:p % 4 + 4]

    def gather(xr, rr, j):
        i = j - left
        i = -i if i < 0 else (2 * (Te - 1) - i if i >= Te else i)
        if i >= T:
            return np.float32(0)
        return xbuf[xr + i * st] + (rbuf[rr + i] if rbuf is not None else np.float32(0))

    for row in range(B * C):
        b, c = divmod(row, C)
        xr, rr = xoff + b * sb + c * sc, roff + row * T
        for t in range(tiles):
            o0 = row * To
            for v in range(o0 // 4 + t * tile, o0 // 4 + (t + 1) * tile):
                j = 4 * v - o0
                if j + 4 <= 0 or j >= To:
                    continue
                if 0 <= j and j + 4 <= To:
                    if st == 1 and left <= j and j + 4 <= left + T:
                        w = load4(xbuf, xr + j - left)
                        if rbuf is not None:
                            w = w + load4(rbuf, rr + j - left)
                        out[4 * v:4 * v + 4] = w
                    else:
                        out[4 * v:4 * v + 4] = [gather(xr, rr, j + k) for k in range(4)]
                else:
                    for k in range(4):
                        if 0 <= j + k < To:
                            out[o0 + j + k] = gather(xr, rr, j + k)
            if not keep:
                continue
            k0 = row * T
            for v in range(k0 // 4 + t * tile, k0 // 4 + (t + 1) * tile):
                i = 4 * v - k0
                if 0 <= i and i + 4 <= T:
                    w = (load4(xbuf, xr + i) if st == 1
                         else np.array([xbuf[xr + (i + k) * st] for k in range(4)]))
                    kbuf[4 * v:4 * v + 4] = w + (load4(rbuf, rr + i) if rbuf is not None else 0)
                    continue
                for k in range(4):
                    if 0 <= i + k < T:
                        kbuf[k0 + i + k] = xbuf[xr + (i + k) * st] + (
                            rbuf[rr + i + k] if rbuf is not None else np.float32(0))
    return out.reshape(B, C, To), (kbuf.reshape(B, C, T) if keep else None)


@pytest.mark.parametrize("tile", [1, 3, 256])
@pytest.mark.parametrize("xoff,roff", [(0, 0), (1, 2), (3, 1)])
@pytest.mark.parametrize("left,right", [(0, 0), (2, 0), (6, 0), (8, 7), (5, 4)])
def test_kernel_addressing_is_the_chain(left, right, xoff, roff, tile):
    """Rows of odd lengths start anywhere on out's, x's and r's 16-byte
    grids (x and r at other offsets); short rows zero-extend; a tile of 1
    or 3 vectors splits every row over several blocks."""
    for T in (1, 3, 6, 13):
        B, C = 2, 3
        x, r = _rand((B, C, T), 7 * T), _rand((B, C, T), 7 * T + 1)
        xbuf = np.concatenate([np.full(xoff, np.nan, np.float32), x.numpy().ravel(),
                               np.full(8, np.nan, np.float32)])
        rbuf = np.concatenate([np.full(roff, np.nan, np.float32), r.numpy().ravel(),
                               np.full(8, np.nan, np.float32)])
        out, keep = _kernel(xbuf, xoff, (C * T, T, 1), (B, C, T), left, right, rbuf, roff,
                            keep=True, tile=tile)
        np.testing.assert_array_equal(out, _chain(x, left, right, r, elu=False).numpy())
        np.testing.assert_array_equal(keep, (x + r).numpy())


@pytest.mark.parametrize("layout", ["trimmed", "transposed"])
def test_kernel_addressing_of_a_strided_x(layout):
    """A transposed conv's trimmed output (rows of T + 5 floats, time stride
    1) and an LSTM output seen as [B, C, T] (time stride C)."""
    B, C, T = 2, 3, 11
    if layout == "trimmed":
        full = _rand((B, C, T + 5), 5)
        x = full[..., 2:2 + T]
    else:
        x = _rand((B, T, C), 6).transpose(1, 2)
    xbuf = np.concatenate([x.numpy().ravel(order="K") if layout == "transposed"
                           else full.numpy().ravel(), np.full(8, np.nan, np.float32)])
    out, keep = _kernel(xbuf, x.storage_offset(), x.stride(), (B, C, T), 2, 0, keep=True, tile=1)
    np.testing.assert_array_equal(out, _chain(x, 2, 0, elu=False).numpy())
    np.testing.assert_array_equal(keep, x.numpy())


# ---------------------------------------------------------------------------
# The wrapper's forms, and the rewired modules
# ---------------------------------------------------------------------------


def test_strided_input_and_keep_input():
    """A transposed conv's trimmed view, read as it is; keep_input gives x
    itself where nothing is added and x is contiguous, else x + r written."""
    y = F.conv_transpose1d(_rand((2, 8, 9), 1), _rand((8, 4, 8), 2) * 0.2, stride=4)
    x = y[..., : y.shape[-1] - 4]
    assert not x.is_contiguous()
    out, kept = elu_pad(x, 2, 0, keep_input=True)
    assert torch.equal(out, _chain(x, 2, 0)) and kept.is_contiguous() and torch.equal(kept, x)
    c = x.contiguous()
    assert elu_pad(c, 2, 0, keep_input=True)[1] is c
    r = _rand(tuple(x.shape), 3)
    out, kept = elu_pad(c, 2, 1, residual=r, keep_input=True)
    assert torch.equal(out, _chain(c, 2, 1, r)) and torch.equal(kept, c + r)


def test_cpu_tensors_take_the_twin():
    """f32 and bf16 on the CPU run the chain itself; the kernel never launches."""
    before = elu_pad.launches
    x = _rand((1, 2, 9), 4)
    for t in (x, x.bfloat16()):
        assert torch.equal(elu_pad(t, 6, 0), _chain(t, 6, 0))
    assert elu_pad.launches == before


def test_other_devices_are_refused():
    """Only the CPU takes the twin: a tensor elsewhere that the kernel
    cannot take raises rather than run the chain."""
    with pytest.raises(ValueError, match="device"):
        elu_pad(torch.empty((1, 2, 9), device="meta"), 6, 0)


def _encoder(seed=0):
    enc = SeanetEncoder()
    state, _ = acoustic_from_numpy(
        {"encoder": init_encoder_params(np.random.default_rng(seed), SeanetConfig()),
         "codebooks": np.zeros((1, 1, 128), np.float32)})
    enc.load_state_dict(state)
    return enc.eval()


def _decoder(cfg=SeanetConfig(), seed=0):
    dec = SeanetDecoder(cfg)
    state, _ = acoustic_decoder_from_numpy(
        {"decoder": init_decoder_params(np.random.default_rng(seed), cfg),
         "codebooks": np.zeros((1, 1, 128), np.float32)})
    dec.load_state_dict(state)
    return dec.eval()


@pytest.mark.parametrize("B,T,dtype", [(2, 4001, "f32"), (2, 641, "f32"), (1, 5, "f32"),
                                       (1, 1201, "bf16")])
def test_encoder_matches_the_old_chain(B, T, dtype):
    """Lengths that give extra right pads in the down convs (4001), rows
    shorter than the pads after downsampling (5), and the bf16 policy's
    plain convs."""
    enc = _encoder()
    x = _rand((B, T), T) * 0.3
    if dtype == "bf16":
        x = x.bfloat16()
    with torch.inference_mode():
        out, ref = enc(x), encoder_chain(enc, x)
    assert out.shape == ref.shape == (B, -(-T // 320), 128) and out.dtype == x.dtype
    assert torch.equal(out, ref)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("T", [1, 3, 7])
def test_decoder_matches_the_old_chain(T, layers):
    """Two residual layers a stage write each block's sum for the next
    block's shortcut (``keep_input`` with a residual)."""
    dec = _decoder(replace(SeanetConfig(), num_residual_layers=layers))
    z = _rand((2, T, 128), T)
    with torch.inference_mode():
        out, ref = dec(z), decoder_chain(dec, z)
    assert out.shape == ref.shape == (2, T * 320)
    assert torch.equal(out, ref)


def test_one_elu_pad_before_each_conv_after_k1(monkeypatch):
    """The encoder's forward calls elu_pad 11 times (the stage-0 down conv;
    conv1, conv2 and the down conv of stages 1-3; conv_out), the decoder's
    14 (conv_in; up, conv1 and conv2 of 4 stages; conv_out): the counts the
    kernel's launch counter reads on the card."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[1:3])
        return elu_pad(*args, **kwargs)

    monkeypatch.setattr(seanet, "elu_pad", counted)
    with torch.inference_mode():
        _encoder()(_rand((1, 961), 1))
        assert len(calls) == 11
        calls.clear()
        _decoder()(_rand((1, 3, 128), 2))
        assert len(calls) == 14


def _layout(x):
    """An ``ELU_PAD_LAUNCHES`` layout: 0 contiguous, k a row of T + k
    samples (a trimmed transposed-conv output), None a time stride other
    than 1 (the LSTM's or the latents' [B, T, C] seen as [B, C, T])."""
    if x.stride(-1) != 1:
        return None
    return x.stride(1) - x.shape[-1]


@pytest.mark.parametrize("model", ["encoder", "decoder"])
def test_chip_smoke_lists_every_launch_of_a_forward(monkeypatch, model):
    """chip_smoke 3a times the launches its ELU_PAD_LAUNCHES lists at B=32
    x 30 s; a forward of 1 s (every stage's length divides by its stride,
    as at 30 s, so the pads are the same) makes the same calls in the same
    order, the lengths scaled by 30."""
    import chip_smoke

    calls = []

    def recorded(x, left, right, residual=None, elu=True, keep_input=False, pad_mode="reflect"):
        assert pad_mode == "reflect"  # EnCodec's pads
        calls.append((x.shape[1], 30 * x.shape[2], _layout(x), (left, right),
                      residual is not None, elu, keep_input))
        return elu_pad(x, left, right, residual=residual, elu=elu, keep_input=keep_input,
                       pad_mode=pad_mode)

    monkeypatch.setattr(seanet, "elu_pad", recorded)
    with torch.inference_mode():
        if model == "encoder":
            _encoder()(_rand((1, 24000), 1) * 0.3)
        else:
            _decoder()(_rand((1, 75, 128), 2))
    assert calls == chip_smoke.ELU_PAD_LAUNCHES[model]
