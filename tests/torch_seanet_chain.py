"""The SEANet encoder and decoder of ``nn/seanet.py`` as they ran before
``elu_pad``: every conv through ``ops/conv.py:conv1d`` (a reflect pad into
a fresh tensor, also at (0, 0)), each ELU an ``F.elu`` and each residual
sum written out. The tests hold the rewired modules to it bit for bit,
on the CPU and on the card."""

import torch.nn.functional as F

from audiotoken_tpu_torch.ops.conv import conv1d, conv_transpose1d
from audiotoken_tpu_torch.ops.lstm import lstm_skip
from audiotoken_tpu_torch.ops.seanet_front import seanet_front


def _conv(m, x):
    return conv1d(x, m.weight, m.bias, stride=m.stride, dilation=m.dilation)


def _res(block, x):
    return _conv(block.shortcut, x) + _conv(block.conv2, F.elu(_conv(block.conv1, F.elu(x))))


def _lstm(m, h, dtype):
    layers = [(l.wih, l.whh, l.bih, l.bhh) for l in m.lstm]
    return lstm_skip(layers, h.transpose(1, 2).float()).to(dtype)


def encoder_chain(enc, x):
    """``SeanetEncoder.forward`` before ``elu_pad``."""
    dtype = x.dtype
    h = seanet_front(x.float(), *enc.front_weights()).to(dtype)
    for si, stage in enumerate(enc.stages):
        if si > 0:
            for res in stage.res:
                h = _res(res, h)
        h = _conv(stage.down, F.elu(h))
    h = _lstm(enc, h, dtype)
    return _conv(enc.conv_out, F.elu(h).transpose(1, 2)).transpose(1, 2)


def decoder_chain(dec, z):
    """``SeanetDecoder.forward`` before ``elu_pad``."""
    h = _conv(dec.conv_in, z.transpose(1, 2))
    h = _lstm(dec, h, z.dtype).transpose(1, 2)
    for stage in dec.stages:
        up = stage.up
        h = conv_transpose1d(F.elu(h), up.weight, up.bias, up.stride, up.trim_right_ratio)
        for res in stage.res:
            h = _res(res, h)
    return _conv(dec.conv_out, F.elu(h))[:, 0, :]
