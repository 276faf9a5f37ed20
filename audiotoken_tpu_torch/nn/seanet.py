"""SEANet encoder and decoder (EnCodec 24 kHz architecture) as PyTorch
modules.

Counterpart of ``audiotoken_tpu/nn/seanet.py`` (``seanet_encode``,
``seanet_decode``, ``_resnet_block``, ``lstm_skip``). Activations stay in
PyTorch's [B, C, T] layout and are transposed once, to [B, T, C], around
the LSTM.

The encoder's front (conv_in plus the first residual block, at the full
sample rate) is kernel K1 and the LSTM recurrence, in both directions, is
kernel K2; on a CPU tensor both run their plain PyTorch versions. Every
other conv takes its input from ``elu_pad``, one pass that adds the
residual, applies the ELU and reflect-pads (the kernel of
``csrc/elu_pad.cu`` on a CUDA tensor), and a residual block hands its
two terms on unsummed, for the next conv's ``elu_pad`` to add. A 1x1 conv
reads its input as it is. The numpy initialisers make the same
draws, in the same order, as the JAX package's, so ``weights="random"``
gives both packages bit-identical parameters.

The encoder also runs Mimi's SEANet (``nn/mimi.py``): 64 filters, no LSTM
(``lstm_layers=0``), an identity shortcut (``use_conv_shortcut=False``)
and zero padding (``pad_mode="constant"``). K1 computes EnCodec's front
alone, so there every conv, conv_in and the first residual block too,
takes its input from ``elu_pad``.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv_transpose1d, pad_amounts
from ..ops.elu_pad import elu_pad
from ..ops.lstm import lstm_skip
from ..ops.seanet_front import seanet_front


@dataclass(frozen=True)
class SeanetConfig:
    channels: int = 1
    dimension: int = 128
    num_filters: int = 32
    num_residual_layers: int = 1
    ratios: Tuple[int, ...] = (8, 5, 4, 2)  # decoder order; encoder reversed
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    compress: int = 2
    lstm_layers: int = 2  # 0: none
    causal: bool = True
    pad_mode: str = "reflect"  # or "constant": zeros
    trim_right_ratio: float = 1.0  # decoder: share of a transposed conv's trim on the right
    use_conv_shortcut: bool = True

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class SConv1d(nn.Module):
    """EnCodec causal conv; weight [C_out, C_in, K] (weight norm folded).

    ``m(x, residual=r, elu=True)`` convolves ``ELU(x + r)`` under the
    causal padding (reflect, or zeros under ``pad_mode="constant"``); the
    residual and the ELU are optional."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, pad_mode: str = "reflect"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel_size), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.stride, self.dilation, self.pad_mode = stride, dilation, pad_mode

    def pads(self, length: int) -> Tuple[int, int]:
        """(left, right) padding of an input of ``length`` samples."""
        return pad_amounts(length, self.weight.shape[-1], self.stride, self.dilation, causal=True)

    def forward(self, x: torch.Tensor, residual=None, elu: bool = False) -> torch.Tensor:
        left, right = self.pads(x.shape[-1])
        if residual is not None or elu or left or right:
            x = elu_pad(x, left, right, residual=residual, elu=elu, pad_mode=self.pad_mode)
        return self.conv(x)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """This conv of an input padded already."""
        return F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=self.stride,
                        dilation=self.dilation)


class ResnetBlock(nn.Module):
    """ELU -> conv(k, dilation) -> ELU -> conv(1), plus a 1x1 conv shortcut
    (the identity where ``use_conv_shortcut`` is false).

    Takes its input as two terms, x + residual, and returns its own two,
    shortcut and conv2's, unsummed: the consumer's ``elu_pad`` adds them."""

    def __init__(self, cfg: SeanetConfig, dim: int, dilation: int):
        super().__init__()
        hidden = dim // cfg.compress
        self.conv1 = SConv1d(dim, hidden, cfg.residual_kernel_size, dilation=dilation,
                             pad_mode=cfg.pad_mode)
        self.conv2 = SConv1d(hidden, dim, 1, pad_mode=cfg.pad_mode)
        self.shortcut = SConv1d(dim, dim, 1) if cfg.use_conv_shortcut else None

    def forward(self, x: torch.Tensor, residual=None):
        # x + residual is written out only where the shortcut needs it: a
        # sum, or a strided view (a transposed conv's trimmed output).
        # conv1 goes first, so that its padded input is freed before the
        # shortcut's output is allocated.
        h, x = elu_pad(x, *self.conv1.pads(x.shape[-1]), residual=residual, keep_input=True,
                       pad_mode=self.conv1.pad_mode)
        h = self.conv1.conv(h)
        return x if self.shortcut is None else self.shortcut(x), self.conv2(h, elu=True)


class EncoderStage(nn.Module):
    def __init__(self, cfg: SeanetConfig, dim: int, ratio: int):
        super().__init__()
        self.res = nn.ModuleList(
            ResnetBlock(cfg, dim, cfg.dilation_growth_rate**j)
            for j in range(cfg.num_residual_layers)
        )
        self.down = SConv1d(dim, 2 * dim, 2 * ratio, stride=ratio, pad_mode=cfg.pad_mode)


class LSTMLayer(nn.Module):
    """Torch-layout LSTM weights: wih [4H, in], whh [4H, H], bih, bhh [4H]."""

    def __init__(self, dim: int):
        super().__init__()
        for name, shape in (("wih", (4 * dim, dim)), ("whh", (4 * dim, dim)),
                            ("bih", (4 * dim,)), ("bhh", (4 * dim,))):
            setattr(self, name, nn.Parameter(torch.zeros(shape), requires_grad=False))


class SeanetEncoder(nn.Module):
    """Waveform [B, T] -> latents [B, ceil(T / hop), dimension].

    The front is kernel K1 where the configuration's front is the one K1
    computes (EnCodec's: one channel in, 32 filters, k7 conv_in, one k3
    residual block with a conv shortcut, reflect padding); any other front
    (Mimi's) runs conv_in and the first stage as the later stages run. The
    convs are causal; another configuration is refused.
    """

    #: the front kernel K1 computes
    K1_FRONT = (1, 32, 7, 3, 2, 1, True, "reflect")

    def __init__(self, cfg: SeanetConfig = SeanetConfig()):
        super().__init__()
        if not cfg.causal or cfg.pad_mode not in ("reflect", "constant"):
            raise ValueError(f"SeanetEncoder: the port's convs are causal, reflect- or "
                             f"zero-padded (causal {cfg.causal}, pad_mode {cfg.pad_mode!r})")
        front = (cfg.channels, cfg.num_filters, cfg.kernel_size, cfg.residual_kernel_size,
                 cfg.compress, cfg.num_residual_layers, cfg.use_conv_shortcut, cfg.pad_mode)
        self.k1 = front == self.K1_FRONT
        self.cfg = cfg
        self.conv_in = SConv1d(cfg.channels, cfg.num_filters, cfg.kernel_size, pad_mode=cfg.pad_mode)
        stages, dim = [], cfg.num_filters
        for ratio in reversed(cfg.ratios):
            stages.append(EncoderStage(cfg, dim, ratio))
            dim *= 2
        self.stages = nn.ModuleList(stages)
        self.lstm = nn.ModuleList(LSTMLayer(dim) for _ in range(cfg.lstm_layers))
        self.conv_out = SConv1d(dim, cfg.dimension, cfg.last_kernel_size, pad_mode=cfg.pad_mode)

    def front_weights(self):
        """K1's weights: conv_in, then the first residual block's convs."""
        res = self.stages[0].res[0]
        return (self.conv_in.weight, self.conv_in.bias, res.conv1.weight, res.conv1.bias,
                res.conv2.weight, res.conv2.bias, res.shortcut.weight, res.shortcut.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The kernels compute in f32; under a bf16 policy the plain convs
        # run on bf16 operands (SConv1d.conv casts the weights to x's dtype).
        dtype = x.dtype
        if self.k1:
            h = seanet_front(x.float(), *self.front_weights()).to(dtype)  # [B, 32, T]
        else:
            h = self.conv_in(x[:, None, :])
        r = None
        for si, stage in enumerate(self.stages):
            if si > 0 or not self.k1:
                for res in stage.res:
                    h, r = res(h, r)
            h, r = stage.down(h, residual=r, elu=True), None
        if len(self.lstm):
            layers = [(l.wih, l.whh, l.bih, l.bhh) for l in self.lstm]
            h = lstm_skip(layers, h.transpose(1, 2).float()).to(dtype).transpose(1, 2)  # [B, C, T']
        h = self.conv_out(h, elu=True)
        return h.transpose(1, 2)  # [B, T', dimension]


class SConvTranspose1d(nn.Module):
    """EnCodec causal transposed conv; weight [C_in, C_out, K]. In SEANet's
    decoder each one follows an ELU: ``up(x, residual=r)`` convolves
    ``ELU(x + r)``, the residual optional."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 trim_right_ratio: float):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, kernel_size), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.stride, self.trim_right_ratio = stride, trim_right_ratio

    def forward(self, x: torch.Tensor, residual=None) -> torch.Tensor:
        x = elu_pad(x, 0, 0, residual=residual)
        return conv_transpose1d(x, self.weight, self.bias, self.stride, self.trim_right_ratio)


class DecoderStage(nn.Module):
    def __init__(self, cfg: SeanetConfig, dim: int, ratio: int):
        super().__init__()
        self.up = SConvTranspose1d(dim, dim // 2, 2 * ratio, ratio, cfg.trim_right_ratio)
        self.res = nn.ModuleList(
            ResnetBlock(cfg, dim // 2, cfg.dilation_growth_rate**j)
            for j in range(cfg.num_residual_layers)
        )


class SeanetDecoder(nn.Module):
    """Latents [B, T', dimension] -> waveform [B, T' * hop].

    conv_in, the LSTM with skip (kernel K2 on a CUDA tensor), then per
    ratio ELU -> transposed conv (stride r, kernel 2r) -> residual blocks,
    and ELU -> conv_out. Activations stay [B, C, T] and are transposed
    around the LSTM, as in the encoder."""

    def __init__(self, cfg: SeanetConfig = SeanetConfig()):
        super().__init__()
        if not cfg.causal or cfg.pad_mode != "reflect" or not cfg.use_conv_shortcut:
            raise ValueError("SeanetDecoder: the port's convs are causal, reflect-padded, "
                             "with a conv shortcut")
        self.cfg = cfg
        dim = 2 ** len(cfg.ratios) * cfg.num_filters
        self.conv_in = SConv1d(cfg.dimension, dim, cfg.kernel_size)
        self.lstm = nn.ModuleList(LSTMLayer(dim) for _ in range(cfg.lstm_layers))
        stages = []
        for ratio in cfg.ratios:
            stages.append(DecoderStage(cfg, dim, ratio))
            dim //= 2
        self.stages = nn.ModuleList(stages)
        self.conv_out = SConv1d(cfg.num_filters, cfg.channels, cfg.last_kernel_size)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        # K2 computes in f32; under a bf16 policy the plain convs run in bf16
        dtype = z.dtype
        h = self.conv_in(z.transpose(1, 2))  # [B, 512, T']
        layers = [(l.wih, l.whh, l.bih, l.bhh) for l in self.lstm]
        h = lstm_skip(layers, h.transpose(1, 2).float()).to(dtype).transpose(1, 2)
        r = None
        for stage in self.stages:
            h, r = stage.up(h, residual=r), None
            for res in stage.res:
                h, r = res(h, r)
        return self.conv_out(h, residual=r, elu=True)[:, 0, :]  # [B, T' * hop]


# ---------------------------------------------------------------------------
# Random init, numpy only: the JAX package's draws, in its order.
# ---------------------------------------------------------------------------


def _conv_init(rng, k, cin, cout):
    std = float(np.sqrt(2.0 / (k * cin)))
    return {
        "kernel": (rng.standard_normal((k, cin, cout)) * std).astype(np.float32),
        "bias": np.zeros((cout,), np.float32),
    }


def _convt_init(rng, k, cin, cout):
    std = float(np.sqrt(2.0 / (k * cin)))
    return {
        # conv_transpose kernel layout [K, C_out, C_in]
        "kernel": (rng.standard_normal((k, cout, cin)) * std).astype(np.float32),
        "bias": np.zeros((cout,), np.float32),
    }


def _lstm_init(rng, dim, layers):
    std = float(1.0 / np.sqrt(dim))
    return {
        "layers": [
            {
                "wih": rng.uniform(-std, std, (4 * dim, dim)).astype(np.float32),
                "whh": rng.uniform(-std, std, (4 * dim, dim)).astype(np.float32),
                "bih": np.zeros((4 * dim,), np.float32),
                "bhh": np.zeros((4 * dim,), np.float32),
            }
            for _ in range(layers)
        ]
    }


def _res_init(rng, cfg: SeanetConfig, dim):
    hidden = dim // cfg.compress
    p = {
        "conv1": _conv_init(rng, cfg.residual_kernel_size, dim, hidden),
        "conv2": _conv_init(rng, 1, hidden, dim),
    }
    if cfg.use_conv_shortcut:
        p["shortcut"] = _conv_init(rng, 1, dim, dim)
    return p


def init_encoder_params(rng, cfg: SeanetConfig):
    """JAX-layout encoder parameter tree (conv kernels [K, C_in, C_out])."""
    mult = 1
    p = {"conv_in": _conv_init(rng, cfg.kernel_size, cfg.channels, cfg.num_filters)}
    stages = []
    for ratio in reversed(cfg.ratios):
        ch = mult * cfg.num_filters
        stages.append(
            {
                "res": [_res_init(rng, cfg, ch) for _ in range(cfg.num_residual_layers)],
                "down": _conv_init(rng, ratio * 2, ch, ch * 2),
            }
        )
        mult *= 2
    p["stages"] = stages
    p["lstm"] = _lstm_init(rng, mult * cfg.num_filters, cfg.lstm_layers)
    p["conv_out"] = _conv_init(rng, cfg.last_kernel_size, mult * cfg.num_filters, cfg.dimension)
    return p


def init_decoder_params(rng, cfg: SeanetConfig):
    """JAX-layout decoder parameter tree. The acoustic encoder draws it too,
    so that the codebooks drawn after it match the JAX package's."""
    mult = 2 ** len(cfg.ratios)
    p = {"conv_in": _conv_init(rng, cfg.kernel_size, cfg.dimension, mult * cfg.num_filters)}
    p["lstm"] = _lstm_init(rng, mult * cfg.num_filters, cfg.lstm_layers)
    stages = []
    for ratio in cfg.ratios:
        ch = mult * cfg.num_filters
        stages.append(
            {
                "up": _convt_init(rng, ratio * 2, ch, ch // 2),
                "res": [_res_init(rng, cfg, ch // 2) for _ in range(cfg.num_residual_layers)],
            }
        )
        mult //= 2
    p["stages"] = stages
    p["conv_out"] = _conv_init(rng, cfg.last_kernel_size, cfg.num_filters, cfg.channels)
    return p
