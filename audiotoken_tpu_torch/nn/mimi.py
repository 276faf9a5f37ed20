"""Mimi's encode side (Kyutai, kyutai/mimi; Defossez et al., arXiv:2410.00037)
as PyTorch modules: SEANet of 64 filters (``nn/seanet.py``, no LSTM, an
identity shortcut, zero padding), an 8-layer transformer with a causal
window of 250 frames, a downsample to 12.5 Hz and a split residual VQ.

A row of f32 audio at 24 kHz -> SEANet latents [B, T, 512] at 25 Hz ->
``num_hidden_layers`` transformer layers, each

    h += ls1 * o(Attn(LN1(h)))      (RoPE, 8 heads of 64, scale 1/8,
                                     key j visible to query i iff
                                     i - window < j <= i)
    h += ls2 * W2 GELU(W1 LN2(h))   (exact GELU, no biases)

-> a conv of kernel 4 and stride 2, no bias, replicate-padded on the left
(12.5 Hz) -> two 1x1 projections to 256: codebook 0 quantizes the first
(semantic), codebooks 1.. the second as a residual chain (acoustic).

No counterpart in the JAX package. The attention is
``ops/flash_attention.py:flash_attention_window`` (a kernel on a CUDA
tensor, its twin on the CPU) and the quantizer K3 (``ops/rvq.py``) at
D = 256; the linears and the downsample are plain PyTorch (IEEE SGEMM and
cuDNN under ``highest``).

transformers' ``MimiModel`` masks with ``create_causal_mask``, so its eager
and SDPA paths attend to every earlier frame and only its flash-attention
path passes ``sliding_window``; the published model (its config's
``sliding_window`` and Kyutai's ``context``) bounds attention to 250
frames, which this module follows. The two agree up to 250 frames (10 s).
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention_window
from ..ops.rvq import rvq_encode
from .seanet import SeanetConfig, SeanetEncoder, init_encoder_params


@dataclass(frozen=True)
class MimiConfig:
    """kyutai/mimi's published config (transformers' ``MimiConfig``
    defaults), encode side."""

    channels: int = 1
    hidden_size: int = 512
    num_filters: int = 64
    ratios: Tuple[int, ...] = (8, 6, 5, 4)  # decoder order; encoder reversed
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    compress: int = 2
    num_residual_layers: int = 1
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    rope_theta: float = 10_000.0
    sliding_window: int = 250
    norm_eps: float = 1e-5
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    downsample_stride: int = 2

    @property
    def seanet(self) -> SeanetConfig:
        return SeanetConfig(
            channels=self.channels, dimension=self.hidden_size, num_filters=self.num_filters,
            num_residual_layers=self.num_residual_layers, ratios=self.ratios,
            kernel_size=self.kernel_size, last_kernel_size=self.last_kernel_size,
            residual_kernel_size=self.residual_kernel_size,
            dilation_growth_rate=self.dilation_growth_rate, compress=self.compress,
            lstm_layers=0, pad_mode="constant", use_conv_shortcut=False)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def hop_length(self) -> int:
        """Samples a code frame: SEANet's hop times the downsample's stride.
        Every causal conv gives ceil(L / stride) frames, so a row of N
        samples gives ceil(N / hop_length) codes (transformers'
        ``get_encoded_length``)."""
        return int(np.prod(self.ratios)) * self.downsample_stride


def rope_tables(T: int, head_dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [T, head_dim] f32 at positions 0..T-1, as transformers builds
    them: inverse frequencies ``1 / theta^(2i / d)``, angles position x
    frequency (one rounding), the halves repeated."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.int64, device=device)
                           .float() / head_dim))
    ang = torch.arange(T, device=device).float()[:, None] * inv[None, :]
    emb = torch.cat((ang, ang), dim=-1)
    return emb.cos(), emb.sin()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE in the rotate-half form: x cos + [-x2, x1] sin."""
    half = x.shape[-1] // 2
    return x * cos + torch.cat((-x[..., half:], x[..., :half]), dim=-1) * sin


class MimiTransformerLayer(nn.Module):
    """One pre-LN layer: windowed causal self-attention (q, k and v as one
    product, ``in_proj`` [3 D, D]) and a GELU MLP, each scaled by its
    LayerScale vector before the residual add."""

    def __init__(self, cfg: MimiConfig):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.in_proj = nn.Parameter(torch.zeros(3 * D, D), requires_grad=False)
        self.out_proj = nn.Parameter(torch.zeros(D, D), requires_grad=False)
        self.scale1 = nn.Parameter(torch.zeros(D), requires_grad=False)
        self.norm2 = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.fc1 = nn.Parameter(torch.zeros(I, D), requires_grad=False)
        self.fc2 = nn.Parameter(torch.zeros(D, I), requires_grad=False)
        self.scale2 = nn.Parameter(torch.zeros(D), requires_grad=False)
        self.requires_grad_(False)

    def forward(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        B, T, D = h.shape
        H, dh = self.cfg.num_attention_heads, self.cfg.head_dim
        qkv = F.linear(self.norm1(h), self.in_proj).view(B, T, 3, H, dh)
        q, k, v = (t.contiguous() for t in qkv.permute(2, 0, 3, 1, 4))  # [B, H, T, dh]
        a = flash_attention_window(rotate(q, cos, sin), rotate(k, cos, sin), v,
                                   self.cfg.sliding_window)
        h = h + self.scale1 * F.linear(a.transpose(1, 2).reshape(B, T, D), self.out_proj)
        x = F.gelu(F.linear(self.norm2(h), self.fc1))
        return h + self.scale2 * F.linear(x, self.fc2)


class MimiEncode(nn.Module):
    """Waveform [B, N] f32 -> codes [B, num_q, ceil(N / hop_length)] int32.

    Parameters: ``seanet`` (a ``SeanetEncoder``), ``layers.<i>`` (a
    ``MimiTransformerLayer`` each), ``downsample`` [D, D, 2 stride],
    ``semantic_proj`` and ``acoustic_proj`` [codebook_dim, D], and the
    codebooks ``semantic_codebooks`` [num_semantic, C, codebook_dim] and
    ``acoustic_codebooks`` [num_q - num_semantic, C, codebook_dim] as
    buffers."""

    def __init__(self, cfg: MimiConfig = MimiConfig()):
        super().__init__()
        D, S = cfg.hidden_size, cfg.num_semantic_quantizers
        self.cfg = cfg
        self.seanet = SeanetEncoder(cfg.seanet)
        self.layers = nn.ModuleList(MimiTransformerLayer(cfg) for _ in range(cfg.num_hidden_layers))
        k = 2 * cfg.downsample_stride
        self.downsample = nn.Parameter(torch.zeros(D, D, k), requires_grad=False)
        self.semantic_proj = nn.Parameter(torch.zeros(cfg.codebook_dim, D), requires_grad=False)
        self.acoustic_proj = nn.Parameter(torch.zeros(cfg.codebook_dim, D), requires_grad=False)
        cb = (cfg.codebook_size, cfg.codebook_dim)
        self.register_buffer("semantic_codebooks", torch.zeros(S, *cb))
        self.register_buffer("acoustic_codebooks", torch.zeros(cfg.num_quantizers - S, *cb))

    def latents(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [B, N] -> the downsampled latents [B, ceil(N / hop_length), D]."""
        h = self.seanet(wav)  # [B, T, D] at 25 Hz
        cos, sin = rope_tables(h.shape[1], self.cfg.head_dim, self.cfg.rope_theta, h.device)
        for layer in self.layers:
            h = layer(h, cos, sin)
        s = self.cfg.downsample_stride
        x = h.transpose(1, 2)
        extra = -(-x.shape[-1] // s) * s - x.shape[-1]
        x = F.pad(x, (self.downsample.shape[-1] - s, extra), mode="replicate")
        return F.conv1d(x, self.downsample, stride=s).transpose(1, 2)

    def forward(self, wav: torch.Tensor, num_q: int) -> torch.Tensor:
        z = self.latents(wav)
        S = self.semantic_codebooks.shape[0]
        codes = rvq_encode(self.semantic_codebooks, F.linear(z, self.semantic_proj).contiguous(),
                           min(num_q, S))
        if num_q <= S:
            return codes
        a = F.linear(z, self.acoustic_proj).contiguous()
        return torch.cat([codes, rvq_encode(self.acoustic_codebooks, a, num_q - S)], dim=1)


def init_params(rng, cfg: MimiConfig = MimiConfig()) -> dict:
    """A seeded draw of every parameter of :class:`MimiEncode`, numpy, as
    its state dict names them: SEANet as ``nn/seanet.py`` draws EnCodec's
    (He-normal convs, zero biases), LayerNorms at 1 and 0, linears
    N(0, 1 / fan_in), LayerScale at 0.2 (each sub-layer moves the stream),
    the downsample and projections at fan-in scale, codebooks N(0, 1)."""
    from ..weights import acoustic_from_numpy

    seanet, _ = acoustic_from_numpy({"encoder": init_encoder_params(rng, cfg.seanet),
                                     "codebooks": np.zeros(0, np.float32)})
    state = {f"seanet.{k}": v.numpy() for k, v in seanet.items()}
    D, I = cfg.hidden_size, cfg.intermediate_size

    def lin(dout, din):
        return (rng.standard_normal((dout, din)) / math.sqrt(din)).astype(np.float32)

    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        for n in ("norm1", "norm2"):
            state[p + n + ".weight"] = np.ones(D, np.float32)
            state[p + n + ".bias"] = np.zeros(D, np.float32)
        state[p + "in_proj"] = lin(3 * D, D)
        state[p + "out_proj"] = lin(D, D)
        state[p + "fc1"] = lin(I, D)
        state[p + "fc2"] = lin(D, I)
        state[p + "scale1"] = np.full(D, 0.2, np.float32)
        state[p + "scale2"] = np.full(D, 0.2, np.float32)
    k = 2 * cfg.downsample_stride
    state["downsample"] = (rng.standard_normal((D, D, k)) / math.sqrt(D * k)).astype(np.float32)
    state["semantic_proj"] = lin(cfg.codebook_dim, D)
    state["acoustic_proj"] = lin(cfg.codebook_dim, D)
    S, C, dc = cfg.num_semantic_quantizers, cfg.codebook_size, cfg.codebook_dim
    cb = rng.standard_normal((cfg.num_quantizers, C, dc)).astype(np.float32)
    state["semantic_codebooks"], state["acoustic_codebooks"] = cb[:S], cb[S:]
    return state

