"""HuBERT speech encoder (mHuBERT-base), the semantic_s embedder.

Counterpart of ``audiotoken_tpu/nn/hubert.py``: a 7-layer conv feature
extractor (strides 5, 2, 2, 2, 2, 2, 2: 320x down, 50 frames per second
at 16 kHz; GroupNorm(512, 512) over time after the first conv, exact
GELU), LayerNorm + projection 512 -> 768, the grouped positional conv
(kernel 128, 16 groups, padded 64 on both sides, last frame dropped,
GELU), LayerNorm, then post-LN transformer layers. Only ``output_layer``
layers are built and run.

Masking as in HF's HubertModel: frame lengths from the conv length
formula, padded frames zeroed before the positional conv, an additive
bias of the most negative f32 on padded keys.

The convs are cuDNN's ``F.conv1d`` and the linears cuBLAS matmuls.
Attention is ``attn_impl``: ``"flash"`` launches kernel K4 in its no-rel
form (``ops/flash_attention.py``; its plain version for CPU tensors),
``"xla"`` is the plain materialised-scores attention
(``ops/attention.py:multihead_attention``). The JAX package's first conv
as a framing matmul (``_conv0_framed``) is a TPU lane-padding measure and
is not carried over: the goldens hold with ``F.conv1d``. The numpy
initialiser makes the same draws, in the same order, as the JAX package's.

HuBERT has one precision (no stage map): the caller's policy sets the TF32
switches for the whole forward, and its ``matmul_precision`` goes down the
forward to K4 (3xTF32 at ``highest``, one TF32 pass otherwise). bf16
input (the ``bfloat16`` policy) runs the first conv on bf16 operands with
f32 accumulation and a bf16 output, and its GroupNorm statistics in bf16,
as the JAX package computes them; everything from that norm's affine on
is f32.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multihead_attention, padding_bias
from ..ops.flash_attention import flash_attention_relkey
from ..runtime.precision import bf16_norm, tf32_numerics


@dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    # "flash": K4, no [B, H, T, T] scores in device memory; "xla": plain
    # attention over materialised scores
    attn_impl: str = "flash"


def feature_lengths(n_samples, cfg: HubertConfig):
    """Conv-extractor output length of ``n_samples`` (an int or an integer
    tensor; HF's ``_get_feat_extract_output_lengths``)."""
    n = n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n


class ConvExtractor(nn.Module):
    """[B, N] waveform -> [B, T', 512]: valid strided convs, GroupNorm after
    the first, exact GELU after each."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        cins = (1,) + tuple(cfg.conv_dim[:-1])
        self.convs = nn.ModuleList(
            nn.Conv1d(cin, cout, k, stride=s, bias=cfg.conv_bias)
            for cin, cout, k, s in zip(cins, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)
        )
        self.group_norm = nn.GroupNorm(cfg.conv_dim[0], cfg.conv_dim[0], eps=1e-5)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, N] f32, or bf16 for the bf16 form of the first conv and norm
        -> [B, T', 512] f32."""
        h = audio[:, None, :]
        for i, conv in enumerate(self.convs):
            if i == 0 and h.dtype == torch.bfloat16:
                # bf16 operands, f32 accumulation, bf16 output: the products
                # of bf16 values are exact in f32, so IEEE f32 on the
                # rounded operands is that conv on any device
                with tf32_numerics(False):
                    h = F.conv1d(h.float(), conv.weight.bfloat16().float(),
                                 stride=conv.stride).bfloat16()
                if conv.bias is not None:
                    h = h + conv.bias.bfloat16()
                gn = self.group_norm
                h = bf16_norm(h, -1, gn.eps) * gn.weight[:, None] + gn.bias[:, None]
            else:
                h = conv(h)
                if i == 0:
                    h = self.group_norm(h)  # each channel over time
            h = F.gelu(h)
        return h.transpose(1, 2)


class PositionalConv(nn.Module):
    """Grouped conv positional embedding: pad K/2 on both sides, drop the
    last output frame (even kernel), exact GELU."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        H, K = cfg.hidden_size, cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(H, H, K, padding=K // 2, groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x.transpose(1, 2))
        if self.conv.kernel_size[0] % 2 == 0:
            h = h[:, :, :-1]
        return F.gelu(h).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        H = cfg.hidden_size
        self.cfg = cfg
        self.q = nn.Linear(H, H)
        self.k = nn.Linear(H, H)
        self.v = nn.Linear(H, H)
        self.out = nn.Linear(H, H)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                frame_mask: Optional[torch.Tensor], precision: str = "highest") -> torch.Tensor:
        B, T, H = x.shape
        nh = self.cfg.num_attention_heads

        def heads(t):  # [B, T, H] -> [B, nh, T, dh], contiguous for K4
            return t.reshape(B, T, nh, H // nh).transpose(1, 2).contiguous()

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        if self.cfg.attn_impl == "flash":
            a = flash_attention_relkey(q, k, v, None, frame_mask, precision=precision)
        else:
            a = multihead_attention(q, k, v, bias)
        return self.out(a.transpose(1, 2).reshape(B, T, H))


class EncoderLayer(nn.Module):
    """Post-LN block: LN(x + attn(x)), then LN(x + ffn(x))."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attn = Attention(cfg)
        self.layer_norm = nn.LayerNorm(H, eps=eps)
        self.ffn_in = nn.Linear(H, cfg.intermediate_size)
        self.ffn_out = nn.Linear(cfg.intermediate_size, H)
        self.final_layer_norm = nn.LayerNorm(H, eps=eps)

    def forward(self, x, bias, frame_mask, precision="highest"):
        x = self.layer_norm(x + self.attn(x, bias, frame_mask, precision))
        return self.final_layer_norm(x + self.ffn_out(F.gelu(self.ffn_in(x))))


class HubertFeatures(nn.Module):
    """[B, N] waveform (+ sample mask [B, N]) -> hidden_states[output_layer]
    [B, T', hidden]; holds and runs exactly ``output_layer`` layers."""

    def __init__(self, cfg: HubertConfig = HubertConfig(), output_layer: int = 11):
        super().__init__()
        if cfg.attn_impl not in ("xla", "flash"):
            raise ValueError(f"attn_impl must be 'xla' or 'flash', got {cfg.attn_impl!r}")
        if not 1 <= output_layer <= cfg.num_hidden_layers:
            raise ValueError(f"output_layer {output_layer} outside 1..{cfg.num_hidden_layers}")
        self.cfg = cfg
        self.extractor = ConvExtractor(cfg)
        self.fp_layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)
        self.pos_conv = PositionalConv(cfg)
        self.encoder_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(output_layer))

    def forward(self, audio: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                precision: str = "highest") -> torch.Tensor:
        """``precision``: the policy's ``matmul_precision`` (a key of
        ``runtime/precision.py:TF32``), K4's precision on the "flash" route."""
        feats = self.extractor(audio)
        frame_mask = bias = None
        if attention_mask is not None:
            lengths = feature_lengths(attention_mask.sum(dim=-1).long(), self.cfg)
            T = feats.shape[1]
            frame_mask = (torch.arange(T, device=feats.device)[None, :]
                          < lengths[:, None]).float()
            bias = padding_bias(frame_mask)
        h = self.projection(self.fp_layer_norm(feats))
        if frame_mask is not None:
            h = h * frame_mask[:, :, None]
        h = self.encoder_layer_norm(h + self.pos_conv(h))
        for layer in self.layers:
            h = layer(h, bias, frame_mask, precision)
        return h


# ---------------------------------------------------------------------------
# Random init (numpy, JAX layout: conv kernels [K, C_in, C_out], linear
# kernels [in, out], the grouped positional kernel [K, H / groups, H])
# ---------------------------------------------------------------------------


def _lin_init(rng, din, dout, bias=True):
    std = float(np.sqrt(1.0 / din))
    p = {"kernel": rng.uniform(-std, std, (din, dout)).astype(np.float32)}
    p["bias"] = np.zeros((dout,), np.float32) if bias else None
    return p


def _ln_init(d):
    return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}


def init_hubert_params(rng, cfg: HubertConfig = HubertConfig()):
    """The JAX package's ``init_hubert_params`` tree, drawn in its order."""
    convs = []
    cin = 1
    for k, cout in zip(cfg.conv_kernel, cfg.conv_dim):
        std = float(np.sqrt(2.0 / (k * cin)))
        convs.append({
            "kernel": (rng.standard_normal((k, cin, cout)) * std).astype(np.float32),
            "bias": np.zeros((cout,), np.float32) if cfg.conv_bias else None,
        })
        cin = cout
    H = cfg.hidden_size
    K, G = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    params = {
        "feature_extractor": {"convs": convs, "group_norm": _ln_init(cfg.conv_dim[0])},
        "feature_projection": {
            "layer_norm": _ln_init(cfg.conv_dim[-1]),
            "projection": _lin_init(rng, cfg.conv_dim[-1], H),
        },
        "pos_conv": {
            "kernel": (rng.standard_normal((K, H // G, H)) * 0.02).astype(np.float32),
            "bias": np.zeros((H,), np.float32),
        },
        "encoder_layer_norm": _ln_init(H),
        "layers": [],
    }
    for _ in range(cfg.num_hidden_layers):
        params["layers"].append({
            "attn": {name: _lin_init(rng, H, H) for name in ("q", "k", "v", "out")},
            "layer_norm": _ln_init(H),
            "ffn": {
                "in": _lin_init(rng, H, cfg.intermediate_size),
                "out": _lin_init(rng, cfg.intermediate_size, H),
            },
            "final_layer_norm": _ln_init(H),
        })
    return params
