"""wav2vec2-BERT 2.0 conformer encoder (trimmed 21-layer variant).

Counterpart of ``audiotoken_tpu/nn/conformer.py``: 160-dim stacked-fbank
input, feature projection 160 -> 1024, then conformer blocks (half-step
FFN, self-attention with the relative_key bias of left 64 / right 8,
causal depthwise conv of kernel 31, half-step FFN, final LayerNorm). Only
``output_layer`` blocks are built and run.

The linears are ``ops/linear.py:Linear``: on the card at a stage whose
TF32 switch is off (``highest``) the 3xTF32 GEMM ``linear_3xtf32``, under
TF32 cuBLAS, on the CPU ``F.linear``. The depthwise conv is ``F.conv1d``
with ``groups=H``; attention is kernel K4 (``ops/flash_attention.py``),
whose plain version runs for CPU tensors. The numpy initialiser makes the same
draws, in the same order, as the JAX package's, so ``weights="random"``
gives both packages bit-identical parameters.

The forward takes a precision: a policy name or a per-stage map
(``runtime/precision.py:StagePrecision``), passed down explicitly as the
JAX package passes ``P``. Each stage's products run under that stage's
TF32 switches, and K4 at the ``attn_kernel`` stage's precision (3xTF32 at
``highest``, one TF32 pass otherwise); the depthwise conv runs in IEEE f32
under every setting, as the JAX package's shift-sum has no precision to
lower. bf16 input (the ``bfloat16`` policy) takes the feature projection's
LayerNorm in bf16, as the JAX package computes it, and is f32 from that
norm's affine on.

With ``tp`` (a ``parallel.mesh.Axis`` of more than one rank) the model is
this rank's tensor-parallel shard under ``parallel/shard.py:
conformer_param_spec``: its heads of q, k and v (K4 runs on them, with the
whole distance embedding) and the matching rows of the attention's
out-projection, a column block of each ffn's input and rows of its
output, and a block of the conv module's channels (``pw1`` holding both
GLU halves of them, the depthwise kernel, the rows of ``pw2``). Each
row-parallel product is all-reduced over tp before its bias; the channel
LayerNorm after the depthwise conv takes its mean and variance over every
channel, from sums all-reduced over tp. Activations between the modules
are whole on every rank.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention_relkey
from ..ops.linear import Linear
from ..parallel.collectives import all_reduce, row_linear
from ..parallel.mesh import Axis, single_axis
from ..runtime.precision import as_stage_precision, bf16_norm, tf32_numerics


@dataclass(frozen=True)
class W2VBertConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 21  # trimmed checkpoint
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    conv_depthwise_kernel_size: int = 31
    layer_norm_eps: float = 1e-5

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_positions(self) -> int:
        return self.left_max_position_embeddings + self.right_max_position_embeddings + 1


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------



def _row(lin: nn.Linear, x: torch.Tensor, tp: Axis) -> torch.Tensor:
    """``lin`` as a row-parallel linear over tp; on one rank the module's
    own call (its hooks see it, as the stage-precision tests need)."""
    return lin(x) if tp.size == 1 else row_linear(x, lin.weight, lin.bias, tp)


class FeedForward(nn.Module):
    def __init__(self, cfg: W2VBertConfig, tp: Axis = single_axis("tp")):
        super().__init__()
        self.tp = tp
        self.inp = Linear(cfg.hidden_size, cfg.intermediate_size // tp.size)
        self.out = Linear(cfg.intermediate_size // tp.size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, P) -> torch.Tensor:
        with P.numerics("ffn_in"):
            h = F.silu(self.inp(x))
        with P.numerics("ffn_out"):
            return _row(self.out, h, self.tp)


class RelKeyAttention(nn.Module):
    """Self-attention with the relative_key position bias."""

    def __init__(self, cfg: W2VBertConfig, tp: Axis = single_axis("tp")):
        super().__init__()
        H, Hl = cfg.hidden_size, cfg.hidden_size // tp.size
        self.cfg, self.tp = cfg, tp
        self.q = Linear(H, Hl)
        self.k = Linear(H, Hl)
        self.v = Linear(H, Hl)
        self.out = Linear(Hl, H)
        self.distance_embedding = nn.Parameter(torch.zeros(cfg.num_positions, cfg.head_size))

    def forward(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor], P) -> torch.Tensor:
        B, T, _ = x.shape
        nh, dh = self.cfg.num_attention_heads // self.tp.size, self.cfg.head_size

        def heads(t):  # [B, T, nh*dh] -> [B, nh, T, dh], contiguous for K4
            return t.reshape(B, T, nh, dh).transpose(1, 2).contiguous()

        with P.numerics("attn_qkv"):
            q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        a = flash_attention_relkey(
            q, k, v, self.distance_embedding, frame_mask,
            left=self.cfg.left_max_position_embeddings,
            right=self.cfg.right_max_position_embeddings,
            precision=P("attn_kernel"),
        )
        with P.numerics("attn_out"):
            return _row(self.out, a.transpose(1, 2).reshape(B, T, nh * dh), self.tp)


class ConvModule(nn.Module):
    """LN -> mask-zero -> pointwise(2H) -> GLU -> causal depthwise(K) ->
    LN -> swish -> pointwise(H)."""

    def __init__(self, cfg: W2VBertConfig, tp: Axis = single_axis("tp")):
        super().__init__()
        H, K = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        Hl = H // tp.size  # this rank's channels
        self.tp = tp
        self.layer_norm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.pw1 = Linear(H, 2 * Hl, bias=False)  # [a | b] of the GLU, each Hl wide
        self.dw_weight = nn.Parameter(torch.zeros(Hl, 1, K))  # [Hl, 1, K], F.conv1d layout
        self.dw_layer_norm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.pw2 = Linear(Hl, H, bias=False)

    def _dw_norm(self, h: torch.Tensor) -> torch.Tensor:
        """The channel LayerNorm after the depthwise conv; under tp over
        this rank's channels with every channel's mean and variance."""
        ln, tp = self.dw_layer_norm, self.tp
        if tp.size == 1:
            return ln(h)
        H, Hl = ln.weight.shape[0], h.shape[-1]
        mu = all_reduce(h.sum(-1, keepdim=True), tp) / H
        var = all_reduce((h - mu).square().sum(-1, keepdim=True), tp) / H
        mine = slice(tp.index * Hl, (tp.index + 1) * Hl)
        return (h - mu) * torch.rsqrt(var + ln.eps) * ln.weight[mine] + ln.bias[mine]

    def forward(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor], P) -> torch.Tensor:
        h = self.layer_norm(x)
        if frame_mask is not None:
            h = h * frame_mask[:, :, None]
        with P.numerics("conv"):
            h = F.glu(self.pw1(h), dim=-1)
        K = self.dw_weight.shape[-1]
        with tf32_numerics(False):  # the JAX shift-sum's exact f32, under every setting
            h = F.conv1d(F.pad(h.transpose(1, 2), (K - 1, 0)), self.dw_weight,
                         groups=h.shape[-1]).transpose(1, 2)
        h = F.silu(self._dw_norm(h))
        with P.numerics("conv"):
            return _row(self.pw2, h, self.tp)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: W2VBertConfig, tp: Axis = single_axis("tp")):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ffn1_layer_norm = nn.LayerNorm(H, eps=eps)
        self.ffn1 = FeedForward(cfg, tp)
        self.self_attn_layer_norm = nn.LayerNorm(H, eps=eps)
        self.attn = RelKeyAttention(cfg, tp)
        self.conv = ConvModule(cfg, tp)
        self.ffn2_layer_norm = nn.LayerNorm(H, eps=eps)
        self.ffn2 = FeedForward(cfg, tp)
        self.final_layer_norm = nn.LayerNorm(H, eps=eps)

    def forward(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor], P) -> torch.Tensor:
        x = self.ffn1(self.ffn1_layer_norm(x), P) * 0.5 + x
        x = self.attn(self.self_attn_layer_norm(x), frame_mask, P) + x
        x = x + self.conv(x, frame_mask, P)
        x = self.ffn2(self.ffn2_layer_norm(x), P) * 0.5 + x
        return self.final_layer_norm(x)



class W2VBertFeatures(nn.Module):
    """[B, T, 160] fbank (+ frame mask [B, T]) -> hidden_states[output_layer]
    [B, T, hidden]; holds and runs exactly ``output_layer`` blocks. With
    ``tp``, this rank's tensor-parallel shard; the output is whole."""

    def __init__(self, cfg: W2VBertConfig = W2VBertConfig(), output_layer: int = 19,
                 tp: Optional[Axis] = None):
        super().__init__()
        if not 1 <= output_layer <= cfg.num_hidden_layers:
            raise ValueError(f"output_layer {output_layer} outside 1..{cfg.num_hidden_layers}")
        tp = tp or single_axis("tp")
        if cfg.num_attention_heads % tp.size or cfg.intermediate_size % tp.size:
            raise ValueError(f"tp = {tp.size} must divide the {cfg.num_attention_heads} heads "
                             f"and the {cfg.intermediate_size} ffn channels")
        self.cfg = cfg
        self.fp_layer_norm = nn.LayerNorm(cfg.feature_projection_input_dim, eps=cfg.layer_norm_eps)
        self.projection = Linear(cfg.feature_projection_input_dim, cfg.hidden_size)
        self.layers = nn.ModuleList(ConformerBlock(cfg, tp) for _ in range(output_layer))

    def forward(self, input_features: torch.Tensor,
                attention_mask: Optional[torch.Tensor], precision="highest") -> torch.Tensor:
        """``precision``: a policy name or a ``StagePrecision``. bf16
        ``input_features`` take the feature projection's LayerNorm in bf16."""
        P = as_stage_precision(precision)
        ln = self.fp_layer_norm
        if input_features.dtype == torch.bfloat16:
            h = bf16_norm(input_features, -1, ln.eps) * ln.weight + ln.bias
        else:
            h = ln(input_features)
        with P.numerics("proj"):
            h = self.projection(h)
        frame_mask = None
        if attention_mask is not None:
            frame_mask = attention_mask.float().contiguous()
            h = h * frame_mask[:, :, None]
        for layer in self.layers:
            h = layer(h, frame_mask, P)
        return h


# ---------------------------------------------------------------------------
# Random init (numpy, JAX layout: linear kernels [in, out], dw_kernel [K, 1, H])
# ---------------------------------------------------------------------------


def _lin_init(rng, din, dout, bias=True):
    std = float(np.sqrt(1.0 / din))
    p = {"kernel": rng.uniform(-std, std, (din, dout)).astype(np.float32)}
    p["bias"] = np.zeros((dout,), np.float32) if bias else None
    return p


def _ln_init(d):
    return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}


def init_w2vbert_params(rng, cfg: W2VBertConfig = W2VBertConfig()):
    """The JAX package's ``init_w2vbert_params`` tree, drawn in its order."""
    H = cfg.hidden_size
    params = {
        "feature_projection": {
            "layer_norm": _ln_init(cfg.feature_projection_input_dim),
            "projection": _lin_init(rng, cfg.feature_projection_input_dim, H),
        },
        "layers": [],
    }
    for _ in range(cfg.num_hidden_layers):
        params["layers"].append(
            {
                "ffn1_layer_norm": _ln_init(H),
                "ffn1": {
                    "in": _lin_init(rng, H, cfg.intermediate_size),
                    "out": _lin_init(rng, cfg.intermediate_size, H),
                },
                "self_attn_layer_norm": _ln_init(H),
                "attn": {
                    "q": _lin_init(rng, H, H),
                    "k": _lin_init(rng, H, H),
                    "v": _lin_init(rng, H, H),
                    "out": _lin_init(rng, H, H),
                    "distance_embedding": (
                        rng.standard_normal((cfg.num_positions, cfg.head_size)) * 0.02
                    ).astype(np.float32),
                },
                "conv": {
                    "layer_norm": _ln_init(H),
                    "pw1": _lin_init(rng, H, 2 * H, bias=False),
                    "dw_kernel": (
                        rng.standard_normal((cfg.conv_depthwise_kernel_size, 1, H)) * 0.02
                    ).astype(np.float32),
                    "dw_layer_norm": _ln_init(H),
                    "pw2": _lin_init(rng, H, H, bias=False),
                },
                "ffn2_layer_norm": _ln_init(H),
                "ffn2": {
                    "in": _lin_init(rng, H, cfg.intermediate_size),
                    "out": _lin_init(rng, cfg.intermediate_size, H),
                },
                "final_layer_norm": _ln_init(H),
            }
        )
    return params
