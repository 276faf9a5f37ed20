"""Plain multi-head attention over materialised scores, and the additive
key-padding bias shared by the attention paths.

Counterpart of ``audiotoken_tpu/ops/attention.py``.
"""

from typing import Optional

import torch


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v [B, H, T, dh]; ``bias`` broadcastable to [B, H, T, T] (added
    after the scale) -> [B, H, T, dh]: ``softmax(q k^T * scale + bias) v``
    with the softmax in f32, ``scale`` dh^-0.5 by default. The scale and
    the bias are applied in place: one [B, H, T, T] buffer fewer."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.matmul(q, k.transpose(-1, -2)).mul_(scale)
    if bias is not None:
        scores.add_(bias)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def padding_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, T] {0, 1} -> additive bias [B, 1, 1, T] f32: 0 where a key is
    kept, the most negative finite f32 where it is dropped."""
    neg = torch.finfo(torch.float32).min
    return ((1.0 - attention_mask.float()) * neg)[:, None, None, :]
