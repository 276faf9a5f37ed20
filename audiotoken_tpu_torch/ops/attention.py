"""The additive key-padding bias shared by the attention paths.

Counterpart of ``audiotoken_tpu/ops/attention.py:padding_bias``.
"""

import torch


def padding_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, T] {0, 1} -> additive bias [B, 1, 1, T] f32: 0 where a key is
    kept, the most negative finite f32 where it is dropped."""
    neg = torch.finfo(torch.float32).min
    return ((1.0 - attention_mask.float()) * neg)[:, None, None, :]
