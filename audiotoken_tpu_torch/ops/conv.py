"""1-D causal convolution with EnCodec padding semantics, layout [B, C, T].

Kernels are torch ``Conv1d`` weights [C_out, C_in, K]; weight norm is
folded in at conversion time, so these are plain convolutions.
"""

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def pad_amounts(
    length: int, kernel_size: int, stride: int, dilation: int, causal: bool
) -> Tuple[int, int]:
    """(left, right) padding for an EnCodec conv at a static input length.

    Mirrors EncodecConv1d: padding_total = K_eff - stride, plus
    extra right-padding so the final window lands exactly at the end
    (``_get_extra_padding_for_conv1d``).
    """
    k_eff = (kernel_size - 1) * dilation + 1
    padding_total = k_eff - stride
    n_frames = (length - k_eff + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + k_eff - padding_total
    extra = ideal_length - length
    if causal:
        return padding_total, extra
    right = padding_total // 2
    return padding_total - right, right + extra


def pad1d_reflect(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the time axis of [B, C, T], zero-extending first when the
    signal is not longer than the padding (EncodecConv1d._pad1d)."""
    extra = max(0, max(left, right) - x.shape[-1] + 1)
    if extra:
        x = F.pad(x, (0, extra))
    out = F.pad(x, (left, right), mode="reflect")
    return out[..., : out.shape[-1] - extra] if extra else out


def conv_transpose1d(
    x: torch.Tensor, weight: torch.Tensor, bias, stride: int, trim_right_ratio: float = 1.0
) -> torch.Tensor:
    """EnCodec causal transposed conv of x [B, C_in, T] with weight
    [C_in, C_out, K] (torch ``ConvTranspose1d`` layout), then the causal
    post-trim: of ``K - stride`` extra samples, ``ceil(... * trim_right_ratio)``
    come off the right and the rest off the left."""
    out = F.conv_transpose1d(x, weight.to(x.dtype),
                             None if bias is None else bias.to(x.dtype), stride=stride)
    padding_total = weight.shape[-1] - stride
    pad_right = math.ceil(padding_total * trim_right_ratio)
    pad_left = padding_total - pad_right
    return out[..., pad_left : out.shape[-1] - pad_right]


def conv1d(
    x: torch.Tensor, weight: torch.Tensor, bias, stride: int = 1, dilation: int = 1
) -> torch.Tensor:
    """EnCodec causal conv of x [B, C_in, T] with weight [C_out, C_in, K]:
    reflect padding on the left, plus the extra right padding that lands the
    last window on the end of the input."""
    left, right = pad_amounts(x.shape[-1], weight.shape[-1], stride, dilation, causal=True)
    x = pad1d_reflect(x, left, right)
    return F.conv1d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride=stride, dilation=dilation)
