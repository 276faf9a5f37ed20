"""K1: the SEANet encoder's front (conv_in + first residual block).

Counterpart of ``audiotoken_tpu/ops/seanet_pallas.py:seanet_front_fused``.
The CUDA kernel is ``csrc/seanet_front.cu``; :func:`seanet_front_plain` is
the same function written the direct way, as a chain of ``F.conv1d``.
"""

import torch
import torch.nn.functional as F

from . import _build
from .conv import conv1d

#: (name, shape) of the weights, torch Conv1d layout [C_out, C_in, K].
WEIGHT_SHAPES = (
    ("conv_in.weight", (32, 1, 7)), ("conv_in.bias", (32,)),
    ("conv1.weight", (16, 32, 3)), ("conv1.bias", (16,)),
    ("conv2.weight", (32, 16, 1)), ("conv2.bias", (32,)),
    ("shortcut.weight", (32, 32, 1)), ("shortcut.bias", (32,)),
)


def seanet_front_plain(x, wc, bc, w1, b1, w2, b2, ws, bs):
    """x [B, T] -> [B, 32, T]: causal conv_in, then ELU -> k3 conv ->
    ELU -> 1x1 conv plus a 1x1 shortcut of conv_in's output."""
    a = conv1d(x[:, None, :], wc, bc)
    h = conv1d(F.elu(a), w1, b1)
    h = conv1d(F.elu(h), w2, b2)
    return conv1d(a, ws, bs) + h


def seanet_front(x, wc, bc, w1, b1, w2, b2, ws, bs):
    """x [B, T] f32 -> [B, 32, T] f32. Launches K1 for a CUDA tensor and
    runs :func:`seanet_front_plain` for a CPU tensor."""
    weights = (wc, bc, w1, b1, w2, b2, ws, bs)
    if x.device.type == "cpu":
        return seanet_front_plain(x, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"seanet_front: unsupported device {x.device}")
    B, T = x.shape
    if B < 1 or T < 1:
        raise ValueError(f"seanet_front: empty input {tuple(x.shape)}")
    _build.check_tensor(x, "x", (None, None), torch.float32, x.device)
    for (name, shape), w in zip(WEIGHT_SHAPES, weights):
        _build.check_tensor(w, name, shape, torch.float32, x.device)
    out = torch.empty((B, 32, T), dtype=torch.float32, device=x.device)
    _build.launch("seanet_front_f32", x.device, x, out, B, T, *weights)
    seanet_front.launches += 1
    return out


seanet_front.launches = 0


def elu_mismatches(device) -> int:
    """The floats, of all 2^32, on which K1's ELU differs bit for bit from
    ``v if v > 0 else expm1f(v)`` on a CUDA ``device``: K1 computes expm1f's
    operations with other instructions (``csrc/seanet_front.cu``)."""
    device = torch.device(device)
    count = torch.zeros(1, dtype=torch.int64, device=device)
    _build.launch("seanet_front_elu_mismatches", device, count)
    return int(count.item())
