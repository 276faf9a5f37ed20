"""K2: the LSTM recurrence, and the stacked LSTM with residual skip.

Counterpart of ``audiotoken_tpu/ops/lstm_pallas.py`` (``lstm_layer_pallas``
and ``lstm_skip_pallas``) and of ``nn/seanet.py:lstm_skip``. The CUDA
kernel is ``csrc/lstm.cu``; :func:`lstm_layer_plain` is the same function
written the direct way, as a Python loop over steps.
"""

import torch

from . import _build

#: hidden size the kernel is compiled for (csrc/lstm.cu)
KERNEL_H = 512
#: batch rows one launch of the kernel takes; a larger batch runs as groups
ROW_GROUP = 32


def lstm_layer_plain(xi: torch.Tensor, whh: torch.Tensor) -> torch.Tensor:
    """xi [B, T, 4H] (input projections with biases), whh [4H, H] (torch
    layout) -> hidden states [B, T, H]. Gate order (i, f, g, o)."""
    B, T, H4 = xi.shape
    H = H4 // 4
    h = xi.new_zeros((B, H))
    c = xi.new_zeros((B, H))
    whh_t = whh.t()
    out = xi.new_empty((B, T, H))
    for t in range(T):
        i, f, g, o = (xi[:, t] + h @ whh_t).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out


def lstm_layer(xi: torch.Tensor, whh: torch.Tensor) -> torch.Tensor:
    """xi [B, T, 4H] f32, whh [4H, H] f32 -> [B, T, H] f32. Launches K2 for
    a CUDA tensor (H = 512, the SEANet LSTMs' size, which the kernel is
    compiled for), once per group of up to :data:`ROW_GROUP` batch rows, and
    runs :func:`lstm_layer_plain` for a CPU tensor."""
    if xi.device.type == "cpu":
        return lstm_layer_plain(xi, whh)
    if xi.device.type != "cuda":
        raise ValueError(f"lstm_layer: unsupported device {xi.device}")
    B, T, _ = xi.shape
    if B < 1 or T < 1:
        raise ValueError(f"lstm_layer: empty input {tuple(xi.shape)}")
    _build.check_tensor(xi, "xi", (B, T, 4 * KERNEL_H), torch.float32, xi.device)
    _build.check_tensor(whh, "whh", (4 * KERNEL_H, KERNEL_H), torch.float32, xi.device,
                        vector_loads=True)
    out = torch.empty((B, T, KERNEL_H), dtype=torch.float32, device=xi.device)
    # the blocks exchange h through this ping-pong buffer, one step each side
    hbuf = torch.empty((2, min(B, ROW_GROUP), KERNEL_H), dtype=torch.float32, device=xi.device)
    for b0 in range(0, B, ROW_GROUP):
        R = min(ROW_GROUP, B - b0)
        _build.launch("lstm_layer_f32", xi.device, xi[b0:b0 + R], whh, out[b0:b0 + R], hbuf,
                      R, T)
        lstm_layer.launches += 1
    return out


lstm_layer.launches = 0


def lstm_skip(layers, x: torch.Tensor) -> torch.Tensor:
    """Stacked LSTM with residual skip: x + LSTM_n(...LSTM_1(x)).

    ``layers`` holds (wih [4H, in], whh [4H, H], bih [4H], bhh [4H]) per
    layer; x is [B, T, in] f32. The input projection of all steps is one
    matmul outside the recurrence.
    """
    h0 = x
    for wih, whh, bih, bhh in layers:
        xi = torch.matmul(x, wih.t()) + (bih + bhh)
        x = lstm_layer(xi, whh)
    return h0 + x
