"""``y = x W^T + b`` in f32 accuracy on the tensor cores: a 3xTF32 GEMM
(``csrc/linear_3xtf32.cu``).

:func:`linear_3xtf32` splits each operand into two TF32 parts (hi and the
TF32 remainder, :func:`~.flash_attention.tf32_round`'s rounding) and sums
three TF32 products, ``x_lo w_hi + x_hi w_lo + x_hi w_hi``, in f32: the
accuracy of an IEEE f32 product at three TF32 passes of the tensor cores
(165 TFLOP/s of f32 work, against cuBLAS's 67 of f32 FMAs). The weights are
split by the kernel's own pass on every call, so an in-place write to them
is always seen. It takes CUDA tensors alone, and raises on what its kernel
does not take rather than fall back to another product.

:class:`Linear` is an ``nn.Linear`` whose forward takes the kernel where it
runs at f32 accuracy (:func:`kernel_takes`: a CUDA f32 input with the TF32
switch off) and ``F.linear`` everywhere else; its parameters and
``state_dict`` keys are ``nn.Linear``'s. :func:`linear_3xtf32_twin` is the
kernel's arithmetic in plain PyTorch.
"""

import torch
import torch.nn.functional as F
from torch import nn

from . import _build
from .flash_attention import tf32_round

#: columns of a K tile (``BK`` in csrc/linear_3xtf32.cu): K must be a multiple
K_STEP = 32
#: columns of an output tile (``BN``): N must be a multiple
TILE_N = 128


def _split(t: torch.Tensor):
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def linear_3xtf32_twin(x, weight, bias=None):
    """The kernel's arithmetic in plain PyTorch: x and w split into TF32
    parts, ``x_lo w_hi + x_hi w_lo + x_hi w_hi`` as f32 products of exact
    TF32 parts (exact multiplies under either TF32 switch), then the bias."""
    xh, xl = _split(x)
    wh, wl = _split(weight)
    y = (F.linear(xl, wh) + F.linear(xh, wl)) + F.linear(xh, wh)
    return y if bias is None else y + bias


def kernel_takes(x, weight) -> bool:
    """Whether :class:`Linear` runs ``x`` through the kernel: a CUDA f32 x
    and weight with cuBLAS's TF32 switch off (a stage at ``highest``: the
    kernel is that precision's accuracy). A shape or a gradient that the
    kernel does not take then raises in :func:`linear_3xtf32`."""
    return (x.device.type == "cuda" and x.dtype == torch.float32
            and weight.dtype == torch.float32
            and not torch.backends.cuda.matmul.allow_tf32)


def linear_3xtf32(x, weight, bias=None):
    """x [..., K] f32, weight [N, K], bias [N] or None -> x W^T + b [..., N]
    at 3xTF32, for K a multiple of :data:`K_STEP` and N of :data:`TILE_N`,
    on a CUDA device (weight and bias on x's). Raises ValueError for another
    dtype or device, shapes the kernel does not take, or a gradient asked
    for (the kernel has no backward)."""
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"linear_3xtf32: {name} of dtype {t.dtype}, expected torch.float32")
    if x.dim() < 1 or weight.dim() != 2 or weight.shape[1] != x.shape[-1]:
        raise ValueError(f"linear_3xtf32: weight {tuple(weight.shape)} for x "
                         f"{tuple(x.shape)}, expected [N, {x.shape[-1] if x.dim() else '?'}]")
    N, K = weight.shape
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"linear_3xtf32: bias {tuple(bias.shape)}, expected ({N},)")
    if K % K_STEP or N % TILE_N:
        raise ValueError(f"linear_3xtf32: K = {K} and N = {N} must be multiples of "
                         f"{K_STEP} and {TILE_N}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias)):
        raise ValueError("linear_3xtf32: no backward; call it under torch.no_grad() "
                         "or with tensors that need no gradient")
    if x.device.type != "cuda":
        raise ValueError(f"linear_3xtf32: unsupported device {x.device}, expected CUDA")
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    M = x2.shape[0]
    _build.check_tensor(weight, "weight", (N, K), torch.float32, x.device)
    if bias is not None:
        _build.check_tensor(bias, "bias", (N,), torch.float32, x.device, vector_loads=True)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M:
        wsplit = torch.empty((2 * N * K,), dtype=torch.float32, device=x.device)
        _build.launch("linear_3xtf32_f32", x.device, x2, weight, bias, wsplit, y, M, N, K)
        linear_3xtf32.launches += 1
    return y.view(*x.shape[:-1], N)


linear_3xtf32.launches = 0


class Linear(nn.Linear):
    """``nn.Linear`` (the same parameters and ``state_dict`` keys) whose
    forward runs :func:`linear_3xtf32` where :func:`kernel_takes` holds and
    ``F.linear`` elsewhere: on the CPU bit for bit as ``nn.Linear``, and
    cuBLAS TF32 under a TF32 stage. On the card at ``highest`` a width the
    kernel does not take, or a gradient, raises."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if kernel_takes(x, self.weight):
            return linear_3xtf32(x, self.weight, self.bias)
        return F.linear(x, self.weight, self.bias)
