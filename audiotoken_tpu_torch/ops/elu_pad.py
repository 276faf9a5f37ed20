"""The input of a SEANet conv in one pass: residual add, ELU and causal
reflect pad (``csrc/elu_pad.cu``).

``elu_pad(x, left, right, residual=r)`` is ``pad1d_reflect(F.elu(x + r),
left, right)``, the chain that ``nn/seanet.py`` ran before each padded
conv, bit for bit. The kernel runs for a CUDA tensor in f32 or in bf16
(the bf16 policy's plain convs), and refuses another dtype; a CPU tensor
takes :func:`elu_pad_plain`, that chain itself.
"""

import torch
import torch.nn.functional as F

from . import _build
from .conv import pad1d_reflect


#: the pad modes and the kernel's entry of each, by element type
_ENTRIES = {"reflect": {t: f"elu_pad_{s}" for t, s in _build.DTYPE_SUFFIX.items()},
            "constant": {torch.float32: "elu_pad_zero_f32"}}


def elu_pad_plain(x, left, right, residual=None, elu=True, keep_input=False,
                  pad_mode="reflect"):
    """x [B, C, T] -> [B, C, T + left + right]: ``pad1d_reflect(F.elu(x +
    residual), left, right)`` (``F.pad`` with zeros under ``pad_mode=
    "constant"``), the residual and the ELU optional; with ``keep_input``
    also ``x + residual`` contiguous."""
    v = x if residual is None else x + residual
    a = F.elu(v) if elu else v
    out = F.pad(a, (left, right)) if pad_mode == "constant" else pad1d_reflect(a, left, right)
    return (out, v.contiguous()) if keep_input else out


def elu_pad(x, left, right, residual=None, elu=True, keep_input=False, pad_mode="reflect"):
    """x [B, C, T] (any strides) -> out [B, C, T + left + right] contiguous,
    as :func:`elu_pad_plain`; with ``keep_input``, (out, x + residual
    contiguous), which is ``x`` itself where there is nothing to add and x
    is contiguous already. ``residual`` is a contiguous [B, C, T] tensor of
    x's dtype. Launches the kernel for a CUDA ``x`` in f32 or bf16 (f32
    alone under ``pad_mode="constant"``)."""
    if pad_mode not in _ENTRIES:
        raise ValueError(f"elu_pad: pad_mode {pad_mode!r}, expected one of {sorted(_ENTRIES)}")
    if x.device.type == "cpu":
        return elu_pad_plain(x, left, right, residual, elu, keep_input, pad_mode)
    if x.device.type != "cuda":
        raise ValueError(f"elu_pad: unsupported device {x.device}")
    entry = _ENTRIES[pad_mode].get(x.dtype)
    if entry is None:
        raise ValueError(f"elu_pad: dtype {x.dtype}, the kernel takes "
                         f"{' or '.join(str(t) for t in _ENTRIES[pad_mode])} under {pad_mode!r}")
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"elu_pad: x of shape {tuple(x.shape)}, expected [B, C, T] not empty")
    if left < 0 or right < 0:
        raise ValueError(f"elu_pad: negative pad ({left}, {right})")
    B, C, T = x.shape
    if residual is not None:
        _build.check_tensor(residual, "residual", (B, C, T), x.dtype, x.device)
    out = torch.empty((B, C, T + left + right), dtype=x.dtype, device=x.device)
    keep = None
    if keep_input and (residual is not None or not x.is_contiguous()):
        keep = torch.empty((B, C, T), dtype=x.dtype, device=x.device)
    _build.launch(entry, x.device, x, residual, out, keep,
                  B, C, T, left, right, *x.stride(), int(elu))
    elu_pad.launches += 1
    if keep_input:
        return out, (x if keep is None else keep)
    return out


elu_pad.launches = 0


def elu_mismatches(device, dtype=torch.float32, chunk: int = 1 << 28) -> int:
    """The inputs on which the kernel differs bit for bit from ATen on a
    CUDA ``device`` (any NaN matches any NaN), run through :func:`elu_pad`
    in rows of ``chunk`` elements. In f32 its ELU against ``F.elu`` on all
    2^32 floats; in bf16 its add and ELU against ``F.elu(x + r)`` on all
    2^32 pairs of bf16 values (x the high half of each 32-bit pattern, r
    the low half)."""
    device = torch.device(device)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    for start in range(0, 1 << 32, chunk):
        bits = torch.arange(start - (1 << 31), start + chunk - (1 << 31), dtype=torch.int64,
                            device=device)
        if dtype == torch.float32:
            x, r = bits.to(torch.int32).view(torch.float32).view(1, 1, -1), None
            ref = F.elu(x)
        else:
            x = ((bits >> 16) & 0xFFFF).sub(1 << 15).to(torch.int16).view(dtype).view(1, 1, -1)
            r = (bits & 0xFFFF).sub(1 << 15).to(torch.int16).view(dtype).view(1, 1, -1)
            ref = F.elu(x + r)
        a = elu_pad(x, 0, 0, residual=r)
        ints = torch.int32 if dtype == torch.float32 else torch.int16
        bad += ((a.view(ints) != ref.view(ints)) & ~(a.isnan() & ref.isnan())).sum()
        del bits, x, r, a, ref
    return int(bad.item())
