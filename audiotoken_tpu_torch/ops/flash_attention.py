"""K4: attention with the relative_key position bias and the padding bias;
K5: plain non-causal attention.

K4 is the counterpart of ``audiotoken_tpu/ops/flash_attention.py:
flash_attention_relkey`` (Pallas kernel ``_kernel``, and its 2-head-packed
form, which computes the same function). Its CUDA kernel is
``csrc/flash_attention.cu``: blockwise, with an online softmax, so no
[T, T] scores reach device memory, and both products on the tensor cores in
split precision (3xTF32: each f32 operand as a TF32 high part and a TF32
remainder, three passes, f32 accumulation), which keeps f32 accuracy as the
TPU kernel's multi-pass ``Precision.HIGHEST`` dots do.
:func:`flash_attention_relkey_plain` is the same function written the
direct way, with full scores and a gather for the rel term.

K5 (:func:`flash_attention_plain`) is the counterpart of
``_flash_attention_plain``: no bias, no mask, q pre-scaled, bf16 or f32.
In bf16 it is a kernel of its own on the bf16 tensor cores
(``csrc/flash_attention_plain.cu``); in f32 it is K4's 3xTF32 kernel
without its terms and without scaling the scores again
(``flash_attention_plain_f32`` in ``csrc/flash_attention.cu``).
"""

import torch

from . import _build
from .attention import padding_bias

#: head size the kernels are compiled for (csrc/flash_attention.cu,
#: csrc/flash_attention_plain.cu)
KERNEL_DH = 64


def flash_attention_relkey_plain(q, k, v, dist_embedding=None, frame_mask=None,
                                 left: int = 64, right: int = 8):
    """q, k, v [B, H, T, dh] f32; dist_embedding [left+right+1, dh] or None;
    frame_mask [B, T] {0, 1} or None -> [B, H, T, dh] f32.

    ``softmax((q k^T + rel) / sqrt(dh) + padding_bias) v`` with
    ``rel[q, k] = (q E^T)[q, clamp(k - q + left, 0, P - 1)]``. ``None``
    drops the rel term or the padding bias (the HuBERT form)."""
    T, dh = q.shape[-2:]
    s = torch.matmul(q, k.transpose(-1, -2))
    if dist_embedding is not None:
        P = dist_embedding.shape[0]
        if P != left + right + 1:
            raise ValueError(f"dist_embedding has {P} rows, expected left + right + 1")
        pos = torch.matmul(q, dist_embedding.t())  # [B, H, T, P]
        t = torch.arange(T, device=q.device)
        idx = (t[None, :] - t[:, None] + left).clamp(0, P - 1)  # [T (q), T (k)]
        s = s + pos[:, :, t[:, None], idx]
    s = s * dh**-0.5
    if frame_mask is not None:
        s = s + padding_bias(frame_mask)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def flash_attention_relkey(q, k, v, dist_embedding=None, frame_mask=None,
                           left: int = 64, right: int = 8):
    """The function of :func:`flash_attention_relkey_plain`. Launches K4 for
    CUDA tensors (f32, contiguous, dh = 64) and runs the plain version for
    CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_relkey_plain(q, k, v, dist_embedding, frame_mask, left, right)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_relkey: unsupported device {q.device}")
    B, H, T, dh = q.shape
    if dh != KERNEL_DH:
        raise ValueError(f"flash_attention_relkey: head size {dh}, the kernel takes {KERNEL_DH}")
    if left < 0 or right < 0:
        raise ValueError(f"flash_attention_relkey: left {left}, right {right} must be >= 0")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(t, name, (B, H, T, dh), torch.float32, dev, vector_loads=True)
    P = 0
    if dist_embedding is not None:
        P = left + right + 1
        _build.check_tensor(dist_embedding, "dist_embedding", (P, dh), torch.float32, dev)
    if frame_mask is not None:
        _build.check_tensor(frame_mask, "frame_mask", (B, T), torch.float32, dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch("flash_attention_relkey_f32", dev, q, k, v, dist_embedding, frame_mask,
                  out, B * H, H, T, P, left)
    flash_attention_relkey.launches += 1
    return out


flash_attention_relkey.launches = 0


def noncausal_attention_plain(q, k, v):
    """q (pre-scaled by dh^-0.5), k, v [B, H, T, dh] bf16 or f32 ->
    ``softmax(q k^T) v`` [B, H, T, dh] in the input's dtype, computed in f32.

    In bf16 it computes what the Pallas bodies do (``_kernel_onepass``,
    ``_kernel_plain``): ``p = exp(s - rowmax)`` and ``l = sum(p)`` in f32,
    then ``acc = bf16(p) @ v`` in f32 and ``out = acc / max(l, 1e-30)``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if q.dtype == torch.float32:
        return torch.matmul(torch.softmax(s, dim=-1), v)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def flash_attention_plain(q, k, v):
    """K5: the function of :func:`noncausal_attention_plain` (non-causal,
    no bias, no mask, q pre-scaled). Launches the bf16 kernel of
    ``csrc/flash_attention_plain.cu`` or, in f32, K4's kernel of
    ``csrc/flash_attention.cu`` for CUDA tensors (contiguous, dh = 64) and
    runs the plain version for CPU tensors.

    Counterpart of ``audiotoken_tpu/ops/flash_attention.py:
    _flash_attention_plain`` (Pallas kernels ``_kernel_onepass`` and
    ``_kernel_plain``), which Bark-fine's attention reaches."""
    if q.device.type == "cpu":
        return noncausal_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_plain: unsupported device {q.device}")
    B, H, T, dh = q.shape
    if dh != KERNEL_DH:
        raise ValueError(f"flash_attention_plain: head size {dh}, the kernel takes {KERNEL_DH}")
    if q.dtype not in _build.DTYPE_SUFFIX:
        raise ValueError(f"flash_attention_plain: dtype {q.dtype}, the kernel takes bf16 or f32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(t, name, (B, H, T, dh), q.dtype, q.device, vector_loads=True)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch(f"flash_attention_plain_{_build.DTYPE_SUFFIX[q.dtype]}", q.device,
                  q, k, v, out, B * H, T)
    flash_attention_plain.launches += 1
    return out


flash_attention_plain.launches = 0
