"""K6: one decode token's attention over the GPT's KV cache.

Counterpart of ``audiotoken_tpu/ops/decode_attention.py``:
``decode_attention_fused`` (Pallas kernel ``_kernel_fused``) computes the
normalised attention over the valid cached slots plus the current token's
self term; ``decode_attention`` (``_kernel``) returns the unnormalised
partials of the same for the caller to fold the self term in. One CUDA
kernel (``csrc/decode_attention.cu``) computes the fused function, which
covers both.

The cache is the port's own layout, ``[n_layer, B, nh, slots, dh]`` for k
and for v, and a call takes one layer's ``[B, nh, slots, dh]`` view. The
TPU's block-diagonal Q and its ``[B, nh*dh, L]`` / ``[B, L, nh*dh]``
orientations were (8, 128)-tile workarounds and are not carried over.
Slot j of row b is attended iff ``start[b] <= j < pos``; the rows are
left-padded, so ``start`` is where a row's prompt begins. After the
attention, the call appends the token: k_new and v_new are written into
slot ``pos`` of the caches, in place. q comes unscaled, as the column
slice of the qkv projection that k_new and v_new are too; the function
scales it by dh^-0.5 (the JAX package scales q before its kernel: 0.125
is a power of two, so the bits are the same).
"""

import torch

from . import _build

#: head size the kernel is compiled for (csrc/decode_attention.cu)
KERNEL_DH = 64


def decode_attention_plain(q, k_cache, v_cache, start, pos: int, k_new, v_new):
    """q, k_new, v_new [B, nh*dh] (q unscaled: it is scaled by dh^-0.5
    here, in f32); k_cache, v_cache [B, nh, L, dh]; start [B] int32 -> the
    attention output [B, nh*dh] in the cache dtype, computed in f32. Writes
    k_new and v_new into slot ``pos`` of the caches."""
    B, nh, _, dh = k_cache.shape
    qf = (q.float() * dh**-0.5).reshape(B, nh, 1, dh)
    kn = k_new.reshape(B, nh, 1, dh)
    vn = v_new.reshape(B, nh, 1, dh)
    s = torch.matmul(qf, k_cache[:, :, :pos].float().transpose(-1, -2))  # [B, nh, 1, pos]
    valid = torch.arange(pos, device=q.device)[None, :] >= start.long()[:, None]  # [B, pos]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    s_self = (qf * kn.float()).sum(-1, keepdim=True)  # [B, nh, 1, 1]
    p = torch.softmax(torch.cat([s, s_self], dim=-1), dim=-1)
    out = torch.matmul(p[..., :pos], v_cache[:, :, :pos].float()) + p[..., pos:] * vn.float()
    k_cache[:, :, pos] = kn[:, :, 0]
    v_cache[:, :, pos] = vn[:, :, 0]
    return out.reshape(B, nh * dh).to(v_cache.dtype)


def decode_attention(q, k_cache, v_cache, start, pos: int, k_new, v_new,
                     chained: bool = False):
    """The function of :func:`decode_attention_plain`, cache write
    included. Launches K6 for CUDA tensors (bf16 or f32, dh = 64; q, k_new
    and v_new may be column slices of the qkv projection, rows one stride
    apart) and runs the plain version for CPU tensors. ``chained``: the call
    sits in the decode step's chain of kernels, after decode_qkv (which
    writes neither the caches nor ``start``) and before decode_ffn, so K6
    may start reading the cache while decode_qkv runs, and decode_ffn may
    start streaming its weights during K6 (programmatic dependent
    launch)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, start, pos, k_new, v_new)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, nh, L, dh = k_cache.shape
    if dh != KERNEL_DH:
        raise ValueError(f"decode_attention: head size {dh}, the kernel takes {KERNEL_DH}")
    dt, dev = k_cache.dtype, q.device
    if dt not in _build.DTYPE_SUFFIX:
        raise ValueError(f"decode_attention: dtype {dt}, the kernel takes bf16 or f32")
    if not 0 <= pos < L:
        raise ValueError(f"decode_attention: slot {pos} outside the cache's {L}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check_tensor(t, name, (B, nh, L, dh), dt, dev, vector_loads=True)
    _build.check_tensor(start, "start", (B,), torch.int32, dev)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _build.check_tensor(t, name, (B, nh * dh), dt, dev, vector_loads=True, strided_rows=True)
    if not q.stride(0) == k_new.stride(0) == v_new.stride(0):
        raise ValueError("decode_attention: q, k_new and v_new rows must share a stride")
    out = torch.empty((B, nh * dh), dtype=dt, device=dev)
    _build.launch(f"decode_attention_{_build.DTYPE_SUFFIX[dt]}", dev, q, k_cache, v_cache,
                  start, k_new, v_new, out, B, nh, L, pos, k_new.stride(0), int(chained))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
