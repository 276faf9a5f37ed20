"""K8: cost-attribution ablations of K5, for the attention micro-profile.

Counterpart of the two Pallas kernels inside ``scripts/
profile_attn_micro.py:main`` (``ablation_kernel`` through ``run_ablation``,
``onepass_kernel`` through ``run_onepass``). They are deliberately NOT
valid attention: each takes a part of the softmax out of K5's first,
f32-FMA design so that the time it saves is that part's cost. The ``full``
mode is that design whole (valid attention, the baseline the ablations are
subtracted from). The CUDA kernel is ``csrc/attn_ablation.cu``; the modes
are described there. :func:`attn_ablation_plain` repeats each mode's
arithmetic with a PyTorch loop over key tiles; it runs for CPU tensors
and is what the kernel is held against on the card.

q is pre-scaled by dh^-0.5, as at ``profile_attn_micro.py:103``.
"""

from collections import Counter

import torch

from . import _build

#: mode -> the tiles the kernel is compiled for: keys per tile for
#: ``noexp``, ``dotsonly`` and ``full``, query rows per block for ``onepass``
KERNEL_TILES = {"full": (64,), "noexp": (64, 128), "dotsonly": (64, 128), "onepass": (16, 32)}
_MODE_ID = {"noexp": 0, "dotsonly": 1, "onepass": 2, "full": 3}
#: every (mode, tile) the kernel runs, by the name its launches count under
CASES = tuple(f"{m}{t}" for m, tiles in KERNEL_TILES.items() for t in tiles)
ONEPASS_MAX_T = 1024  # the score rows of 32 query rows fit shared memory


def attn_ablation_plain(q, k, v, mode: str, tile: int):
    """q (pre-scaled), k, v [B, H, T, dh] bf16 or f32 -> [B, H, T, dh] in
    the input's dtype; the products and the softmax's arithmetic in f32,
    p rounded to the input's dtype before the second product.

    ``mode``:
      * ``"noexp"``, ``"dotsonly"``: the ablations over key tiles of
        ``tile`` (T % tile == 0): see ``csrc/attn_ablation.cu``;
      * ``"full"``: the online softmax they ablate (``exp`` and the
        accumulator's rescale by alpha), the function of K5 and of the JAX
        package's ``_kernel_plain``;
      * ``"onepass"``: exact softmax over the whole key row; ``tile`` (query
        rows a block in the kernel) does not change the result.
    """
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    T = q.shape[-2]
    if mode == "onepass":
        s = torch.matmul(qf, kf.transpose(-1, -2))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(p.to(dt).float(), vf)
        return (acc / l.clamp_min(1e-30)).to(dt)
    if mode not in ("noexp", "dotsonly", "full"):
        raise ValueError(f"attn_ablation: unknown mode {mode!r}")
    if T % tile:
        raise ValueError(f"attn_ablation: T = {T} is not a multiple of the tile {tile}")
    m = torch.full((*q.shape[:-1], 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, T, tile):
        s = torch.matmul(qf, kf[..., k0:k0 + tile, :].transpose(-1, -2))
        if mode == "dotsonly":
            p = (s * 1e-6).to(dt).float()  # keeps the data dependence, no softmax
            l = l + 1.0
        else:
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = s - m_new if mode == "noexp" else torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            p = p.to(dt).float()
            if mode == "full":
                acc = acc * alpha
            m = m_new
        acc = acc + torch.matmul(p, vf[..., k0:k0 + tile, :])
    return (acc / l.clamp_min(1e-30)).to(dt)


def attn_ablation(q, k, v, mode: str, tile: int):
    """The function of :func:`attn_ablation_plain` for ``mode`` in
    ``noexp``, ``dotsonly``, ``onepass``, ``full`` and the tiles of
    :data:`KERNEL_TILES`. Launches K8 for CUDA tensors (bf16 or f32,
    contiguous, dh = 64; T a multiple of the key tile, or for ``onepass``
    of 64 and at most 1024) and runs the plain version for CPU tensors.
    Launches count under ``f"{mode}{tile}"`` in ``attn_ablation.launches``."""
    if mode not in KERNEL_TILES or tile not in KERNEL_TILES[mode]:
        raise ValueError(f"attn_ablation: mode {mode!r} with tile {tile} is not compiled; "
                         f"use one of {KERNEL_TILES}")
    if q.device.type == "cpu":
        return attn_ablation_plain(q, k, v, mode, tile)
    if q.device.type != "cuda":
        raise ValueError(f"attn_ablation: unsupported device {q.device}")
    B, H, T, dh = q.shape
    if dh != 64:
        raise ValueError(f"attn_ablation: head size {dh}, the kernel takes 64")
    if q.dtype not in _build.DTYPE_SUFFIX:
        raise ValueError(f"attn_ablation: dtype {q.dtype}, the kernel takes bf16 or f32")
    if mode == "onepass" and (T % 64 or T > ONEPASS_MAX_T):
        raise ValueError(f"attn_ablation: onepass takes T a multiple of 64 up to "
                         f"{ONEPASS_MAX_T}, got {T}")
    if mode != "onepass" and T % tile:
        raise ValueError(f"attn_ablation: T = {T} is not a multiple of the tile {tile}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(t, name, (B, H, T, dh), q.dtype, q.device, vector_loads=True)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch(f"attn_ablation_{_build.DTYPE_SUFFIX[q.dtype]}", q.device,
                  q, k, v, out, B * H, T, _MODE_ID[mode], tile)
    attn_ablation.launches[f"{mode}{tile}"] += 1
    return out


attn_ablation.launches = Counter()
