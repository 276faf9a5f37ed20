"""The collectives of tensor and data parallelism, written out.

In the JAX package XLA inserts these from the sharding annotations
(``audiotoken_tpu/parallel/shard.py``); here each is a call on a mesh
axis (``mesh.Axis``), and the ones a training step differentiates through
are ``torch.autograd.Function``s with Megatron's pairing:

- :func:`copy_to` — identity forward, all-reduce of the gradient backward
  (where a replicated activation enters a column-parallel product);
- :func:`reduce_from` — all-reduce forward, identity backward (after a
  row-parallel product, before its bias and the residual add);
- :func:`row_linear` — a row-parallel product: its partial sums through
  :func:`reduce_from`, then the bias once;
- :func:`vocab_embedding` and :func:`vocab_cross_entropy` over a
  vocab-parallel table, which never gather the logits.

:func:`all_gather` (inference only) joins every rank's block over an axis.

On an axis of one rank every one of them is the identity and touches no
process group.

Under gloo (the CPU backend, and the way two processes share one card,
where NCCL refuses) CUDA tensors go to the process group as they are:
gloo stages them through host memory itself. On PyTorch 2.11 (CUDA 12.8)
it took every collective used here on CUDA tensors (all_reduce with SUM
and MAX, all_gather; ``chip_smoke.py`` phase 7b checks them), so none is
staged by hand.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F


def all_reduce(x: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` summed (or maxed) over the ranks of ``axis``."""
    if axis.size == 1:
        return x
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=red, group=axis.group)
    return y


def all_gather(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` joined along ``dim``, in axis order."""
    if axis.size == 1:
        return x
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself; backward, its gradient summed over ``axis``."""
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over ``axis``; backward, the gradient passes as it is."""
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias, axis) -> torch.Tensor:
    """``x @ weight.T + bias`` where ``x`` and ``weight`` hold this rank's
    block of the input dim: the partial sums are summed over ``axis``
    before the bias is added, once."""
    if axis.size == 1:
        return F.linear(x, weight, bias)
    y = reduce_from(F.linear(x, weight), axis)
    return y if bias is None else y + bias


def vocab_embedding(ids: torch.Tensor, table: torch.Tensor, axis) -> torch.Tensor:
    """Rows of a vocab-parallel table: ``table`` holds rows
    ``index * V_local ... (index + 1) * V_local`` of the full one. Each rank
    looks up the ids it holds, zeroes the rest, and the sum over ``axis``
    is the full lookup."""
    if axis.size == 1:
        return table[ids]
    v = table.shape[0]
    local = ids - axis.index * v
    held = (local >= 0) & (local < v)
    rows = table[torch.where(held, local, 0)] * held[..., None]
    return reduce_from(rows, axis)


class _VocabCrossEntropy(torch.autograd.Function):
    """-log softmax(logits)[target] per position, over logits split by vocab
    over the axis: the max, the sum of exponentials and the target's logit
    are each all-reduced, never the logits."""

    @staticmethod
    def forward(ctx, logits, targets, axis):
        v = logits.shape[-1]
        m = all_reduce(logits.detach().amax(dim=-1), axis, op="max")
        shifted = logits - m[..., None]
        local = targets - axis.index * v
        held = (local >= 0) & (local < v)
        idx = torch.where(held, local, 0)
        tgt = shifted.gather(-1, idx[..., None])[..., 0] * held
        tgt = all_reduce(tgt, axis)
        e = shifted.exp()
        s = all_reduce(e.sum(dim=-1), axis)
        ctx.save_for_backward(e / s[..., None], idx, held)
        return s.log() - tgt

    @staticmethod
    def backward(ctx, g):
        p, idx, held = ctx.saved_tensors
        grad = p.clone()
        grad.scatter_add_(-1, idx[..., None], -held[..., None].to(p.dtype))
        return grad * g[..., None], None, None


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, axis) -> torch.Tensor:
    """Per-position negative log-likelihood of ``targets`` (valid ids) under
    vocab-parallel ``logits`` [..., V_local] f32 -> [...]."""
    return _VocabCrossEntropy.apply(logits, targets, axis)
