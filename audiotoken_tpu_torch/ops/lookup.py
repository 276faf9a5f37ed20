"""Nearest-centroid lookup (the semantic quantizers' assignment op).

Counterpart of ``audiotoken_tpu/ops/lookup.py``: a plain matmul and
argmax, which the JAX package also left to XLA.
"""

import torch


def nearest_centroid(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """x [..., D], centroids [C, D] -> indices [...] int64.

    Distance ``-(|x|^2 - 2 x.c + |c|^2)`` (torch.cdist's matmul form), ties
    to the first index (torch ``argmax``'s rule)."""
    x = x.float()
    c = centroids.float()
    x2 = (x * x).sum(dim=-1, keepdim=True)
    xc = torch.matmul(x, c.t())
    c2 = (c * c).sum(dim=-1)
    return torch.argmax(-(x2 - 2.0 * xc + c2), dim=-1)
