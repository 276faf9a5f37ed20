"""Everything a run makes from ``--seed``: weights and inputs, on the
device, from ``torch.Generator`` streams of their own.

A stream is named (``"weights.encoder"``, ``"traffic"``), so a part drawn
alone gives the same values as drawn beside the others, and the same seed
gives the same values in every run on the same card.
"""

import math
import zlib

import torch

_MASK = 2**63 - 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for ``stream`` under ``seed`` (any whole
    number, large ones too)."""
    g = torch.Generator(device=device)
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(stream.encode()) * 0xBF58476D1CE4E5B9)
    g.manual_seed(mixed & _MASK)
    return g


def make_weights(spec, seed: int, stream: str, device) -> dict:
    """Leaves drawn from ``spec``, a list of (name, shape, std, base): each
    leaf is ``base + std * N(0, 1)``, f32. One normal draw fills every leaf
    of the stream; the leaves are views of it."""
    g = generator(seed, stream, device)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, std, base), n in zip(spec, sizes):
        leaf = flat[off:off + n].view(shape)
        leaf.mul_(std)
        if base:
            leaf.add_(base)
        out[name] = leaf
        off += n
    return out
