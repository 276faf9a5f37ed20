"""Length bucketing of variable-length audio.

PyTorch does not recompile per shape, but the bucket padding stays: the
tokens are defined on the zero-padded bucket input. The causal SEANet stack
keeps the valid prefix's tokens unchanged by right padding, except that
the last frame's extra right padding (``ops/conv.py:pad_amounts``) sees the
bucket's zeros instead of a reflection of the signal's end.
"""

import math
from typing import Sequence, Tuple

import numpy as np


def default_buckets(
    sample_rate: int,
    hop: int,
    min_seconds: float = 1.0,
    max_seconds: float = 32.0,
) -> Tuple[int, ...]:
    """Geometric bucket grid (x2 per step, plus 1.5x midpoints), each aligned
    up to a multiple of ``hop`` samples, plus a 30 s bucket."""
    out = []
    s = min_seconds
    while s < max_seconds:
        for v in (s, s * 1.5):
            if v < max_seconds:
                out.append(int(math.ceil(v * sample_rate / hop) * hop))
        s *= 2
    if min_seconds <= 30 <= max_seconds:
        out.append(int(math.ceil(30 * sample_rate / hop) * hop))
    out.append(int(math.ceil(max_seconds * sample_rate / hop) * hop))
    return tuple(sorted(set(out)))


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest bucket if n exceeds the grid)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_to_bucket(
    audio: np.ndarray, buckets: Sequence[int], pad_value: float = 0.0
) -> np.ndarray:
    """[B, T] -> [B, bucket], right-padded with ``pad_value``.

    An input on a bucket boundary, or beyond the grid, is returned as is.
    The acoustic path is causal, so it needs no attention mask.
    """
    n = audio.shape[-1]
    pad = max(0, bucket_length(n, buckets) - n)
    if pad > 0:
        audio = np.pad(audio, ((0, 0), (0, pad)), constant_values=pad_value)
    return audio
