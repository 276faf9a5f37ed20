"""The traffic: a mix file's parameters -> the requests of a window, made on
the device from the seed and handed over as host arrays, as callers of the
program hold them.

A mix (``traffic/<mix>.json``) names its ``generator``
(``generators/<generator>.py``, whose ``make(mix, cfg, g, device)`` returns
one call's host inputs and each row's length), its ``rows`` and its
``pool``: a window cycles through ``pool`` distinct requests made in
set-up. Every seed gives the same sizes: where a mix gives a row length a
least value beside its greatest, the rows' lengths are evenly spaced
between the two and the seed only shuffles them. ``greedy_every`` n makes
every n-th request of the pool (the n-th, the 2n-th, ...) ask for greedy
decoding: requests of a sampled decoder whose tokens the check can judge
one by one.
"""

from dataclasses import dataclass

import numpy as np
import torch

from portbench.registry import CellError, load_module
from portbench.seeded import generator


@dataclass
class Request:
    """One call's inputs: ``batch`` (host arrays), each row's length in the
    mix's unit (samples, frames or ids), and whether it decodes greedily."""

    batch: object
    lengths: list
    greedy: bool = False


def row_lengths(rows: int, least: int, most: int, g, device) -> list:
    """``rows`` lengths evenly spaced from ``least`` to ``most`` in an order
    drawn from ``g`` (all ``most``, and no draw, where the two are equal)."""
    if least == most:
        return [int(most)] * rows
    fixed = np.linspace(least, most, rows).round().astype(np.int64)
    order = torch.randperm(rows, generator=g, device=device).cpu().numpy()
    return [int(fixed[i]) for i in order]


def make_pool(mix: dict, cfg: dict, seed: int, device) -> list:
    """The ``pool`` requests of ``mix`` for configuration ``cfg``."""
    gen = load_module("generators", mix["generator"])
    if gen is None:
        raise CellError(f"no generator {mix['generator']!r} (portbench/generators/)")
    g = generator(seed, "traffic", device)
    every = int(mix.get("greedy_every", 0))
    pool = []
    for i in range(int(mix["pool"])):
        batch, lengths = gen.make(mix, cfg, g, device)
        pool.append(Request(batch, lengths, greedy=bool(every) and i % every == every - 1))
    return pool
