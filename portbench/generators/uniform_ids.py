"""``rows`` arrays [length] of ids drawn uniformly from ``vocabulary``,
``length`` long (``min_length`` to ``length``).

-> (a list of int16 [length] arrays, each row's length in ids)."""

import torch

from portbench.synth import row_lengths


def make(mix: dict, cfg: dict, g, device):
    rows, length = int(mix["rows"]), int(mix["length"])
    lengths = row_lengths(rows, int(mix.get("min_length", length)), length, g, device)
    ids = torch.randint(0, int(mix["vocabulary"]), (rows, length), generator=g,
                        device=device).to(torch.int16).cpu().numpy()
    return [r[:n] for r, n in zip(ids, lengths)], lengths
