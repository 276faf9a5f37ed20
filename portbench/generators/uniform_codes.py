"""``rows`` arrays [codebooks, frames] of codes drawn uniformly from the
configuration's codebook size, ``frames`` long (``min_frames`` to
``frames``).

-> (a list of int16 [codebooks, length] arrays, each row's length in
frames)."""

import torch

from portbench.synth import row_lengths


def make(mix: dict, cfg: dict, g, device):
    rows, frames = int(mix["rows"]), int(mix["frames"])
    lengths = row_lengths(rows, int(mix.get("min_frames", frames)), frames, g, device)
    codes = torch.randint(0, int(cfg["codebook_size"]), (rows, int(mix["codebooks"]), frames),
                          generator=g, device=device).to(torch.int16).cpu().numpy()
    return [c[:, :n] for c, n in zip(codes, lengths)], lengths
