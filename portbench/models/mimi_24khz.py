"""Mimi in the program: ``AudioToken(Tokenizers.mimi)`` at the configuration's
precision and codebooks, its encoder, with the benchmark's weights put into
its module in place of its own seeded draw."""

import numpy as np
import torch

from audiotoken_tpu_torch import AudioToken, Tokenizers

#: read when the harness loads this file: a program without Mimi fails here,
#: before the run makes anything on the card
TOKENIZER = Tokenizers.mimi


class Program:
    """The system under test for the encode entry; ``__call__`` is the timed
    call."""

    def __init__(self, cfg: dict, path: str, device):
        if path != "encode":
            raise ValueError(f"mimi_24khz: the program encodes only, not {path!r}")
        self.at = AudioToken(TOKENIZER, device=device, num_codebooks=cfg["encode_codebooks"],
                             weights="random", precision=cfg["precision"])
        self.at.load_encoder()

    @torch.no_grad()
    def load(self, weights: dict):
        """The benchmark's weights, in place of the program's: every leaf of
        the module, the codebooks too (strict)."""
        state = {**weights["encoder"], "semantic_codebooks": weights["semantic_codebooks"],
                 "acoustic_codebooks": weights["acoustic_codebooks"]}
        self.at.encoder.model.load_state_dict(state, strict=True)

    def set_precision(self, precision: str):
        """Switch the precision policy without new weights (the control of
        the check runs the program at ``high``)."""
        self.at.encoder.set_precision(precision)

    def __call__(self, req):
        return self.at.encoder(req.batch, np.asarray(req.lengths, np.int32))

    def close(self):
        self.at = None
