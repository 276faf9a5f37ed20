"""EnCodec 24 kHz in the program: ``AudioToken(Tokenizers.acoustic)`` at
the configuration's precision, its encoder (12 kbps, 16 codebooks) or its
decoder (6 kbps, 8 codebooks, int16 output), with the benchmark's weights
put into its modules in place of its own seeded draw."""

import numpy as np
import torch

from audiotoken_tpu_torch import AudioToken, Tokenizers


class Program:
    """The system under test for one entry; ``__call__`` is the timed call."""

    def __init__(self, cfg: dict, path: str, device):
        self.path = path
        k = cfg["encode_codebooks"] if path == "encode" else cfg["decode_codebooks"]
        self.at = AudioToken(Tokenizers.acoustic, device=device, num_codebooks=k,
                             weights="random", precision=cfg["precision"])
        if path == "encode":
            self.at.load_encoder()
        else:
            self.at.load_decoder(output_dtype="int16")

    @torch.no_grad()
    def load(self, weights: dict):
        """The benchmark's weights, in place of the program's: every leaf of
        the SEANet module (strict), and the codebooks."""
        if self.path == "encode":
            self.at.encoder.seanet.load_state_dict(weights["encoder"], strict=True)
            self.at.encoder.quantizer.codebooks.copy_(weights["codebooks"])
        else:
            self.at.decoder.seanet.load_state_dict(weights["decoder"], strict=True)
            self.at.decoder.codebooks.copy_(weights["codebooks"])

    def set_precision(self, precision: str):
        """Switch the entry's precision policy without new weights (the
        control of the check runs the program at ``high``)."""
        if self.path == "encode":
            self.at.encoder.set_precision(precision)
        else:
            from audiotoken_tpu_torch.runtime.precision import get_policy

            self.at.decoder.policy = get_policy(precision)

    def __call__(self, req):
        if self.path == "encode":
            return self.at.encoder(req.batch, np.asarray(req.lengths, np.int32))
        return self.at.decode_batch(req.batch)

    def close(self):
        self.at = None
