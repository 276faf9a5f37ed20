"""semantic_m in the program: ``AudioToken(Tokenizers.semantic_m)`` at the
configuration's precision, with the benchmark's weights put into its
modules in place of its own seeded draw.

  * encode: its encoder (fbank, w2v-BERT 2.0 to block 19, VQ 2048);
  * decode: ``decode_batch`` (the GPT's sampled AR stage, Bark-fine,
    EnCodec 6 kbps, int16 out). What each stage hands the next is kept
    beside the answer (``Answer``): the stages sample, so the reference
    judges each stage on the program's own draws. A greedy request asks
    the AR stage for top-k 1 and the fine stage for its best codes.
"""

import numpy as np
import torch

from audiotoken_tpu_torch import AudioToken, Tokenizers


class Answer(list):
    """A decode call's waveforms, with the AR stage's tokens [B,
    max_new_tokens] (-1 past a row's stop), Bark-fine's last window as it
    filled it (a device tensor [B, block_size, 8], the padding past T
    too), the fine codes [B, 8, T] and the row lengths its EnCodec stage
    was given."""

    tokens = None
    window = None
    fine = None
    lens = None


class Program:
    """The system under test for one entry; ``__call__`` is the timed call."""

    def __init__(self, cfg: dict, path: str, device):
        self.path = path
        self.at = AudioToken(Tokenizers.semantic_m, device=device, weights="random",
                             precision=cfg["precision"])
        if path == "encode":
            self.at.load_encoder()
            return
        d = cfg["decoder"]
        self.at.load_decoder(output_dtype="int16", max_new_tokens=d["max_new_tokens"],
                             temperature=d["temperature"], top_k=d["top_k"])
        dec = self.at.decoder
        self.top_k, self.greedy, self._seen = d["top_k"], False, {}
        generate, fine, stage = dec.gpt.generate_batch, dec.bark.generate_fine_batch, dec._acoustic_stage

        # no copies and no waits: each is a stage's own output or input
        def keep_tokens(*args, **kw):
            self._seen["tokens"] = generate(*args, **kw)
            return self._seen["tokens"]

        def fine_stage(coarse, temperature=d["fine_temperature"], seed=0):
            return fine(coarse, None if self.greedy else temperature, seed)

        def keep_window(module, args):  # the window Bark-fine fills in place
            self._seen["window"] = args[0]

        def keep_fine(codes, lens):
            self._seen["fine"], self._seen["lens"] = codes, list(lens)
            return stage(codes, lens)

        dec.gpt.generate_batch = keep_tokens
        dec.bark.generate_fine_batch = fine_stage
        dec.bark.model.register_forward_pre_hook(keep_window)
        dec._acoustic_stage = keep_fine

    @torch.no_grad()
    def load(self, weights: dict):
        """The benchmark's weights, in place of the program's (strict)."""
        if self.path == "encode":
            self.at.encoder.model.load_state_dict(weights["encoder"], strict=True)
            self.at.encoder.codebook.copy_(weights["codebook"])
            return
        dec = self.at.decoder
        dec.gpt.model.load_state_dict(weights["gpt"], strict=True)
        dec.bark.model.load_state_dict(weights["bark_fine"], strict=True)
        dec.acoustic_decoder.seanet.load_state_dict(weights["decoder"], strict=True)
        dec.acoustic_decoder.codebooks.copy_(weights["codebooks"])

    def set_precision(self, precision: str):
        """Switch the encoder's precision policy without new weights (the
        encode check's control runs the program at ``high``; decode's
        control is the reference's, ``decode_control``)."""
        self.at.encoder.set_precision(precision)

    def __call__(self, req):
        if self.path == "encode":
            return self.at.encoder(req.batch, np.asarray(req.lengths, np.int32))
        self._seen.clear()
        self.greedy = req.greedy
        self.at.decoder.top_k = 1 if req.greedy else self.top_k
        out = Answer(self.at.decode_batch(req.batch))
        fine = self._seen["fine"]
        out.tokens, out.window, out.lens = (self._seen[k] for k in ("tokens", "window", "lens"))
        out.fine = fine.cpu().numpy() if isinstance(fine, torch.Tensor) else np.asarray(fine)
        return out

    def close(self):
        self.at = None
