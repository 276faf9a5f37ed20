"""Encode: the window calls the program's encoder on a batch of int16 PCM
rows with each row's length (``AudioToken(...).encoder(batch, lengths)``,
the call the corpus executor dispatches), from issue to int16 codes on the
host."""


def audio_seconds(cfg: dict, req, out) -> float:
    """Audio seconds a call encoded: each row's length, not the padding."""
    return sum(req.lengths) / cfg["sampling_rate"]


def check(ref, cfg: dict, weights, req, out, device) -> dict:
    """The reference's numbers for the program's answer ``out`` to ``req``."""
    return ref.encode_check(weights, cfg, req, out, device)
