"""Decode: the window calls the program's ``AudioToken(...).decode_batch``
on a list of code or id sequences, from issue to int16 waveforms on the
host."""


def audio_seconds(cfg: dict, req, out) -> float:
    """Audio seconds a call returned: the samples of every waveform, at the
    decoder's rate (``decode_sampling_rate`` where it differs from the
    encoder's)."""
    return sum(w.shape[-1] for w in out) / cfg.get("decode_sampling_rate", cfg["sampling_rate"])


def check(ref, cfg: dict, weights, req, out, device) -> dict:
    """The reference's numbers for the program's answer ``out`` to ``req``."""
    return ref.decode_check(weights, cfg, req, out, device)
