"""Leaf converters shared by the converters of every model."""

import numpy as np


def linear(sd, name: str, transpose: bool = True):
    """torch linear ``{name}.weight`` [out, in] -> {kernel [in, out], bias or
    None}; ``transpose=False`` for weights stored [in, out] already (HF
    GPT-2's Conv1D)."""
    w = np.asarray(sd[f"{name}.weight"], np.float32)
    b = sd.get(f"{name}.bias")
    return {"kernel": w.T if transpose else w,
            "bias": None if b is None else np.asarray(b, np.float32)}


def layer_norm(sd, name: str):
    """``{name}.weight`` / ``.bias`` -> {scale, bias or None}."""
    b = sd.get(f"{name}.bias")
    return {"scale": np.asarray(sd[f"{name}.weight"], np.float32),
            "bias": None if b is None else np.asarray(b, np.float32)}


def strip_compile_prefix(sd):
    """Drop torch.compile's ``_orig_mod.`` key prefix."""
    return {k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k: v
            for k, v in sd.items()}
