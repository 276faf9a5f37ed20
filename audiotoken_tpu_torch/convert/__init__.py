"""Checkpoint converters and the weight store.

Each converter takes a torch state dict (as numpy arrays) and returns the
parameter tree of ``weights.py`` (conv kernels [K, C_in, C_out], linear
kernels [in, out]): weight norm folded, transposes applied, compile
prefixes stripped. ``store`` writes and reads the trees as flat ``.npz``;
``safetensors`` reads that format without its package.
"""

from .store import load_params, save_params, state_dict_to_numpy

__all__ = ["load_params", "save_params", "state_dict_to_numpy"]
