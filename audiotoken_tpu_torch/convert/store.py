"""Converted-weight store: the flat ``.npz`` form of a parameter tree.

Reads the files that ``audiotoken_tpu.convert.store.save_params`` writes:
keys are ``a/b/0#/c`` paths (``#`` marks a list index) and the reserved
``__none_keys__`` entry lists the paths whose leaf is ``None``.
"""

from typing import Any, Dict

import numpy as np

_NONE_KEYS = "__none_keys__"


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.endswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][:-1]))
            return [fix(v) for _, v in items]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def load_params(path: str) -> Any:
    """Flat npz -> nested dicts and lists of numpy arrays."""
    with np.load(path) as z:
        flat: Dict[str, Any] = {k: z[k] for k in z.files if k != _NONE_KEYS}
        if _NONE_KEYS in z.files:
            for k in z[_NONE_KEYS]:
                flat[str(k)] = None
    return _unflatten(flat)
