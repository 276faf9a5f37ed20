"""Converted-weight store: the flat ``.npz`` form of a parameter tree.

Keys are ``a/b/0#/c`` paths (``#`` marks a list index) and the reserved
``__none_keys__`` entry lists the paths whose leaf is ``None``: the layout
``audiotoken_tpu.convert.store`` writes and reads, so each package reads the
other's files. The store needs numpy only.
"""

import os
from typing import Any, Dict

import numpy as np

#: reserved npz key listing the paths whose leaf is None (bias-free linears
#: and LayerNorms of the GPT, Bark-fine and the w2v-BERT pointwise convs)
_NONE_KEYS = "__none_keys__"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and lists -> {path: leaf}; None leaves stay None."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}#/"))
    elif tree is None:
        out[prefix[:-1]] = None
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


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


def save_params(path: str, params: Any) -> None:
    """Nested dicts and lists of arrays (numpy, or CPU tensors) -> flat npz."""
    flat = _flatten(params)
    none_keys = sorted(k for k, v in flat.items() if v is None)
    arrays = {k: v for k, v in flat.items() if v is not None}
    if none_keys:
        arrays[_NONE_KEYS] = np.asarray(none_keys)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_params(path: str) -> Any:
    """Flat npz -> nested dicts and lists of numpy arrays."""
    with np.load(path) as z:
        flat: Dict[str, Any] = {k: z[k] for k in z.files if k != _NONE_KEYS}
        if _NONE_KEYS in z.files:
            for k in z[_NONE_KEYS]:
                flat[str(k)] = None
    return _unflatten(flat)


def state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    """torch state dict -> plain numpy dict (accepts tensors or arrays);
    bf16 tensors, which numpy lacks, widen to f32 exactly."""
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu()
            if str(v.dtype) == "torch.bfloat16":
                v = v.float()
            v = v.numpy()
        out[k] = np.asarray(v)
    return out
