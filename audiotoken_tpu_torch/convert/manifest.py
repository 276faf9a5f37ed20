"""Structural manifests of the converted weight trees.

A mis-staged or truncated checkpoint would otherwise fail only deep inside
a forward pass. ``manifests.json`` pins each of the eight trees' structure,
flattened key -> [shape, dtype], so a conversion fails where it happens.
The ground truth is the seeded random trees (``weights.py``'s ``"random"``
branches), which build the same architectures as the converters.
``generate_manifests()`` rebuilds the file; the tests hold it equal to the
committed copy and to ``audiotoken_tpu``'s.

Counterpart of ``audiotoken_tpu/convert/manifest.py``.
"""

import json
import os
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from .store import _flatten

MANIFESTS_PATH = os.path.join(os.path.dirname(__file__), "manifests.json")


def tree_manifest(params: Any) -> Dict[str, List]:
    """Flattened key -> [shape list, dtype string] for a parameter tree."""
    out = {}
    for key, leaf in _flatten(params).items():
        if leaf is None:
            out[key] = [None, "none"]
        else:
            arr = np.asarray(leaf)
            out[key] = [list(arr.shape), str(arr.dtype)]
    return out


def _random_trees() -> Iterator[Tuple[str, Any]]:
    """The eight weight-store trees, seed-0 random, one at a time (the
    full-width trees together hold several GB)."""
    from .. import weights as weight_store

    yield "acoustic", weight_store.get_acoustic_params("random", 0)
    hub, km = weight_store.get_hubert_params("random", 0)
    yield "hubert", hub
    yield "hubert_kmeans", {"centroids": km}
    del hub, km
    w2v, vq = weight_store.get_w2vbert_params("random", 0)
    yield "w2vbert", w2v
    yield "w2vbert_vq", {"codebook": vq}
    del w2v, vq
    for key in ("gpt_semantic_s_en", "gpt_semantic_m_hi"):
        yield key, weight_store.get_semantic_gpt_params("random", 0, key, 53_376)[0]
    yield "bark_fine", weight_store.get_bark_fine_params("random", 0)[0]


def generate_manifests() -> Dict[str, Dict[str, List]]:
    return {name: tree_manifest(tree) for name, tree in _random_trees()}


def load_manifests() -> Dict[str, Dict[str, List]]:
    with open(MANIFESTS_PATH) as f:
        return json.load(f)


def validate_tree(params: Any, name: str, manifests=None) -> None:
    """Raise ValueError listing every difference (missing or extra keys,
    shapes, dtypes) between ``params`` and the manifest of ``name``."""
    expected = (manifests or load_manifests())[name]
    got = tree_manifest(params)
    problems: List[str] = []
    for key in sorted(set(expected) - set(got)):
        problems.append(f"missing key: {key} (expected {expected[key]})")
    for key in sorted(set(got) - set(expected)):
        problems.append(f"unexpected key: {key} ({got[key]})")
    for key in sorted(set(got) & set(expected)):
        if got[key] != expected[key]:
            problems.append(f"mismatch at {key}: got {got[key]}, expected {expected[key]}")
    if problems:
        head = problems[:20]
        more = f"\n  ... and {len(problems) - 20} more" if len(problems) > 20 else ""
        raise ValueError(
            f"converted '{name}' tree does not match its manifest "
            f"({len(problems)} problem(s)):\n  " + "\n  ".join(head) + more)
