"""Semantic quantizer artifacts -> centroid and codebook matrices.

Counterpart of ``audiotoken_tpu/convert/quantizers.py``:
  - an sklearn k-means (semantic_s's mHuBERT L11 km1000, a joblib pickle)
    -> centroids [n_clusters, dim];
  - a vector-quantize-pytorch ``VectorQuantize`` state dict (semantic_m's
    L19 C2048) -> codebook [codebook_size, dim].
"""

import numpy as np


def convert_kmeans(path_or_obj) -> np.ndarray:
    """k-means object with ``cluster_centers_``, or the path of its joblib
    pickle -> centroids [n_clusters, dim] float32. A path needs ``joblib``
    (and the sklearn that pickled it)."""
    if isinstance(path_or_obj, (str, bytes)):
        try:
            import joblib
        except ImportError as e:
            raise ImportError(
                "convert_kmeans: reading a k-means pickle needs the 'joblib' package "
                "(and 'scikit-learn'); install them, or pass an object with "
                "cluster_centers_") from e
        km = joblib.load(path_or_obj)
    else:
        km = path_or_obj
    return np.asarray(km.cluster_centers_, dtype=np.float32)


def convert_vq(state_dict) -> np.ndarray:
    """VectorQuantize state dict -> codebook [codebook_size, dim] float32:
    the ``_codebook.embed``, ``codebook.embed`` or ``embed`` entry, of
    head 0 when it has a leading heads dim."""
    for key in ("_codebook.embed", "codebook.embed", "embed"):
        if key in state_dict:
            embed = state_dict[key]
            break
    else:
        raise KeyError(f"no codebook key in VQ state dict; keys: {list(state_dict)[:10]}")
    if hasattr(embed, "detach"):
        embed = embed.detach().cpu().numpy()
    embed = np.asarray(embed, dtype=np.float32)
    if embed.ndim == 3:  # [heads, C, D]
        embed = embed[0]
    return embed
