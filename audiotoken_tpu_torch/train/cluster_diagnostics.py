"""Quantizer diagnostics: the distance from each embedding to its nearest
centroid, for real embeddings against norm-matched gaussian noise. A
codebook that fits the data sits much closer to real embeddings than to
noise (``separation`` = noise's median distance / the real one's).

Counterpart of ``audiotoken_tpu/train/cluster_diagnostics.py``; the
histogram needs ``matplotlib``, imported only when a plot is asked for.
"""

from typing import Dict, Optional

import numpy as np
import torch

from ..encoders import resolve_device
from ..logger import get_logger
from ..ops.lookup import nearest_centroid
from ..runtime.precision import get_policy

logger = get_logger(__name__, level="INFO")


def _distances(x: np.ndarray, centroids: np.ndarray, device):
    """(nearest index [N], distance to it [N]): the assignment on
    ``device`` in IEEE f32, the distances on the host as the JAX tool
    takes them."""
    dev = resolve_device(device)
    with get_policy("highest").numerics():
        idx = nearest_centroid(torch.from_numpy(x).to(dev),
                               torch.from_numpy(centroids).to(dev)).cpu().numpy()
    return idx, np.linalg.norm(x - centroids[idx], axis=-1)


def nearest_distance_stats(x, centroids, device="cuda") -> Dict[str, float]:
    """Stats of the nearest-centroid distance over x [N, D]."""
    x = np.asarray(x, np.float32)
    centroids = np.asarray(centroids, np.float32)
    idx, d = _distances(x, centroids, device)
    return {
        "mean": float(d.mean()),
        "p50": float(np.median(d)),
        "p90": float(np.percentile(d, 90)),
        "p99": float(np.percentile(d, 99)),
        "active_frac": float(len(np.unique(idx)) / len(centroids)),
    }


def compare_real_vs_random(embeddings, centroids, seed: int = 0,
                           plot_path: Optional[str] = None, device="cuda"):
    """{"real": stats, "random": stats, "separation": random p50 / real p50},
    the noise drawn from ``seed`` and scaled to each embedding's norm."""
    embeddings = np.asarray(embeddings, np.float32)
    centroids = np.asarray(centroids, np.float32)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(embeddings.shape).astype(np.float32)
    # match per-vector norms, so the comparison isolates direction structure
    noise *= (np.linalg.norm(embeddings, axis=-1, keepdims=True)
              / np.maximum(np.linalg.norm(noise, axis=-1, keepdims=True), 1e-9))
    real = nearest_distance_stats(embeddings, centroids, device)
    rand = nearest_distance_stats(noise, centroids, device)
    result = {"real": real, "random": rand,
              "separation": rand["p50"] / max(real["p50"], 1e-9)}
    logger.info("cluster diagnostics: %s", result)
    if plot_path:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure(figsize=(8, 4))
            plt.hist(_distances(embeddings, centroids, device)[1], bins=100, alpha=0.6,
                     label="real embeddings", density=True)
            plt.hist(_distances(noise, centroids, device)[1], bins=100, alpha=0.6,
                     label="norm-matched noise", density=True)
            plt.xlabel("distance to nearest centroid")
            plt.legend()
            plt.tight_layout()
            plt.savefig(plot_path)
            plt.close()
            logger.info("histogram saved to %s", plot_path)
        except Exception as e:  # noqa: BLE001  (the plot is optional; the stats stand)
            logger.warning("plotting skipped: %s", e)
    return result


if __name__ == "__main__":
    from argparse import ArgumentParser

    p = ArgumentParser(description="Compare centroid distances: real embeddings vs noise")
    p.add_argument("--tokenizer", choices=["semantic_s", "semantic_m"], required=True)
    p.add_argument("--indir", required=True, help="directory of audio files")
    p.add_argument("--weights", default="artifacts")
    p.add_argument("--max_files", type=int, default=16)
    p.add_argument("--plot", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()

    from ..io.audio import find_audio_files, read_audio
    from .vq_train import _encoder

    enc, _cfg = _encoder(a.tokenizer, a.weights, a.device)
    centroids = (enc.centroids if a.tokenizer == "semantic_s" else enc.codebook).cpu().numpy()
    embs = []
    for f in find_audio_files(a.indir)[: a.max_files]:
        wav = read_audio(f, 16_000)
        if hasattr(enc, "host_transform"):
            wav = enc.host_transform(wav)
        feats = enc(wav.astype(np.float32))
        embs.append(feats.reshape(-1, feats.shape[-1]))
    compare_real_vs_random(np.concatenate(embs), centroids, plot_path=a.plot, device=a.device)
