"""Audio quality metrics: SI-SNR, the round-trip fidelity metric of the
acoustic codec, and plain SNR. Counterpart of ``audiotoken_tpu/metrics.py``
(numpy, float64)."""

import numpy as np


def _aligned(estimate, reference):
    est = np.asarray(estimate, np.float64)
    ref = np.asarray(reference, np.float64)
    n = min(est.shape[-1], ref.shape[-1])
    return est[..., :n], ref[..., :n]


def si_snr(estimate: np.ndarray, reference: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant signal-to-noise ratio in dB over the last axis
    (cut to the shorter of the two), averaged over the others."""
    est, ref = _aligned(estimate, reference)
    est = est - est.mean(axis=-1, keepdims=True)
    ref = ref - ref.mean(axis=-1, keepdims=True)
    proj = (np.sum(est * ref, axis=-1, keepdims=True)
            / (np.sum(ref**2, axis=-1, keepdims=True) + eps)) * ref
    noise = est - proj
    ratio = np.sum(proj**2, axis=-1) / (np.sum(noise**2, axis=-1) + eps)
    return float(np.mean(10 * np.log10(ratio + eps)))


def snr(estimate: np.ndarray, reference: np.ndarray, eps: float = 1e-8) -> float:
    """Plain signal-to-noise ratio in dB, as :func:`si_snr` without the
    mean removal and the projection."""
    est, ref = _aligned(estimate, reference)
    ratio = np.sum(ref**2, axis=-1) / (np.sum((est - ref) ** 2, axis=-1) + eps)
    return float(np.mean(10 * np.log10(ratio + eps)))
