"""Residual vector quantization (EnCodec style).

Counterpart of ``audiotoken_tpu/nn/rvq.py``. On a CUDA tensor the encode
side's codebook cascade is kernel K3 (``ops/rvq.py``); on a CPU tensor it
is K3's plain PyTorch version, which computes ``nn/rvq.py:rvq_encode``'s
function. The decode side (:func:`rvq_decode`) is a sum of gathers.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.rvq import rvq_encode


@dataclass(frozen=True)
class RVQConfig:
    num_quantizers: int = 32
    codebook_size: int = 1024
    dim: int = 128
    frame_rate: int = 75

    def num_quantizers_for_bandwidth(self, bandwidth: float) -> int:
        """bandwidth (kbps) -> number of codebooks; EnCodec's formula
        (bw*1000 / (log2(codebook_size) * frame_rate))."""
        bw_per_q = math.log2(self.codebook_size) * self.frame_rate
        if bandwidth is None or bandwidth <= 0:
            return self.num_quantizers
        return int(max(1, math.floor(bandwidth * 1000 / bw_per_q)))


def rvq_decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codebooks [K, C, D], codes [B, num_q, T] -> embeddings [B, T, D]: the
    sum of the first num_q codebooks' rows, added in codebook order."""
    codes = codes.long()
    out = codebooks[0][codes[:, 0]]
    for k in range(1, codes.shape[1]):
        out = out + codebooks[k][codes[:, k]]
    return out


def init_codebooks(rng, cfg: RVQConfig) -> np.ndarray:
    return rng.standard_normal((cfg.num_quantizers, cfg.codebook_size, cfg.dim)).astype(np.float32)


class ResidualVQ(nn.Module):
    """Latents [B, T, D] -> codes [B, num_quantizers, T] int32 through the
    first ``num_quantizers`` codebooks of ``codebooks`` [K, C, D]."""

    def __init__(self, codebooks: torch.Tensor, num_quantizers: int):
        super().__init__()
        if not 1 <= num_quantizers <= codebooks.shape[0]:
            raise ValueError(f"num_quantizers {num_quantizers} outside 1..{codebooks.shape[0]}")
        self.register_buffer("codebooks", codebooks.float().contiguous())
        self.num_quantizers = num_quantizers

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return rvq_encode(self.codebooks, z.float().contiguous(), self.num_quantizers)
