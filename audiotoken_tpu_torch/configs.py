"""Tokenizer registry and the acoustic encoder's configuration.

Counterpart of ``audiotoken_tpu/configs.py``, acoustic part only: the
semantic tokenizers are named here so that :class:`Tokenizers` keeps its
three members, but their configs arrive with their slices of the port.
"""

from dataclasses import dataclass
from enum import Enum
from typing import Optional


class Tokenizers(str, Enum):
    """Supported tokenizer families."""

    acoustic = "acoustic"
    semantic_s = "semantic_s"
    semantic_m = "semantic_m"


@dataclass(frozen=True)
class EncoderConfig:
    model_id: str
    model_sample_rate: int
    model_token_rate: int
    pad_token: Optional[int]


@dataclass(frozen=True)
class AcousticEncoderConfig(EncoderConfig):
    """EnCodec 24 kHz acoustic tokenizer."""

    model_id: str = "encodec_24khz"
    model_sample_rate: int = 24_000
    model_token_rate: int = 75
    pad_token: Optional[int] = 0
    bandwidth: float = 12.0


# Bandwidth (kbps) <-> codebook ladder of EnCodec 24 kHz.
_NQ_TO_BW = {2: 1.5, 4: 3.0, 8: 6.0, 16: 12.0}


def num_codebooks_to_bandwidth(num_codebooks: int) -> float:
    return _NQ_TO_BW[int(num_codebooks)]
