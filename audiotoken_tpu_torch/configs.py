"""Tokenizer registry and the encoders' configurations.

Counterpart of ``audiotoken_tpu/configs.py`` for the ported encoders
(acoustic and semantic_m): semantic_s is named here so that
:class:`Tokenizers` keeps its three members, but its config arrives with
its slice of the port.
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


@dataclass(frozen=True)
class Wav2VecBertConfig(EncoderConfig):
    """Trimmed 21-layer w2v-BERT-2.0, layer 19 + 2048-entry VQ."""

    model_id: str = "cmeraki/audiotoken/w2vbert2_l21"
    model_sample_rate: int = 16_000
    model_token_rate: int = 50
    pad_token: Optional[int] = 0
    output_layer: int = 19
    num_clusters: int = 2048
    hidden_dim: int = 1024


# Bandwidth (kbps) <-> codebook ladder of EnCodec 24 kHz.
_NQ_TO_BW = {2: 1.5, 4: 3.0, 8: 6.0, 16: 12.0}


def num_codebooks_to_bandwidth(num_codebooks: int) -> float:
    return _NQ_TO_BW[int(num_codebooks)]
