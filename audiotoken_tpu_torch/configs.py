"""Tokenizer registry, the encoders' and decoders' configurations, and the
joint vocabulary of the semantic -> acoustic GPT.

Counterpart of ``audiotoken_tpu/configs.py``: acoustic, semantic_s and
semantic_m encode, acoustic and semantic decode (and Mimi encode, which
the JAX package does not have), the corpus path (the file
extensions it reads, and ``AudioConfig``, the metadata of one chunk) and
the upstream checkpoints (``Artifact``, ``ARTIFACTS``).
"""

import os
from dataclasses import dataclass, field
from enum import Enum
from math import ceil
from typing import Dict, Optional, Tuple

AUDIO_EXTS: Tuple[str, ...] = (".mp3", ".flac", ".wav", ".ogg", ".opus")
TAR_EXTS: Tuple[str, ...] = (".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tbz", ".tar.xz", ".txz")
ZIP_EXTS: Tuple[str, ...] = (".zip", ".ZIP")


class COMMONS(str, Enum):
    """Modalities and languages."""

    SEMANTIC = "semantic"
    ACOUSTIC = "acoustic"
    TEXT = "text"
    HI = "hi"
    EN = "en"


class Tokenizers(str, Enum):
    """Supported tokenizer families."""

    acoustic = "acoustic"
    semantic_s = "semantic_s"
    semantic_m = "semantic_m"
    mimi = "mimi"


@dataclass(frozen=True)
class Artifact:
    """A pointer to an upstream checkpoint file, resolved on first use.

    Resolution order, under ``root`` (default ``$AUDIOTOKEN_ARTIFACTS``):
      1. ``<root>/<local_name or basename>``, then
         ``<root>/<repo_id with / as __>/<filename>``;
      2. ``huggingface_hub.hf_hub_download`` when that package imports and
         the network allows it.
    """

    repo_id: str
    filename: str
    revision: Optional[str] = None
    local_name: Optional[str] = None

    def resolve(self, root: Optional[str] = None) -> str:
        name = self.local_name or os.path.basename(self.filename)
        if root is None:
            root = os.environ.get("AUDIOTOKEN_ARTIFACTS", "")
        if root:
            for cand in (os.path.join(root, name),
                         os.path.join(root, self.repo_id.replace("/", "__"), self.filename)):
                if os.path.exists(cand):
                    return cand
        try:
            from huggingface_hub import hf_hub_download  # type: ignore

            return hf_hub_download(repo_id=self.repo_id, filename=self.filename,
                                   revision=self.revision)
        except Exception as e:  # noqa: BLE001  (ImportError, or any hub failure)
            raise FileNotFoundError(
                f"Artifact {self.repo_id}/{self.filename} not found locally "
                f"(set AUDIOTOKEN_ARTIFACTS to a directory containing "
                f"'{name}') and hub download failed: {e}"
            ) from e


# Pinned upstream checkpoints.
_REV = "5d74db4ca565e348e9d15fb782f5589cd7d0f0c0"

ARTIFACTS: Dict[str, Artifact] = {
    "hubert_kmeans": Artifact(
        repo_id="voidful/mhubert-base",
        filename="mhubert_base_vp_en_es_fr_it3_L11_km1000.bin",
    ),
    "w2vbert_l21_weights": Artifact(
        repo_id="cmeraki/audiotoken",
        filename="w2vbert2_l21/model.safetensors",
        revision=_REV,
    ),
    "w2vbert_vq": Artifact(
        repo_id="cmeraki/audiotoken",
        filename=(
            "semantic_detokenizer/semantic_m/vq_quantizer/"
            "run4__quantizer__L19_C2048_ckpt8000.pkl"
        ),
        revision=_REV,
    ),
    "gpt_semantic_s_en": Artifact(
        repo_id="cmeraki/audiotoken",
        filename="semantic_detokenizer/semantic_s/hubert_semantic_acoustic_gpt_en.pt",
        revision=_REV,
    ),
    "gpt_semantic_m_hi": Artifact(
        repo_id="cmeraki/audiotoken",
        filename="semantic_detokenizer/semantic_m/w2vbert2_semantic_acoustic_gpt_hi.pt",
        revision=_REV,
    ),
    "mimi": Artifact(repo_id="kyutai/mimi", filename="model.safetensors"),
}


@dataclass(frozen=True)
class EncoderConfig:
    model_id: str
    model_sample_rate: int
    model_token_rate: float  # tokens a second: 12.5 for Mimi
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
class AcousticDecoderConfig(AcousticEncoderConfig):
    """Acoustic decode defaults to 8 codebooks (6 kbps)."""

    bandwidth: float = 6.0


@dataclass(frozen=True)
class MimiEncoderConfig(EncoderConfig):
    """Mimi (kyutai/mimi) encode: 12.5 code frames a second, the first
    ``num_codebooks`` of 32 (1 semantic, then acoustic)."""

    model_id: str = "kyutai/mimi"
    model_sample_rate: int = 24_000
    model_token_rate: float = 12.5
    pad_token: Optional[int] = 0
    num_codebooks: int = 32
    weights_artifact: str = "mimi"


@dataclass(frozen=True)
class HubertEncoderConfig(EncoderConfig):
    """mHuBERT-base layer 11 + 1000-centroid k-means (semantic_s)."""

    model_id: str = "voidful/mhubert-base"
    model_sample_rate: int = 16_000
    model_token_rate: int = 50
    pad_token: Optional[int] = 0
    output_layer: int = 11
    num_clusters: int = 1000
    hidden_dim: int = 768
    quantizer_artifact: str = "hubert_kmeans"


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
    quantizer_artifact: str = "w2vbert_vq"
    weights_artifact: str = "w2vbert_l21_weights"


@dataclass(frozen=True)
class VocabLayout:
    """Joint TEXT + SEMANTIC + ACOUSTIC vocabulary with special tokens:
    offsets per modality, PAD/INFER/STOP ids, and the vocabulary size
    rounded up to a multiple of 64 (53,376)."""

    text_size: int = 50_257
    semantic_size: int = 1_000
    acoustic_size: int = 2_048

    @property
    def offsets(self) -> Dict[COMMONS, int]:
        return {
            COMMONS.TEXT: 0,
            COMMONS.SEMANTIC: self.text_size,
            COMMONS.ACOUSTIC: self.text_size + self.semantic_size,
        }

    @property
    def max_token_value(self) -> int:
        return self.text_size + self.semantic_size + self.acoustic_size

    @property
    def pad_token(self) -> Dict[COMMONS, int]:
        m = self.max_token_value
        return {COMMONS.TEXT: 50_256, COMMONS.SEMANTIC: m + 2, COMMONS.ACOUSTIC: m + 3}

    @property
    def infer_token(self) -> Dict[COMMONS, int]:
        m = self.max_token_value
        return {COMMONS.TEXT: m + 4, COMMONS.SEMANTIC: m + 5, COMMONS.ACOUSTIC: m + 6}

    @property
    def stop_token(self) -> Dict[COMMONS, int]:
        m = self.max_token_value
        return {COMMONS.TEXT: m + 7, COMMONS.SEMANTIC: m + 8, COMMONS.ACOUSTIC: m + 9}

    @property
    def vocab_size(self) -> int:
        return (max(self.stop_token.values()) // 64 + 1) * 64


@dataclass(frozen=True)
class SemanticDecoderConfig:
    """Semantic -> audio decoder: which GPT checkpoint per language, the
    source truncation, and the coarse codebook layout."""

    supported_languages: Tuple[COMMONS, ...] = (COMMONS.EN,)
    model_artifacts: Tuple[Tuple[COMMONS, str], ...] = ((COMMONS.EN, "gpt_semantic_s_en"),)
    max_source_tokens: int = 256
    coarse_codebooks: int = 2
    per_codebook_size: int = 1024
    vocab: VocabLayout = field(default_factory=VocabLayout)


HubertDecoderConfig = SemanticDecoderConfig  # semantic_s: EN, 256 source tokens

Wav2VecBertDecoderConfig = SemanticDecoderConfig(
    supported_languages=(COMMONS.HI,),
    model_artifacts=((COMMONS.HI, "gpt_semantic_m_hi"),),
    max_source_tokens=250,
)


@dataclass
class AudioConfig:
    """Metadata for one audio file or one chunk of it.

    ``length_tokens`` = ceil(length_seconds * model_token_rate).
    """

    file_name: str
    start_idx: Optional[int] = None
    end_idx: Optional[int] = None
    length_seconds: Optional[float] = None
    length_samples: Optional[int] = None
    model_token_rate: Optional[float] = None

    @property
    def length_tokens(self) -> int:
        if self.model_token_rate is None or self.length_seconds is None:
            raise ValueError("model_token_rate and length_seconds are required")
        return ceil(self.length_seconds * self.model_token_rate)

    @property
    def chunk_length_tokens(self) -> int:
        """Token count of THIS chunk (start_idx..end_idx), which the token
        sink trims each chunk to; the whole file's ``length_tokens`` would
        be wrong for every chunk but a file's only one."""
        if self.model_token_rate is None:
            raise ValueError("model_token_rate is required")
        if self.start_idx is None or self.end_idx is None:
            return self.length_tokens
        if not self.length_samples or not self.length_seconds:
            raise ValueError("length_samples and length_seconds are required")
        sr = self.length_samples / self.length_seconds
        seconds = (self.end_idx - self.start_idx) / sr
        return ceil(seconds * self.model_token_rate)


# Bandwidth (kbps) <-> codebook ladder of EnCodec 24 kHz.
_BW_TO_NQ = {1.5: 2, 3.0: 4, 6.0: 8, 12.0: 16, 24.0: 32}
_NQ_TO_BW = {2: 1.5, 4: 3.0, 8: 6.0, 16: 12.0}


def bandwidth_to_num_codebooks(bandwidth: float) -> int:
    return _BW_TO_NQ[float(bandwidth)]


def num_codebooks_to_bandwidth(num_codebooks: int) -> float:
    return _NQ_TO_BW[int(num_codebooks)]
