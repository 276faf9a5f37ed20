"""AudioToken facade, encode side of acoustic and semantic_m.

Counterpart of ``audiotoken_tpu/api.py:AudioToken``: same constructor
arguments (plus an explicit torch ``device``, default CUDA) and the same
``encode`` surface, returning numpy int16 tokens [1, K, T] (K = 1 for
semantic_m). What later slices of the port bring raises
``NotImplementedError`` until then.
"""

import os
from pathlib import Path
from typing import Optional, Union

import numpy as np

from .configs import (
    AcousticEncoderConfig,
    Tokenizers,
    Wav2VecBertConfig,
    num_codebooks_to_bandwidth,
)
from .encoders import AcousticEncoder, Wav2VecBertEncoder, resolve_device

ArrayLike = Union[np.ndarray, "os.PathLike[str]", Path, str]


class AudioToken:
    """Tokenize audio to discrete ids.

    Args:
        tokenizer: :class:`Tokenizers`; ``acoustic`` and ``semantic_m`` are
            ported so far.
        device: torch device, default ``"cuda"`` (which raises when no GPU
            is present); ``"cpu"`` runs the kernels' plain versions.
        num_codebooks: acoustic codebook count in {2, 4, 8, 16}.
        weights: ``"random"`` (seeded random init) or a directory holding a
            converted ``acoustic.npz`` (``w2vbert.npz`` + ``w2vbert_vq.npz``
            for semantic_m).
        precision: ``"highest"`` (IEEE f32, token parity), ``"high"`` or
            ``"default"`` (TF32 allowed), ``"bfloat16"`` (acoustic only).
    """

    def __init__(
        self,
        tokenizer: Tokenizers,
        device="cuda",
        num_codebooks: int = 16,
        weights: str = "artifacts",
        precision: str = "highest",
        seed: int = 0,
    ):
        self.tokenizer_name = Tokenizers(tokenizer)
        if self.tokenizer_name == Tokenizers.semantic_s:
            raise NotImplementedError(
                "semantic_s: HuBERT encode comes with later slices of the port"
            )
        if num_codebooks not in (2, 4, 8, 16):
            raise ValueError(f"num_codebooks must be one of [2, 4, 8, 16], got {num_codebooks}")
        self.device = resolve_device(device)
        self.num_codebooks = num_codebooks
        self.weights = weights
        self.precision = precision
        self.seed = seed
        if self.tokenizer_name == Tokenizers.acoustic:
            self.model_config = AcousticEncoderConfig(
                bandwidth=num_codebooks_to_bandwidth(num_codebooks)
            )
        else:
            self.model_config = Wav2VecBertConfig()
        self.model_sample_rate = self.model_config.model_sample_rate
        self.encoder = None

    def load_encoder(self):
        if self.encoder is None:
            acoustic = self.tokenizer_name == Tokenizers.acoustic
            self.encoder = (AcousticEncoder if acoustic else Wav2VecBertEncoder)(
                config=self.model_config,
                weights=self.weights,
                precision=self.precision,
                seed=self.seed,
                device=self.device,
            )

    def encode(
        self,
        audio: ArrayLike,
        chunk_size: Optional[float] = None,
        overlap: float = 0.0,
    ) -> np.ndarray:
        """Encode one audio (array [1, T] at the model rate, or a WAV path)
        to tokens [1, K, T] int16.

        With ``chunk_size`` (seconds) a file is encoded chunk by chunk;
        ``overlap`` (seconds, rounded to whole token hops) prepends that much
        left context to every chunk and discards its tokens.
        """
        if isinstance(audio, (bytes, bytearray)):
            raise NotImplementedError(
                "encoding bytes needs the native libav decoder, which comes "
                "with the facade slice of the port"
            )
        self.load_encoder()
        if isinstance(audio, np.ndarray):
            if audio.ndim != 2 or audio.shape[0] != 1:
                raise ValueError(f"audio must be [1, T] mono, got {audio.shape}")
            return self._encode_single(audio)
        if not isinstance(audio, (os.PathLike, Path, str)):
            raise ValueError(f"Unsupported input type {type(audio)}")

        from .io.audio import process_audio_chunks, read_audio

        if chunk_size is None:
            return self._encode_single(read_audio(audio, self.model_sample_rate))

        sr = self.model_sample_rate
        hop = sr // self.model_config.model_token_rate
        carry_len = int(round(overlap * sr / hop)) * hop if overlap > 0 else 0
        carry = np.zeros((1, 0), np.float32)
        out = []
        for chunk, _name in process_audio_chunks(str(audio), None, sr, chunk_size):
            ext = np.concatenate([carry, chunk], axis=-1)
            toks = self._encode_single(ext)
            out.append(toks[:, :, carry.shape[-1] // hop :])
            if carry_len:
                carry = ext[:, -carry_len:]
        return np.concatenate(out, axis=-1)

    def _encode_single(self, audio: np.ndarray) -> np.ndarray:
        # all-valid input, passed as full lengths
        return self.encoder(audio, np.full(audio.shape[0], audio.shape[-1], np.int32))

    def encode_batch_files(self, *args, **kwargs):
        raise NotImplementedError(
            "encode_batch_files: the corpus executor comes with the facade slice of the port"
        )

    def decode(self, *args, **kwargs):
        raise NotImplementedError("decode: the decoders come with later slices of the port")
