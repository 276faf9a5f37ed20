"""AudioToken facade: encode and decode for acoustic, semantic_s and
semantic_m.

Counterpart of ``audiotoken_tpu/api.py:AudioToken``: same constructor
arguments (plus an explicit torch ``device``, default CUDA), the same
``encode`` surface (an array, a path, or the bytes of an audio file),
returning numpy int16 tokens [1, K, T] (K = 1 for the semantic
tokenizers), ``encode_batch_files`` for a corpus, and ``decode`` /
``decode_batch`` back to waveforms.
"""

import os
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from .configs import (
    AcousticDecoderConfig,
    AcousticEncoderConfig,
    HubertEncoderConfig,
    Tokenizers,
    Wav2VecBertConfig,
    num_codebooks_to_bandwidth,
)
from .encoders import AcousticEncoder, HubertEncoder, Wav2VecBertEncoder, mesh_device

_ENCODERS = {
    Tokenizers.acoustic: AcousticEncoder,
    Tokenizers.semantic_s: HubertEncoder,
    Tokenizers.semantic_m: Wav2VecBertEncoder,
}

ArrayLike = Union[np.ndarray, "os.PathLike[str]", Path, str, bytes]


class AudioToken:
    """Tokenize audio to discrete ids.

    Args:
        tokenizer: :class:`Tokenizers`: ``acoustic``, ``semantic_s`` or
            ``semantic_m`` (encode and decode).
        device: torch device, default ``"cuda"`` (which raises when no GPU
            is present); ``"cpu"`` runs the kernels' plain versions.
        num_codebooks: acoustic codebook count in {2, 4, 8, 16}.
        weights: ``"artifacts"`` (the upstream checkpoints, converted on
            the fly: staged in ``$AUDIOTOKEN_ARTIFACTS``, else from the hub
            where ``transformers`` imports), ``"random"`` (seeded random
            init) or a directory holding a converted ``acoustic.npz``
            (``hubert.npz`` + ``hubert_kmeans.npz`` for semantic_s,
            ``w2vbert.npz`` + ``w2vbert_vq.npz`` for semantic_m; the
            decoders' ``gpt_semantic_*.npz`` and ``bark_fine.npz``), as
            ``python -m audiotoken_tpu_torch.cli convert`` writes it.
        precision: ``"highest"`` (IEEE f32, token parity), ``"high"`` or
            ``"default"`` (TF32 in cuBLAS and cuDNN), ``"bfloat16"`` (bf16
            where the JAX package computes in bf16, TF32 elsewhere);
            semantic_m also takes ``"mixed"``: ``"high"`` with the stages
            of ``runtime/precision.py:W2VBERT_MIXED_OVERRIDES`` in IEEE f32.
        mesh: a ``parallel.mesh.Mesh`` (``make_mesh``): the encoder runs data
            parallel over its "dp" axis on the mesh's device, and every rank
            must make the same calls. The decoders take none, as in JAX.
    """

    def __init__(
        self,
        tokenizer: Tokenizers,
        device="cuda",
        num_codebooks: int = 16,
        weights: str = "artifacts",
        precision: str = "highest",
        seed: int = 0,
        mesh=None,
    ):
        self.tokenizer_name = Tokenizers(tokenizer)
        if num_codebooks not in (2, 4, 8, 16):
            raise ValueError(f"num_codebooks must be one of [2, 4, 8, 16], got {num_codebooks}")
        self.device = mesh_device(device, mesh)
        self.mesh = mesh
        self.num_codebooks = num_codebooks
        self.weights = weights
        self.precision = precision
        self.seed = seed
        if self.tokenizer_name == Tokenizers.acoustic:
            self.model_config = AcousticEncoderConfig(
                bandwidth=num_codebooks_to_bandwidth(num_codebooks)
            )
        elif self.tokenizer_name == Tokenizers.semantic_s:
            self.model_config = HubertEncoderConfig()
        else:
            self.model_config = Wav2VecBertConfig()
        self.model_sample_rate = self.model_config.model_sample_rate
        self.encoder = None
        self.decoder = None

    def load_encoder(self):
        if self.encoder is None:
            self.encoder = _ENCODERS[self.tokenizer_name](
                config=self.model_config,
                weights=self.weights,
                precision=self.precision,
                seed=self.seed,
                device=self.device,
                mesh=self.mesh,
            )

    def encode(
        self,
        audio: ArrayLike,
        chunk_size: Optional[float] = None,
        overlap: float = 0.0,
    ) -> np.ndarray:
        """Encode one audio (array [1, T] at the model rate, a path, or the
        bytes of an audio file in any container the native libav decoder
        reads) to tokens [1, K, T] int16.

        With ``chunk_size`` (seconds) a file is encoded chunk by chunk;
        ``overlap`` (seconds, rounded to whole token hops) prepends that much
        left context to every chunk and discards its tokens.
        """
        self.load_encoder()
        if isinstance(audio, (bytes, bytearray)):
            from .io._native import NativeDecoder
            from .io.audio import convert_audio

            with NativeDecoder(bytes(audio)) as dec:
                wav, sr = dec.read_all(), dec.sample_rate
            return self._encode_single(convert_audio(wav, sr, self.model_sample_rate))
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
        transform = getattr(self.encoder, "host_transform", None)
        if transform is not None:  # semantic_s: per-utterance normalisation
            audio = transform(audio)
        # all-valid input, passed as full lengths
        return self.encoder(audio, np.full(audio.shape[0], audio.shape[-1], np.int32))

    def encode_batch_files(
        self,
        batch_size: int,
        outdir: Union[str, os.PathLike],
        chunk_size: float = 30,
        num_workers: int = 4,
        audio_files: Optional[List[Union[str, os.PathLike]]] = None,
        audio_dir: Optional[Union[str, os.PathLike]] = None,
        **kwargs,
    ) -> dict:
        """Tokenize a corpus: files -> fixed-shape batches of ``chunk_size``
        s segments -> the device -> one ``.npy`` per file in ``outdir``,
        idempotent across reruns (``runtime/executor.py``). Returns the
        summary dict (RTFx, batches, stage spans)."""
        self.load_encoder()
        from .runtime.executor import encode_batch_files

        return encode_batch_files(
            encoder=self.encoder,
            model_config=self.model_config,
            batch_size=batch_size,
            outdir=outdir,
            chunk_size=chunk_size,
            num_workers=num_workers,
            audio_files=audio_files,
            audio_dir=audio_dir,
            **kwargs,
        )

    def load_decoder(self, **kwargs):
        """Build the decoder once; ``kwargs`` go to its constructor
        (``AcousticDecoder``, ``HubertDecoder`` or ``Wav2VecBertDecoder``)."""
        if self.decoder is not None:
            return
        from . import decoders

        common = dict(weights=self.weights, precision=self.precision, seed=self.seed,
                      device=self.device)
        if self.tokenizer_name == Tokenizers.acoustic:
            cfg = AcousticDecoderConfig(bandwidth=num_codebooks_to_bandwidth(self.num_codebooks))
            self.decoder = decoders.AcousticDecoder(config=cfg, **common, **kwargs)
        elif self.tokenizer_name == Tokenizers.semantic_s:
            self.decoder = decoders.HubertDecoder(**common, **kwargs)
        else:
            self.decoder = decoders.Wav2VecBertDecoder(**common, **kwargs)

    def decode(self, tokens: ArrayLike, **kwargs) -> np.ndarray:
        """Decode tokens [1, K, T] (acoustic) or [T] / [1, T] (semantic
        ids), as an array or a ``.npy`` path, to a waveform [1, samples]
        float32 (int16 with ``output_dtype="int16"``). ``kwargs`` reach
        the decoder's constructor on the first call."""
        self.load_decoder(**kwargs)
        if isinstance(tokens, (os.PathLike, Path, str)):
            tokens = np.load(tokens)
        return np.asarray(self.decoder(np.asarray(tokens).astype(np.int32)))

    def decode_batch(self, token_seqs, **kwargs):
        """Decode several token sequences -> a list of [1, samples]
        waveforms. Semantic sequences decode together in every stage;
        acoustic ones as one batch per run of equal shapes."""
        self.load_decoder(**kwargs)
        seqs = [np.load(t) if isinstance(t, (os.PathLike, Path, str)) else np.asarray(t)
                for t in token_seqs]
        if self.tokenizer_name != Tokenizers.acoustic:
            return self.decoder.decode_batch([s.reshape(-1).astype(np.int32) for s in seqs])
        outs, i = [], 0
        while i < len(seqs):
            grp = [seqs[i]]
            while i + len(grp) < len(seqs) and seqs[i + len(grp)].shape == grp[0].shape:
                grp.append(seqs[i + len(grp)])
            batch = np.stack([g.reshape(g.shape[-2], g.shape[-1]) for g in grp])
            wav = self.decoder.forward_codes(batch.astype(np.int32)).cpu().numpy()
            outs.extend(wav[j].reshape(1, -1) for j in range(len(grp)))
            i += len(grp)
        return outs
