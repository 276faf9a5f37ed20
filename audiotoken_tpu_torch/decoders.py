"""The decoders: tokens -> waveform.

Counterpart of ``audiotoken_tpu/decoders.py``. ``AcousticDecoder`` turns
EnCodec codes into audio (RVQ decode + SEANet decoder, whose LSTM is
kernel K2). The semantic decoders are a three-stage pipeline: the GPT
samples two interleaved coarse codebooks from the semantic ids (kernels K6
and K7 in its decode step), Bark-fine fills codebooks 3..8 (kernel K5 in
its attention), and the acoustic decoder renders them at 6 kbps.
"""

from typing import Optional

import numpy as np
import torch

from .configs import (
    COMMONS,
    AcousticDecoderConfig,
    HubertDecoderConfig,
    SemanticDecoderConfig,
    Wav2VecBertDecoderConfig,
)
from .encoders import _run_subbatched, resolve_device
from .nn.bark_fine import BarkFine, BarkFineGenerator
from .nn.gpt import GPT, GPTSampler
from .nn.rvq import rvq_decode
from .nn.seanet import SeanetConfig, SeanetDecoder
from .runtime.precision import get_policy
from . import weights as weight_store

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _module_from_state(cls, cfg, state, device, dtype):
    with torch.device("meta"):
        model = cls(cfg)
    model.load_state_dict(state, assign=True)
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)


class AcousticDecoder:
    """RVQ codes [B, K, T] -> waveform [1, B*T*hop] float32 (or int16 PCM),
    the batch flattened into one stream as the reference does.

    ``output_dtype="int16"`` applies the save-audio clamp (0.99) and the
    WAV quantisation (``round(x * 32768)``, clipped) on the device, so the
    int16 samples are the bytes the float path writes, at half the copy.

    ``max_device_batch``: larger batches decode as serial sub-batches of
    this many rows (the rows are independent, so the split is invisible).
    32 rows of 30 s peak at 12.47 GiB on an NVIDIA H100 80GB HBM3
    (``PERF.md``), so the default of 32 leaves room to spare.
    """

    def __init__(
        self,
        config: AcousticDecoderConfig = AcousticDecoderConfig(),
        weights: str = "artifacts",
        precision: str = "highest",
        seed: int = 0,
        device="cuda",
        output_dtype: str = "float32",
        max_device_batch: Optional[int] = 32,
    ):
        if output_dtype not in ("float32", "int16"):
            raise ValueError(f"output_dtype must be float32|int16, got {output_dtype!r}")
        self.device = resolve_device(device)
        self.config = config
        self.seanet_cfg = SeanetConfig()
        self.policy = get_policy(precision)
        self.output_dtype = output_dtype
        self.max_device_batch = max_device_batch
        self.hop = self.seanet_cfg.hop_length

        params = weight_store.get_acoustic_params(weights, seed)
        state, codebooks = weight_store.acoustic_decoder_from_numpy(params)
        del params
        self.seanet = SeanetDecoder(self.seanet_cfg)
        self.seanet.load_state_dict(state)
        self.seanet.to(self.device).eval()
        self.codebooks = codebooks.to(self.device)

    def _forward(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T] on the device -> [B, T*hop] float32 or int16."""
        with torch.inference_mode(), self.policy.numerics():
            z = rvq_decode(self.codebooks, codes)
            wav = self.seanet(z.to(self.policy.compute_dtype)).float()
            if self.output_dtype == "int16":
                wav = wav.clamp(-0.99, 0.99)
                wav = torch.round(wav * 32768.0).clamp(-32768, 32767).to(torch.int16)
            return wav

    def forward_codes(self, codes) -> torch.Tensor:
        """[B, K, T] codes (numpy or tensor) -> device waveforms [B, T*hop],
        split into sub-batches above ``max_device_batch``."""
        codes = torch.as_tensor(np.asarray(codes), dtype=torch.int64).to(self.device)
        return _run_subbatched(self._forward, self.max_device_batch or codes.shape[0], codes)

    def __call__(self, input_batch: np.ndarray) -> np.ndarray:
        codes = np.asarray(input_batch)
        if codes.ndim == 2:
            codes = codes[None]
        return self.forward_codes(codes).cpu().numpy().reshape(1, -1)


class _SemanticDecoderBase:
    """semantic ids -> GPT AR coarse tokens -> Bark-fine NAR -> waveform.

    Offset the ids into the joint vocab, truncate to ``max_source_tokens``,
    append the acoustic INFER token, sample up to ``max_new_tokens``
    (temperature 0.8, top-k 100, stop token), de-interleave the two coarse
    codebooks, fill codebooks 3..8 with Bark-fine, decode with EnCodec at
    6 kbps.

    The AR and fine stages hold their weights in ``ar_dtype`` /
    ``fine_dtype`` (bf16 by default, f32 accumulation) under the
    ``ar_precision`` / ``fine_precision`` policies; the acoustic decoder
    runs under ``precision``. The JAX package's ``ar_attn``,
    ``ar_fused_step`` and ``fine_attn_impl`` chose among TPU layouts and
    kernels; the port has one path per device (the kernels on CUDA, their
    plain versions on the CPU), so it has no such options.
    """

    def __init__(
        self,
        config: SemanticDecoderConfig,
        language: COMMONS,
        weights: str = "artifacts",
        precision: str = "highest",
        seed: int = 0,
        device="cuda",
        temperature: float = 0.8,
        top_k: int = 100,
        max_new_tokens: int = 1024,
        fine_precision: str = "default",
        fine_dtype: str = "bfloat16",
        ar_precision: str = "default",
        ar_dtype: str = "bfloat16",
        output_dtype: str = "float32",
    ):
        if language not in config.supported_languages:
            raise AssertionError(f"{language} not supported; only {config.supported_languages}")
        for name, value in (("precision", precision), ("ar_precision", ar_precision),
                            ("fine_precision", fine_precision)):
            if value == "mixed":
                raise ValueError(
                    f'{name}="mixed" is a semantic_m encoder policy, not a decoder one; '
                    'use "highest", "high" or "default"')
        for name, value in (("ar_dtype", ar_dtype), ("fine_dtype", fine_dtype)):
            if value not in _DTYPES:
                raise ValueError(f"{name} must be one of {list(_DTYPES)}, got {value!r}")
        self.device = resolve_device(device)
        self.config = config
        self.language = language
        self.temperature = temperature
        self.top_k = top_k
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        self.ar_policy = get_policy(ar_precision)
        self.fine_policy = get_policy(fine_precision)

        artifact_key = dict(config.model_artifacts)[language]
        gpt_params, gpt_cfg = weight_store.get_semantic_gpt_params(
            weights, seed, artifact_key, config.vocab.vocab_size)
        state = weight_store.gpt_from_numpy(gpt_params)
        del gpt_params
        self.gpt = GPTSampler(_module_from_state(GPT, gpt_cfg, state, self.device,
                                                 _DTYPES[ar_dtype]))
        del state

        bark_params, bark_cfg = weight_store.get_bark_fine_params(weights, seed)
        state = weight_store.bark_fine_from_numpy(bark_params)
        del bark_params
        self.bark = BarkFineGenerator(_module_from_state(BarkFine, bark_cfg, state, self.device,
                                                         _DTYPES[fine_dtype]))
        del state

        self.acoustic_decoder = AcousticDecoder(
            config=AcousticDecoderConfig(bandwidth=6.0), weights=weights,
            precision=precision, seed=seed, device=self.device, output_dtype=output_dtype)

    def _deserialize(self, tokens: np.ndarray) -> np.ndarray:
        """Interleaved coarse stream -> [2, T] codebook ids (the second
        codebook carries a +per_codebook_size offset)."""
        n = (len(tokens) // 2) * 2
        cb1 = tokens[0:n:2]
        cb2 = tokens[1:n:2] - self.config.per_codebook_size
        return np.clip(np.stack([cb1, cb2]), 0, self.config.per_codebook_size - 1)

    def __call__(self, input_batch: np.ndarray, seed: Optional[int] = None) -> np.ndarray:
        return self.decode_batch([np.asarray(input_batch).reshape(-1)], seed=seed)[0]

    def decode_batch(self, sources, seed: Optional[int] = None,
                     pipeline_batch: Optional[int] = None):
        """Decode several semantic-id sequences together -> a list of
        [1, n_samples] waveforms (float32, or int16 PCM with
        ``output_dtype="int16"``). All three stages batch across the
        sources; the AR stage keeps per-row stop bookkeeping.

        ``pipeline_batch`` (overlapping one chunk's AR loop with the previous
        chunk's fine and EnCodec stages) is not ported: it raises when set
        and exceeded."""
        seed = self.seed if seed is None else seed
        if pipeline_batch and len(sources) > int(pipeline_batch):
            raise NotImplementedError(
                "pipeline_batch: the two-deep decode pipeline is ported only behind "
                "a measurement on the GPU; call decode_batch per chunk instead")
        coarse_rows = self._ar_stage(sources, seed)
        return self._finish_stage(coarse_rows, seed)

    def _ar_stage(self, sources, seed: int):
        """sources -> per-row [2, T] coarse codebook ids."""
        vocab = self.config.vocab
        infer = vocab.infer_token[COMMONS.ACOUSTIC]
        stop = vocab.stop_token[COMMONS.ACOUSTIC]
        prompts = []
        for src in sources:
            # ids past semantic_size land beyond the semantic range of the
            # joint vocab, as in the reference (ROADMAP, Queue 3)
            src = np.asarray(src).reshape(-1) + vocab.offsets[COMMONS.SEMANTIC]
            src = src[: self.config.max_source_tokens]
            prompts.append(np.concatenate([src, [infer]]).astype(np.int32))

        with self.ar_policy.numerics():
            new_tokens = self.gpt.generate_batch(
                prompts, max_new_tokens=self.max_new_tokens, temperature=self.temperature,
                top_k=self.top_k, stop_token=stop, seed=seed)

        coarse_rows = []
        for y in new_tokens:
            y = y[(y != stop) & (y >= 0)]
            y = y - vocab.offsets[COMMONS.ACOUSTIC]
            if y.size < 2:
                raise RuntimeError("AR model produced no acoustic tokens before the stop token")
            # clamp stray out-of-range samples; positions are kept so that
            # the codebook interleaving stays aligned
            y = np.clip(y, 0, 2 * self.config.per_codebook_size - 1)
            coarse_rows.append(self._deserialize(y))
        return coarse_rows

    def _fine_stage(self, coarse_rows, seed: int):
        """coarse rows -> (fine codes [B, 8, T_max], row lengths): rows padded
        with Bark's filler id to a shared length, then Bark-fine."""
        lens = [c.shape[1] for c in coarse_rows]
        filler = self.bark.cfg.codebook_size
        coarse = np.full((len(lens), coarse_rows[0].shape[0], max(lens)), filler, np.int64)
        for i, c in enumerate(coarse_rows):
            coarse[i, :, : lens[i]] = c
        with self.fine_policy.numerics():
            return self.bark.generate_fine_batch(coarse, seed=seed), lens

    def _finish_stage(self, coarse_rows, seed: int):
        """coarse rows -> waveforms: the fine stage, then the acoustic
        decoder through ``forward_codes`` (so its sub-batch split applies),
        each row trimmed to its own length."""
        fine, lens = self._fine_stage(coarse_rows, seed)
        wav = self.acoustic_decoder.forward_codes(fine).cpu().numpy()  # [B, T_max*hop]
        hop = self.acoustic_decoder.hop
        return [wav[i].reshape(1, -1)[:, : n * hop] for i, n in enumerate(lens)]


class HubertDecoder(_SemanticDecoderBase):
    """semantic_s decode (EN checkpoint)."""

    def __init__(self, config=HubertDecoderConfig(), language=COMMONS.EN, **kw):
        super().__init__(config, COMMONS(language), **kw)


class Wav2VecBertDecoder(_SemanticDecoderBase):
    """semantic_m decode (HI checkpoint)."""

    def __init__(self, config=Wav2VecBertDecoderConfig, language=COMMONS.HI, **kw):
        super().__init__(config, COMMONS(language), **kw)
