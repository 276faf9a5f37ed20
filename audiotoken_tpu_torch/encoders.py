"""The acoustic encoder: host <-> device boundary, bucketing, dtype policy.

Counterpart of ``audiotoken_tpu/encoders.py:AcousticEncoder``. Outputs are
numpy int16 codes [B, K, T] at 75 frames per second.
"""

import math

import numpy as np
import torch

from .configs import AcousticEncoderConfig
from .nn.rvq import ResidualVQ, RVQConfig
from .nn.seanet import SeanetConfig, SeanetEncoder
from .runtime.bucketing import default_buckets, pad_to_bucket
from .runtime.precision import get_policy
from .weights import acoustic_from_numpy, get_acoustic_params


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device raises when no GPU is
    present rather than running elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return device


def _require_min_samples(n: int, min_samples: int, sample_rate: int, who: str):
    if n < min_samples:
        raise ValueError(
            f"{who}: input audio is {n} samples "
            f"({1000.0 * n / sample_rate:.1f} ms) — shorter than the "
            f"{1000.0 * min_samples / sample_rate:.1f} ms minimum "
            f"({min_samples} samples at {sample_rate} Hz) needed to produce "
            "one token"
        )


def _run_subbatched(forward, x: torch.Tensor, max_b: int) -> torch.Tensor:
    """``forward(x)`` in serial sub-batches of at most ``max_b`` rows, joined
    on the device. Every row is encoded independently of the others."""
    if x.shape[0] <= max_b:
        return forward(x)
    return torch.cat([forward(x[i : i + max_b]) for i in range(0, x.shape[0], max_b)])


class AcousticEncoder:
    """Waveform -> EnCodec RVQ codes [B, num_codebooks, T] int16 at 75 fps.

    Takes float32 or raw int16 PCM; int16 is scaled by the exact 1/2^15 on
    the device."""

    def __init__(
        self,
        config: AcousticEncoderConfig = AcousticEncoderConfig(),
        weights: str = "artifacts",
        precision: str = "highest",
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
        self.seanet_cfg = SeanetConfig()
        self.rvq_cfg = RVQConfig()
        self.num_q = self.rvq_cfg.num_quantizers_for_bandwidth(config.bandwidth)
        self.policy = get_policy(precision)
        self.hop = self.seanet_cfg.hop_length  # 320 -> 75 fps at 24 kHz

        state, codebooks = acoustic_from_numpy(get_acoustic_params(weights, seed))
        self.seanet = SeanetEncoder(self.seanet_cfg)
        self.seanet.load_state_dict(state)
        self.seanet.to(self.device).eval()
        self.quantizer = ResidualVQ(codebooks, self.num_q).to(self.device)
        self.buckets = default_buckets(config.model_sample_rate, self.hop)
        # Larger batches run as sub-batches of this many rows; 32 x 30 s is
        # the batch the JAX package sized its device memory for.
        self.max_device_batch = 32

    def _forward(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, T] f32 or int16 on the device -> codes [B, num_q, T'] int16."""
        with torch.inference_mode(), self.policy.numerics():
            if audio.dtype == torch.int16:
                # /2^15 is exact, so int16 input gives the f32 path's tokens
                audio = audio.float() * (1.0 / 32768.0)
            z = self.seanet(audio.to(self.policy.compute_dtype))
            return self.quantizer(z).to(torch.int16)

    def __call__(self, input_batch: np.ndarray, attention_mask=None) -> np.ndarray:
        """[B, T] float32 (or int16 PCM) -> [B, num_q, ceil(T/hop)] int16.

        ``attention_mask`` is accepted for the JAX encoders' common signature
        and not used: the path is causal."""
        audio = np.asarray(input_batch)
        if audio.dtype != np.int16:
            audio = audio.astype(np.float32)
        n = audio.shape[-1]
        _require_min_samples(n, 1, self.config.model_sample_rate, "AcousticEncoder")
        padded = pad_to_bucket(audio, self.buckets, self.config.pad_token or 0)
        x = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
        codes = _run_subbatched(self._forward, x, self.max_device_batch)
        return codes[:, :, : math.ceil(n / self.hop)].cpu().numpy()
