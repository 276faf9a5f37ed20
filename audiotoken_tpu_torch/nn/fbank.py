"""Kaldi-style log-mel fbank front-end of wav2vec2-BERT, in PyTorch.

Counterpart of ``audiotoken_tpu/nn/fbank.py``. Every per-frame operation
before the power spectrum (x2^15 scaling, DC removal, 0.97 pre-emphasis,
povey window, zero-padded 512-point rDFT) is linear in the frame, so they
are folded, in float64 on the host, into one [400, 2 * 257] f32 matrix;
the spectrogram is then one matmul over the frames, accumulated in
float64. Frames are taken with ``Tensor.unfold``.
"""

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..runtime.precision import get_policy, tf32_numerics


@dataclass(frozen=True)
class FbankConfig:
    sampling_rate: int = 16_000
    num_mel_bins: int = 80
    frame_length: int = 400
    hop_length: int = 160
    fft_length: int = 512
    preemphasis: float = 0.97
    mel_floor: float = 1.192092955078125e-07
    remove_dc_offset: bool = True
    stride: int = 2
    padding_value: float = 1.0
    min_frequency: float = 20.0
    max_frequency: float = 8_000.0
    # The reference pipeline normalises with the biased variance; keep
    # False for token parity.
    unbiased_variance: bool = False


def _hertz_to_mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def _mel_filter_bank(cfg: FbankConfig) -> np.ndarray:
    """[257, num_mel_bins] triangular filters, built in mel space (the
    reference's construction, kept for token parity)."""
    nbins = cfg.fft_length // 2  # 256 (last rfft bin padded with a zero row)
    mel_min = _hertz_to_mel(cfg.min_frequency)
    mel_max = _hertz_to_mel(cfg.max_frequency)
    filter_freqs = np.linspace(mel_min, mel_max, cfg.num_mel_bins + 2)
    fft_bin_width = cfg.sampling_rate / (nbins * 2)
    fft_freqs = _hertz_to_mel(fft_bin_width * np.arange(nbins))

    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / filter_diff[:-1]
    up = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))  # [256, M]
    return np.concatenate([fb, np.zeros((1, cfg.num_mel_bins))])  # [257, M]


def _hann_periodic_false(L: int) -> np.ndarray:
    """torch.hann_window(L, periodic=False): 0.5 - 0.5*cos(2 pi n/(L-1))."""
    n = np.arange(L, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (L - 1))


def _folded_dft(cfg: FbankConfig):
    """(fold [frame, 2*(fft//2+1)] f32, mel [257, M] f32): scale, DC
    removal, pre-emphasis and window folded into the rDFT, in float64."""
    L, N = cfg.frame_length, cfg.fft_length
    nbins = N // 2 + 1

    m = np.eye(L, dtype=np.float64) * (2.0**15)  # Kaldi int16 scaling
    if cfg.remove_dc_offset:
        m = (np.eye(L) - np.full((L, L), 1.0 / L)) @ m
    if cfg.preemphasis is not None:
        pre = np.eye(L)
        pre[0, 0] = 1.0 - cfg.preemphasis
        idx = np.arange(1, L)
        pre[idx, idx - 1] = -cfg.preemphasis
        m = pre @ m
    window = np.power(_hann_periodic_false(L), 0.85)  # povey window
    m = np.diag(window) @ m

    n = np.arange(N)[:, None]  # zero-padded length
    k = np.arange(nbins)[None, :]
    ang = -2.0 * np.pi * n * k / N
    dft_re = np.cos(ang)[:L]  # the frame occupies the first L samples
    dft_im = np.sin(ang)[:L]
    fold = np.concatenate([m.T @ dft_re, m.T @ dft_im], axis=1)  # [L, 2*nbins]
    return fold.astype(np.float32), _mel_filter_bank(cfg).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _fold_tensors(cfg: FbankConfig, device: torch.device):
    fold, mel = _folded_dft(cfg)
    return torch.from_numpy(fold).to(device), torch.from_numpy(mel).to(device)


def fbank_features(
    waveform: torch.Tensor,
    mask: torch.Tensor,
    cfg: FbankConfig = FbankConfig(),
    pad_to_multiple_of: int = 2,
    precision="highest",
):
    """[B, N] waveform + [B, N] mask -> dict(input_features [B, F', M*stride],
    attention_mask [B, F']), the reference processor's semantics.
    ``precision`` (a policy name) sets the TF32 switches of the mel product."""
    fold, mel = _fold_tensors(cfg, waveform.device)
    nbins = cfg.fft_length // 2 + 1
    L, hop = cfg.frame_length, cfg.hop_length

    frames = waveform.float().unfold(-1, L, hop)  # [B, F, L]
    # This one product accumulates in float64. The folded matrix removes
    # each frame's DC offset, so on a DC-offset input its terms (up to 2^15
    # x the sample) cancel to a far smaller sum: an f32 sum taken in another
    # order than the reference's is then off by up to 0.15 in the normalised
    # features of the low, nearly constant mel dims, enough to flip ids.
    # In f64 the result is the exact product of the f32 matrix.
    spec = torch.matmul(frames.double(), fold.double()).float()
    power = spec[..., :nbins] ** 2 + spec[..., nbins:] ** 2
    with tf32_numerics(get_policy(precision).allow_tf32):
        melspec = torch.matmul(power, mel)
    features = torch.log(torch.clamp(melspec, min=cfg.mel_floor))
    num_frames = features.shape[1]

    # A frame is valid iff its whole analysis window is.
    fmask = (mask.float().unfold(-1, L, hop).mean(dim=-1) == 1.0).float()  # [B, F]

    # Masked mean/var normalisation with SHIFTED moments: frame 0's value is
    # subtracted first, so dims that are constant over time (silence, pure
    # tones) give exact zeros on every backend instead of amplified
    # summation rounding.
    m3 = fmask[:, :, None]
    count = torch.clamp(m3.sum(dim=1, keepdim=True), min=1.0)
    shift = features[:, :1]
    fs = (features - shift) * m3
    mean_s = fs.sum(dim=1, keepdim=True) / count
    var_den = torch.clamp(count - 1.0, min=1.0) if cfg.unbiased_variance else count
    var = ((fs - mean_s) ** 2 * m3).sum(dim=1, keepdim=True) / var_den
    features = (features - shift - mean_s) / torch.sqrt(var + 1e-7)

    # Stride-2 stacking, 80 -> 160.
    s = cfg.stride
    keep = num_frames - num_frames % s
    B = features.shape[0]
    features = features[:, :keep].reshape(B, keep // s, cfg.num_mel_bins * s)
    fmask = fmask[:, :keep].reshape(B, keep // s, s)

    # Masked sub-frames take padding_value; a stacked frame is valid iff its
    # FIRST sub-frame is valid.
    stacked_valid = fmask[:, :, 0]
    full = fmask.repeat_interleave(cfg.num_mel_bins, dim=-1)
    features = torch.where(full == 0, torch.full_like(features, cfg.padding_value), features)

    F2 = features.shape[1]
    P = 0
    if pad_to_multiple_of > 0 and F2 % pad_to_multiple_of:
        P = pad_to_multiple_of - F2 % pad_to_multiple_of
    features = torch.nn.functional.pad(features, (0, 0, 0, P), value=cfg.padding_value)
    attention_mask = torch.nn.functional.pad(stacked_valid, (0, P))
    return {"input_features": features, "attention_mask": attention_mask}
