"""Windowed-sinc polyphase resampler with torchaudio-compatible numerics.

The filter bank is built as ``torchaudio.transforms.Resample`` builds it
(sinc times a squared Hann window in float64, cast to float32), which the
16-codebook tokens are sensitive to. Host-side numpy only.
"""

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=64)
def sinc_resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
):
    """Build the polyphase filter bank (torchaudio's ``sinc_interp_hann``).

    Returns ``(kernel, width, orig, new)``: ``kernel`` is float32
    [new, 1, 2*width + orig] (one FIR per output phase) and ``orig``/``new``
    are the gcd-reduced rates.
    """
    if orig_freq == new_freq:
        raise ValueError("orig_freq == new_freq: no resampling needed")
    g = math.gcd(int(orig_freq), int(new_freq))
    orig = int(orig_freq) // g
    new = int(new_freq) // g

    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)

    idx = np.arange(-width, width + orig, dtype=np.float64)[None, None] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None, None] / new + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2

    t *= math.pi
    scale = base_freq / orig
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * scale

    return kernel.astype(np.float32), width, orig, new


def resample_np(waveform: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Resample ``waveform`` [..., T]; output length ``ceil(new * T / orig)``
    after gcd reduction.

    A strided view turns the polyphase filtering into one
    [num_frames, taps] @ [taps, new] matmul.
    """
    waveform = np.asarray(waveform, dtype=np.float32)
    if orig_freq == new_freq:
        return waveform
    kernel, width, orig, new = sinc_resample_kernel(int(orig_freq), int(new_freq))
    taps = kernel.shape[-1]
    shape = waveform.shape
    flat = waveform.reshape(-1, shape[-1])
    length = shape[-1]
    x = np.pad(flat, ((0, 0), (width, width + orig)))
    num_frames = (x.shape[-1] - taps) // orig + 1
    s0, s1 = x.strides
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(flat.shape[0], num_frames, taps), strides=(s0, s1 * orig, s1)
    )
    out = frames @ kernel[:, 0, :].T  # [B, num_frames, new]
    out = out.reshape(flat.shape[0], -1)
    target_length = int(math.ceil(new * length / orig))
    return out[:, :target_length].reshape(*shape[:-1], target_length)
