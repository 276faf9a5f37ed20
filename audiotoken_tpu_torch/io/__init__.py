"""Host-side audio I/O: WAV decode, resample, chunk."""

from .audio import convert_audio, process_audio_chunks, read_audio
from .resample import resample_np, sinc_resample_kernel

__all__ = [
    "read_audio",
    "convert_audio",
    "process_audio_chunks",
    "resample_np",
    "sinc_resample_kernel",
]
