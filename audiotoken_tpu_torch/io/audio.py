"""Audio reading and chunked streaming, WAV only.

Decoding runs on the host with the pure-numpy WAV parser; resampling uses
the torchaudio-parity polyphase kernel (io/resample.py). Other containers
need the native libav decoder, which comes with a later slice of the port:
until then they raise, as the JAX package does without its native library.
"""

import os
from typing import IO, Generator, Tuple, Union

import numpy as np

from ..logger import get_logger
from . import wavfile
from .resample import resample_np

logger = get_logger(__name__)

PathLike = Union[str, os.PathLike]


def _require_wav(name: str, what: str) -> None:
    if not name.lower().endswith(".wav"):
        raise RuntimeError(
            f"cannot {what} {name}: non-WAV formats require the native libav "
            "decoder, which this package does not have yet"
        )


def convert_audio(
    audio: np.ndarray, sample_rate: int, target_sample_rate: int
) -> np.ndarray:
    """[channels, T] -> mono [1, T'] at the target rate."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim != 2:
        raise RuntimeError(f"audio must be 2D [channels, time], got {audio.ndim}D")
    num_channels = audio.shape[0]
    if num_channels == 2:
        logger.warning("Provided audio is stereo, converting to mono")
        audio = audio.mean(axis=0, keepdims=True)
    elif num_channels != 1:
        raise RuntimeError("Only mono or stereo audio is supported")
    if sample_rate != target_sample_rate:
        audio = resample_np(audio, sample_rate, target_sample_rate)
    return audio


def read_audio(x: PathLike, model_sample_rate: int) -> np.ndarray:
    """Read a WAV file -> mono float32 [1, T] at ``model_sample_rate``."""
    _require_wav(str(x), "decode")
    audio, sr = wavfile.read_wav(str(x))
    return convert_audio(audio, sr, model_sample_rate)


def process_audio_chunks(
    file_name: str,
    file_stream: Union[IO[bytes], PathLike, None],
    target_sample_rate: int,
    chunk_size: float,
) -> Generator[Tuple[np.ndarray, str], None, None]:
    """Stream ``chunk_size``-second chunks of a WAV file as mono [1, T']
    float32 at ``target_sample_rate``.

    Chunk boundaries fall at multiples of ``chunk_size * native_rate``
    source samples, and each chunk is resampled on its own.
    """
    name = str(file_name)
    _require_wav(name, "stream")
    source = file_stream if file_stream is not None else name
    close = not hasattr(source, "read")
    if close:
        source = open(source, "rb")
    try:
        info = wavfile.parse_header(source)
        native_sr = info.sample_rate
        frames = int(chunk_size * native_sr)
        for raw in wavfile.stream_wav_chunks(source, info, frames):
            mono = raw.mean(axis=0, keepdims=True) if raw.shape[0] > 1 else raw
            if native_sr != target_sample_rate:
                mono = resample_np(mono, native_sr, target_sample_rate)
            yield mono.astype(np.float32), name
    finally:
        if close:
            source.close()
