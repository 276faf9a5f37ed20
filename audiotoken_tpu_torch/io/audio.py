"""Audio reading, writing and chunked streaming.

Counterpart of ``audiotoken_tpu/io/audio.py``. Decoding runs on the host:
WAV through the pure-numpy parser (``io/wavfile.py``), every other
container through the native libav decoder (``io/_native.py``), which
raises an error naming it when it could not be built. Resampling uses the
torchaudio-parity polyphase kernel (``io/resample.py``), so token ids match
the reference's bit for bit.
"""

import os
import tarfile
import zipfile
from pathlib import Path
from typing import IO, Generator, Iterable, List, Tuple, Union

import numpy as np

from ..configs import AUDIO_EXTS
from ..logger import get_logger
from . import _native, wavfile
from .resample import resample_np

logger = get_logger(__name__)

PathLike = Union[str, os.PathLike]


def _is_wav(name: str) -> bool:
    return name.lower().endswith(".wav")


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


def _decode_full(path: PathLike) -> Tuple[np.ndarray, int]:
    """Decode a whole file -> (float32 [channels, T], sample_rate)."""
    p = str(path)
    if _is_wav(p):
        return wavfile.read_wav(p)
    with _native.NativeDecoder(p) as dec:
        return dec.read_all(), dec.sample_rate


def read_audio(x: PathLike, model_sample_rate: int) -> np.ndarray:
    """Read an audio file -> mono float32 [1, T] at ``model_sample_rate``."""
    audio, sr = _decode_full(x)
    return convert_audio(audio, sr, model_sample_rate)


def process_audio_chunks(
    file_name: str,
    file_stream: Union[IO[bytes], PathLike, None],
    target_sample_rate: int,
    chunk_size: float,
    prefer_int16: bool = False,
) -> Generator[Tuple[np.ndarray, str], None, None]:
    """Stream ``chunk_size``-second chunks of a file as mono [1, T'] float32
    at ``target_sample_rate``.

    Chunk boundaries fall at multiples of ``chunk_size * native_rate``
    source samples, and each chunk is resampled on its own.

    ``prefer_int16``: a PCM16 mono WAV already at the target rate is
    yielded as raw int16 (the encoders apply the exact /2^15 on the
    device): half the bytes to the card, the same tokens.
    """
    source = file_stream if file_stream is not None else str(file_name)
    name = str(file_name)

    # WAV takes the numpy bulk parser (faster than demuxing through libav);
    # everything else streams through the native decoder
    if not _is_wav(name):
        with _native.NativeDecoder(source) as dec:
            native_sr = dec.sample_rate
            for chunk in dec.chunks(int(chunk_size * native_sr)):
                out = chunk[None, :]
                if native_sr != target_sample_rate:
                    out = resample_np(out, native_sr, target_sample_rate)
                yield out, name
        return

    close = not hasattr(source, "read")
    if close:
        source = open(source, "rb")
    try:
        info = wavfile.parse_header(source)
        native_sr = info.sample_rate
        frames = int(chunk_size * native_sr)
        keep16 = prefer_int16 and info.num_channels == 1 and native_sr == target_sample_rate
        for raw in wavfile.stream_wav_chunks(source, info, frames, keep_int16=keep16):
            if raw.dtype == np.int16:
                yield raw, name
                continue
            mono = raw.mean(axis=0, keepdims=True) if raw.shape[0] > 1 else raw
            if native_sr != target_sample_rate:
                mono = resample_np(mono, native_sr, target_sample_rate)
            yield mono.astype(np.float32), name
    finally:
        if close:
            source.close()


def iterate_zip(
    x: PathLike, model_sample_rate: int, chunk_size: float = 30
) -> Generator[Tuple[np.ndarray, str], None, None]:
    """Stream chunks from every member of a zip, named by the member."""
    with zipfile.ZipFile(x, "r") as zf:
        for info in zf.infolist():
            if info.is_dir():
                continue
            with zf.open(info.filename) as member:
                yield from process_audio_chunks(
                    info.filename, member, model_sample_rate, chunk_size
                )


def iterate_tar(
    x: PathLike, model_sample_rate: int, chunk_size: float = 30
) -> Generator[Tuple[np.ndarray, str], None, None]:
    """Stream chunks from every member of a tar, named by the member."""
    with tarfile.open(x, "r") as tf:
        for member in tf.getmembers():
            if not member.isfile():
                continue
            f = tf.extractfile(member)
            if f is None:
                logger.error("Error extracting %s from %s", member.name, x)
                continue
            yield from process_audio_chunks(member.name, f, model_sample_rate, chunk_size)


def find_audio_files(folder: PathLike) -> List[str]:
    """Every audio file under ``folder``, sorted."""
    return find_files(folder, AUDIO_EXTS)


def find_files(folder: PathLike, extensions: Iterable[str]) -> List[str]:
    """Every file under ``folder`` whose name ends in one of ``extensions``
    (case-insensitive), sorted."""
    exts = tuple(e.lower() for e in extensions)
    out: List[str] = []
    for root, _dirs, files in os.walk(folder):
        for f in files:
            if f.lower().endswith(exts):
                out.append(os.path.join(root, f))
    out.sort()
    logger.info("Found %d files in %s", len(out), folder)
    return out


def save_audio(
    wav: np.ndarray,
    path: PathLike,
    sample_rate: int,
    rescale: bool = False,
) -> None:
    """Write 16-bit PCM, clamped to +-0.99 (or rescaled under it with
    ``rescale``).

    int16 input (the decoders' ``output_dtype="int16"``, which applied the
    same clamp and quantisation on the device) is written verbatim unless
    ``rescale``.
    """
    wav = np.asarray(wav)
    if wav.dtype == np.int16 and not rescale:
        wavfile.write_wav(str(path), wav, sample_rate)
        return
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    wav = np.asarray(wav, dtype=np.float32)
    limit = 0.99
    if rescale:
        mx = float(np.abs(wav).max()) or 1.0
        wav = wav * min(limit / mx, 1.0)
    else:
        wav = np.clip(wav, -limit, limit)
    wavfile.write_wav(str(path), wav, sample_rate)


def sanitize_path(path: PathLike) -> str:
    """Absolute, ``~`` expanded, created with its parents."""
    p = Path(path).expanduser().absolute().resolve()
    p.mkdir(parents=True, exist_ok=True)
    return str(p)
