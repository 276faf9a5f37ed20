"""Dependency-free RIFF/WAVE reader and writer.

Replaces the upstream audiotoken project's torchaudio.load / torchaudio.save
calls (its utils.py) for the WAV container; a copy of
``audiotoken_tpu/io/wavfile.py``.
Sample normalization matches torchaudio's ``normalize=True``:
int16/2^15, int32/2^31, uint8 (x-128)/2^7, 24-bit /2^23, float passthrough.
Compressed containers (flac/mp3/ogg/opus) go through the native libav
decoder (``io/_native.py``) instead.
"""

import struct
from typing import BinaryIO, Tuple, Union

import numpy as np

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


class WavInfo:
    __slots__ = ("sample_rate", "num_channels", "bits", "fmt", "data_offset", "data_size")

    def __init__(self, sample_rate, num_channels, bits, fmt, data_offset, data_size):
        self.sample_rate = sample_rate
        self.num_channels = num_channels
        self.bits = bits
        self.fmt = fmt
        self.data_offset = data_offset
        self.data_size = data_size

    @property
    def bytes_per_frame(self) -> int:
        return self.num_channels * (self.bits // 8)

    @property
    def num_frames(self) -> int:
        return self.data_size // self.bytes_per_frame


def _parse_header(f: BinaryIO) -> WavInfo:
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk found")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            body = f.read(size if size % 2 == 0 else size + 1)
            (audio_fmt, n_ch, sr, _brate, _balign, bits) = struct.unpack("<HHIIHH", body[:16])
            if audio_fmt == _FMT_EXTENSIBLE and size >= 40:
                audio_fmt = struct.unpack("<H", body[24:26])[0]
            fmt = (audio_fmt, n_ch, sr, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            audio_fmt, n_ch, sr, bits = fmt
            return WavInfo(sr, n_ch, bits, audio_fmt, f.tell(), size)
        else:
            f.seek(size + (size % 2), 1)


def _decode_frames(raw: bytes, info: WavInfo) -> np.ndarray:
    """bytes -> float32 array [channels, frames]."""
    if info.fmt == _FMT_FLOAT:
        if info.bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif info.bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth {info.bits}")
    elif info.fmt == _FMT_PCM:
        if info.bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif info.bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif info.bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif info.bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= (1 << 23), x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM bit depth {info.bits}")
    else:
        raise ValueError(f"unsupported WAV format tag {info.fmt}")
    return np.ascontiguousarray(x.reshape(-1, info.num_channels).T)


def read_wav(path_or_file: Union[str, BinaryIO]) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 [channels, frames], sample_rate)."""
    if hasattr(path_or_file, "read"):
        f = path_or_file
        info = _parse_header(f)
        raw = f.read(info.data_size)
    else:
        with open(path_or_file, "rb") as f:
            info = _parse_header(f)
            raw = f.read(info.data_size)
    return _decode_frames(raw, info), info.sample_rate


def parse_header(f: BinaryIO) -> WavInfo:
    """Parse the RIFF header of an open stream, leaving it at the data chunk."""
    return _parse_header(f)


def stream_wav_chunks(
    f: BinaryIO, info: WavInfo, frames_per_chunk: int, keep_int16: bool = False
):
    """Yield [channels, frames] chunks from a stream positioned at the data
    chunk (after :func:`parse_header`).

    ``keep_int16`` (PCM16 sources only) yields raw int16 samples instead of
    normalized float32 — downstream device code divides by 2^15 exactly, so
    tokens are identical while host->device transfer halves.
    """
    raw16 = keep_int16 and info.fmt == _FMT_PCM and info.bits == 16
    bpf = info.bytes_per_frame
    remaining = info.data_size
    while remaining > 0:
        n = min(frames_per_chunk * bpf, remaining)
        raw = f.read(n)
        if not raw:
            break
        remaining -= len(raw)
        usable = len(raw) - len(raw) % bpf
        if usable == 0:
            break
        if raw16:
            x = np.frombuffer(raw[:usable], dtype="<i2")
            yield np.ascontiguousarray(x.reshape(-1, info.num_channels).T)
        else:
            yield _decode_frames(raw[:usable], info)


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 [channels, frames] as 16-bit PCM WAV
    (reference save_audio semantics, utils.py:415). int16 input is taken
    as already-quantized PCM and written verbatim (the device-side int16
    decode path, decoders.AcousticDecoder(output_dtype='int16'))."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    n_ch, n_frames = audio.shape
    if audio.dtype == np.int16:
        pcm = audio.astype("<i2", copy=False)
    else:
        audio = audio.astype(np.float32, copy=False)
        pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype("<i2")
    data = np.ascontiguousarray(pcm.T).tobytes()
    with open(path, "wb") as f:
        byte_rate = sample_rate * n_ch * 2
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, _FMT_PCM, n_ch, sample_rate, byte_rate, n_ch * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)
