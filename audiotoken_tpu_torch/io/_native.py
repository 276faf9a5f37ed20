"""ctypes binding of the host's libav streaming decoder (``native/audioio.cc``).

Counterpart of ``audiotoken_tpu/io/_native.py``. The library is built at
first use with ``g++`` into ``_build/`` beside the package's sources (as
``ops/_build.py`` builds the kernels): its file name carries a hash of the
source, and it is written to a temporary name and moved into place, so
that processes building at once never load a half-written file. The build
needs the FFmpeg development headers (libavformat, libavcodec, libavutil).

When the build or the load fails, :func:`native_available` is False, the
compiler's output is kept in ``_build/libaudioio_<hash>.log``, and every
non-WAV input raises an error that names it: WAV keeps its numpy parser and
nothing decodes other containers by another route.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..logger import get_logger

logger = get_logger(__name__)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "audioio.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lavformat", "-lavcodec", "-lavutil")
_LOAD_LOCK = threading.Lock()  # producer threads may ask for the library at once


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libaudioio_{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=300)
        out, ok = proc.stdout, proc.returncode == 0
    except (OSError, subprocess.TimeoutExpired) as e:
        out, ok = f"{type(e).__name__}: {e}", False
    build_log_path().write_text(f"$ {' '.join(cmd)}\n{out}")
    if not ok:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (log: {build_log_path()})")
    os.replace(tmp, so)


def _load() -> Optional[ctypes.CDLL]:
    """The decoder's library, built first if this tree has none; None when
    it cannot be built or loaded (the reason is logged)."""
    with _LOAD_LOCK:
        return _load_locked()


@functools.lru_cache(maxsize=None)
def _load_locked() -> Optional[ctypes.CDLL]:
    so = library_path()
    try:
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, RuntimeError) as e:
        logger.warning("native libav decoder unavailable: %s", e)
        return None
    lib.ati_open.restype = ctypes.c_void_p
    lib.ati_open.argtypes = [ctypes.c_char_p]
    lib.ati_open_bytes.restype = ctypes.c_void_p
    lib.ati_open_bytes.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    lib.ati_sample_rate.restype = ctypes.c_int
    lib.ati_sample_rate.argtypes = [ctypes.c_void_p]
    lib.ati_channels.restype = ctypes.c_int
    lib.ati_channels.argtypes = [ctypes.c_void_p]
    lib.ati_duration_frames.restype = ctypes.c_int64
    lib.ati_duration_frames.argtypes = [ctypes.c_void_p]
    lib.ati_read.restype = ctypes.c_int64
    lib.ati_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.ati_error.restype = ctypes.c_char_p
    lib.ati_error.argtypes = [ctypes.c_void_p]
    lib.ati_close.restype = None
    lib.ati_close.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    return _load() is not None


def unavailable_error(what: str) -> RuntimeError:
    """The error of a non-WAV input when the library is missing."""
    return RuntimeError(
        f"cannot decode {what}: non-WAV formats need the native libav decoder, "
        f"which did not build (g++ and the FFmpeg development headers; log: "
        f"{build_log_path()})"
    )


class NativeDecoder:
    """Streaming decode to mono float32 at the source's own sample rate.

    ``source`` is a path, bytes, or a binary file object (read whole)."""

    _h = None

    def __init__(self, source, format_hint: str = ""):
        lib = _load()
        if lib is None:
            raise unavailable_error(repr(source) if isinstance(source, (str, os.PathLike))
                                    else "in-memory audio")
        self._lib = lib
        if isinstance(source, (str, os.PathLike)):
            self._h = lib.ati_open(os.fsencode(source))
        else:
            data = bytes(source) if isinstance(source, (bytes, bytearray)) else source.read()
            self._h = lib.ati_open_bytes(data, len(data), format_hint.encode())
        if not self._h:
            raise ValueError(f"could not open audio source: {source!r:.80}")

    @property
    def sample_rate(self) -> int:
        return self._lib.ati_sample_rate(self._h)

    @property
    def channels(self) -> int:
        return self._lib.ati_channels(self._h)

    @property
    def duration_frames(self) -> int:
        return self._lib.ati_duration_frames(self._h)

    def read(self, max_frames: int) -> np.ndarray:
        out = np.empty(max_frames, dtype=np.float32)
        n = self._lib.ati_read(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               max_frames)
        if n < 0:
            raise RuntimeError(f"decode error: {self._lib.ati_error(self._h).decode()}")
        return out[:n]

    def chunks(self, frames_per_chunk: int) -> Iterator[np.ndarray]:
        while True:
            chunk = self.read(frames_per_chunk)
            if chunk.size == 0:
                return
            yield chunk

    def read_all(self) -> np.ndarray:
        """The rest of the stream as one mono float32 [1, T] array."""
        parts = list(self.chunks(1 << 20))
        return (np.concatenate(parts) if parts else np.zeros(0, np.float32))[None, :]

    def close(self) -> None:
        if self._h:
            self._lib.ati_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
