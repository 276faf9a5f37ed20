"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into ``_build/``
beside the package's sources. The file name carries a hash of the sources
and flags, so an edit rebuilds and an unchanged tree reuses the library.
The library is loaded with ctypes; every pointer and the stream pass as
``c_void_p``.

Nothing here runs at import: the CPU-only test environment imports every
module and has no ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of each entry point, without the trailing stream pointer
#: (tensors pass as pointers, sizes as ints); each returns a cudaError_t.
SIGNATURES = {
    "seanet_front_f32": (_P, _P, _I, _I) + (_P,) * 8,
    "lstm_layer_f32": (_P, _P, _P, _I, _I),
    "rvq_encode_f32": (_P, _P, _P, _P, _I, _I, _I),
    "flash_attention_relkey_f32": (_P,) * 6 + (_I,) * 5,
}


def _nvcc() -> str:
    cands = ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    if "CUDA_HOME" in os.environ:
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaudiotoken_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built first if this tree has none."""
    so = _library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(SRC_DIR.glob("*.cu")))]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        so.with_suffix(".log").write_text(log + f"\nbuild seconds: {time.perf_counter() - t0:.1f}\n")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.audiotoken_cuda_error_string.argtypes = [_I]
    lib.audiotoken_cuda_error_string.restype = ctypes.c_char_p
    for name, sig in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [*sig, _P]
        fn.restype = _I
    return lib


def build_log() -> str:
    """The compiler's output for the current sources (with ``-Xptxas -v``:
    registers, shared memory and spills per kernel), or "" if the library
    was built by an earlier process without a log."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` (declared in :data:`SIGNATURES`) with
    ``args`` (tensors, or None for a null pointer, for its pointers; Python
    ints for its ints) on ``device``'s current stream; raise if the launch
    was refused."""
    sig = SIGNATURES[name]
    if len(args) != len(sig):
        raise TypeError(f"{name}: {len(args)} arguments, expected {len(sig)}")
    cargs = []
    for a, ctype in zip(args, sig):
        if ctype is _P:
            if a is None:
                cargs.append(None)
                continue
            if not isinstance(a, torch.Tensor):
                raise TypeError(f"{name}: expected a tensor, got {type(a).__name__}")
            cargs.append(a.data_ptr())
        elif -(2**31) <= a < 2**31:
            cargs.append(a)
        else:
            raise ValueError(f"{name}: size {a} does not fit a C int")
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*cargs, stream)
    if err != 0:
        msg = lib.audiotoken_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_tensor(t: torch.Tensor, name: str, shape, dtype, device,
                 vector_loads: bool = False) -> None:
    """Raise ValueError unless ``t`` has this shape (None matches any size),
    dtype and device and is contiguous; with ``vector_loads`` (the kernel
    reads it as float4) it must also be 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(t.shape) != len(shape) or any(
        s is not None and s != ts for s, ts in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if vector_loads and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
