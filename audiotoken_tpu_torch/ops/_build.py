"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` (one
process per file, all at once) and linked into one shared library with a
plain C interface, at first use, into ``_build/`` beside the package's
sources. The file name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signature of each entry point, without the trailing stream pointer
#: (tensors pass as pointers, sizes as ints, eps as a float); each returns
#: a cudaError_t.
SIGNATURES = {
    "seanet_front_f32": (_P, _P, _I, _I) + (_P,) * 8,
    "seanet_front_elu_mismatches": (_P,),
    "lstm_layer_f32": (_P, _P, _P, _P, _I, _I),
    "rvq_encode_f32": (_P,) * 4 + (_I,) * 4,
    "flash_attention_relkey_f32": (_P,) * 6 + (_I,) * 5,
    **{f"flash_attention_plain_{t}": (_P,) * 4 + (_I,) * 2 for t in ("f32", "bf16")},
    **{f"decode_attention_{t}": (_P,) * 7 + (_I,) * 6 for t in ("f32", "bf16")},
    **{f"decode_qkv_{t}": (_P,) * 6 + (_I,) * 3 + (_F,) for t in ("f32", "bf16")},
    **{f"decode_ffn_{t}": (_P,) * 13 + (_I,) * 3 + (_F,) for t in ("f32", "bf16")},
    **{f"decode_ffn_tp_out_{t}": (_P,) * 3 + (_I,) * 3 for t in ("f32", "bf16")},
    **{f"decode_ffn_tp_mlp_{t}": (_P,) * 11 + (_I,) * 3 + (_F,) for t in ("f32", "bf16")},
    **{f"decode_ffn_tp_add_{t}": (_P,) * 4 + (_I,) * 2 for t in ("f32", "bf16")},
    **{f"attn_ablation_{t}": (_P,) * 4 + (_I,) * 4 for t in ("f32", "bf16")},
}

#: suffix of the entry points for each element type a kernel takes
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def _build(so: Path) -> None:
    """Compile every source to an object file, all ``nvcc`` processes at
    once, then link them into ``so``; the compiler's output goes to a log
    beside it."""
    BUILD_DIR.mkdir(exist_ok=True)
    stem = f"{so.stem}.{os.getpid()}"
    nvcc, t0 = _nvcc(), time.perf_counter()
    jobs = []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], False
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        failed |= proc.returncode != 0
    objs = [obj for _cmd, obj, _proc in jobs]
    if not failed:
        tmp = so.with_name(f"{stem}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}")
        failed = proc.returncode != 0
    for obj in objs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    so.with_suffix(".log").write_text(text + f"\nbuild seconds: {time.perf_counter() - t0:.1f}\n")
    if failed:
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, so)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built first if this tree has none."""
    so = _library_path()
    if not so.exists():
        _build(so)
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
    ints for its ints; numbers for its floats) on ``device``'s current
    stream; raise if the launch was refused."""
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
        elif ctype is _F:
            cargs.append(float(a))
        elif -(2**31) <= a < 2**31:
            cargs.append(a)
        else:
            raise ValueError(f"{name}: size {a} does not fit a C int")
    lib = library()
    index = torch.cuda.current_device() if device.index is None else device.index
    # the raw handle of the device's current stream, without building a
    # Stream object (a measurable share of a decode step's host time)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = getattr(lib, name)(*cargs, stream)
    else:
        with torch.cuda.device(index):
            err = getattr(lib, name)(*cargs, stream)
    if err != 0:
        msg = lib.audiotoken_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_tensor(t: torch.Tensor, name: str, shape, dtype, device,
                 vector_loads: bool = False, strided_rows: bool = False) -> None:
    """Raise ValueError unless ``t`` has this shape (None matches any size),
    dtype and device and is contiguous; with ``vector_loads`` (the kernel
    reads it 16 bytes at a time) it must also be 16-byte aligned. With
    ``strided_rows``, a 2-D ``t`` need only have contiguous rows (a column
    slice of a wider matrix); with ``vector_loads`` each row must then start
    16-byte aligned too."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != tuple(shape) and (len(t.shape) != len(shape) or any(
        s is not None and s != ts for s, ts in zip(shape, t.shape)
    )):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    rows = strided_rows and t.dim() == 2 and t.stride(1) == 1
    if not (t.is_contiguous() or rows):
        raise ValueError(f"{name}: must be contiguous")
    if vector_loads and (t.data_ptr() % 16 or (rows and t.stride(0) * t.element_size() % 16)):
        raise ValueError(f"{name}: must be 16-byte aligned")
