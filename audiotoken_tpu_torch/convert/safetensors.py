"""Reader of the ``.safetensors`` format, in numpy alone.

The layout: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``__metadata__``), then the raw little-endian buffers, each at
its offsets from the end of the header. BF16 is widened to f32 exactly
(its 16 bits are an f32's upper half).
"""

import json
import struct
from typing import Dict

import numpy as np

_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}


def load_file(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a .safetensors file (BF16 tensors as float32)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: {name} lies outside the file's data")
        shape = tuple(info["shape"])
        buf = data[begin:end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _DTYPES:
            arr = np.frombuffer(buf, dtype=_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
        out[name] = arr.reshape(shape).copy()
    return out
