"""Device ms a call in kernels that are not the program's own: cuDNN's
convolutions, cuBLAS's products, ATen's pads, copies inside the device and
element-wise kernels. The program's own kernels are the ``__global__``
functions of its CUDA sources (``audiotoken_tpu_torch/csrc/*.cu``), read
from the checkout; memory copies are ``copy_ms``'s."""

import re
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[2] / "audiotoken_tpu_torch" / "csrc"
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(")


def own_kernels(csrc: Path = _CSRC) -> set:
    """The names of the program's own kernels."""
    return {m.group(1) for src in sorted(csrc.glob("*.cu"))
            for m in _GLOBAL.finditer(src.read_text())}


def read(ctx):
    if ctx.trace is None or not ctx.trace.calls:
        return None
    own = own_kernels()
    return 1e3 * ctx.trace.kernel_s(lambda name: name not in own) / ctx.trace.calls
