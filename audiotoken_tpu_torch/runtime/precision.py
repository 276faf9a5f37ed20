"""Numerics policy.

  - "highest":  f32 operands, IEEE f32 convolutions and matmuls (token parity)
  - "high":     f32 operands, TF32 allowed in cuDNN convolutions and cuBLAS
                matmuls (not measured against the goldens on Hopper)
  - "default":  the same as "high" on this card (not measured either)
  - "bfloat16": bf16 operands for the plain convolutions (speed)

The hand-written f32 kernels keep f32 accuracy under every policy: f32
FMAs, or 3xTF32 split precision on the tensor cores (K1, K3, K4, K5's f32
path).

cuDNN runs f32 convolutions in TF32 unless told otherwise, which costs
about three decimal digits and flips late-codebook tokens. A policy
therefore sets both TF32 switches for the duration of a forward pass,
through :meth:`Policy.numerics`, and restores them afterwards: the package
mutates no global numerics state.
"""

import contextlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    name: str
    compute_dtype: torch.dtype
    allow_tf32: bool

    @contextlib.contextmanager
    def numerics(self):
        """Set cuDNN's and cuBLAS's TF32 switches to this policy's, and
        restore the caller's on exit."""
        saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.allow_tf32
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


_POLICIES = {
    "highest": Policy("highest", torch.float32, False),
    "high": Policy("high", torch.float32, True),
    "default": Policy("default", torch.float32, True),
    "bfloat16": Policy("bfloat16", torch.bfloat16, False),
}


def get_policy(name) -> Policy:
    if isinstance(name, Policy):
        return name
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {name!r}; use one of {list(_POLICIES)}"
        ) from None
