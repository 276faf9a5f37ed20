"""Numerics policy, and the per-stage precision map of semantic_m.

Each policy mirrors the JAX package's policy of the same name: its compute
dtype, and the ``jax.lax.Precision`` its f32 products run at, which maps to
the card by one rule (:data:`TF32`):

  - ``HIGHEST`` -> f32 accuracy: IEEE f32 in cuBLAS and cuDNN, or 3xTF32
    split precision on the tensor cores in the hand-written kernels;
  - ``HIGH`` and ``DEFAULT`` -> TF32 (a 10-bit mantissa on the tensor cores).

So:

  - "highest":  f32 operands, f32-accurate convolutions and matmuls (token
                parity): the semantic_m conformer's linears on the 3xTF32
                GEMM (``ops/linear.py:Linear``, which takes it wherever
                cuBLAS's TF32 switch is off), the other matmuls and the
                convolutions IEEE f32 in cuBLAS and cuDNN
  - "high":     f32 operands, TF32 in cuDNN and cuBLAS
  - "default":  the same as "high" on this card
  - "bfloat16": bf16 operands where the JAX package computes in bf16 (the
                plain convolutions of EnCodec, the semantic encoders' first
                norm); its f32 products run in TF32, as ``DEFAULT``'s do

The hand-written f32 kernels follow the JAX kernels they port. K1, K2 and
K3 take no precision in the JAX package (their dots are fixed at
``HIGHEST``), so they keep f32 accuracy under every policy: f32 FMAs, or
3xTF32 split precision on the tensor cores. K4 and K5's f32 path take the
JAX kernel's ``precision``, which their callers pass explicitly: 3xTF32 at
``HIGHEST``, one TF32 pass at ``HIGH`` (which the JAX kernel lowers to
``DEFAULT``) and ``DEFAULT``; so ``high``, ``default`` and ``bfloat16``
run them in one pass, as the JAX package runs its attention kernel.

cuDNN runs f32 convolutions in TF32 unless told otherwise, which costs
about three decimal digits and flips late-codebook tokens. A policy
therefore sets both TF32 switches for the duration of a forward pass,
through :meth:`Policy.numerics`, and a stage map for one call, through
:meth:`StagePrecision.numerics`; both restore them afterwards: the package
mutates no global numerics state.
"""

import contextlib
from dataclasses import dataclass

import torch

#: the JAX ``Precision`` member (by name) -> TF32 allowed in cuBLAS and cuDNN
TF32 = {"highest": False, "high": True, "default": True}


@contextlib.contextmanager
def tf32_numerics(allow: bool):
    """Set cuDNN's and cuBLAS's TF32 switches to ``allow``, and restore the
    caller's on exit."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@dataclass(frozen=True)
class Policy:
    name: str
    compute_dtype: torch.dtype
    matmul_precision: str  # the JAX Precision member it mirrors: a key of TF32

    @property
    def allow_tf32(self) -> bool:
        return TF32[self.matmul_precision]

    def numerics(self):
        """This policy's TF32 switches for a forward pass."""
        return tf32_numerics(self.allow_tf32)


_POLICIES = {
    "highest": Policy("highest", torch.float32, "highest"),
    "high": Policy("high", torch.float32, "high"),
    "default": Policy("default", torch.float32, "default"),
    "bfloat16": Policy("bfloat16", torch.bfloat16, "default"),
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


class StagePrecision:
    """Per-stage precision map of the semantic_m forward path.

    Counterpart of ``audiotoken_tpu/runtime/precision.py:StagePrecision``.
    Calling it with a stage name gives that stage's setting, the name of a
    JAX ``Precision`` member (a key of :data:`TF32`): the override if there
    is one, else the default. :meth:`numerics` sets the TF32 switches for
    one stage's call. The stages:

        fbank        the mel product of the fbank front (nn/fbank.py; its
                     DFT product is folded in float64 under every setting)
        proj         feature projection 160 -> 1024
        ffn_in       both half-step FFNs' H -> 4H linears (all blocks)
        ffn_out      both FFNs' 4H -> H linears
        attn_qkv     q/k/v projections
        attn_scores  the q.k^T product of the JAX package's XLA attention
        attn_pos     its q.E^T distance-embedding product
        attn_pv      its probs.v product
        attn_out     attention output projection
        attn_kernel  every product inside the attention kernel
        conv         the conv module's two pointwise linears
        vq           the nearest-centroid distance product (ops/lookup.py)

    The port's attention is kernel K4, which takes ``attn_kernel``'s
    setting as its ``precision``: 3xTF32 (f32-accurate) at ``highest``, one
    TF32 pass at ``high`` and ``default``. The port has no XLA attention
    path, so ``attn_scores``, ``attn_pos`` and ``attn_pv`` are accepted and
    have no effect, as on the JAX package's flash path.
    The conv module's depthwise conv is not a stage: it is IEEE f32 under
    every setting, as the JAX package's shift-sum has no precision at all.

    Values are policy names ("high", "bfloat16", ...) or :class:`Policy`.
    """

    STAGES = (
        "fbank", "proj", "ffn_in", "ffn_out", "attn_qkv", "attn_scores",
        "attn_pos", "attn_pv", "attn_out", "attn_kernel", "conv", "vq",
    )

    def __init__(self, default, overrides=None):
        self.default = self._resolve(default)
        self.overrides = {}
        for stage, val in (overrides or {}).items():
            if stage not in self.STAGES:
                raise ValueError(
                    f"unknown precision stage {stage!r}; use one of {self.STAGES}"
                )
            self.overrides[stage] = self._resolve(val)

    @staticmethod
    def _resolve(val) -> str:
        return get_policy(val).matmul_precision

    def __call__(self, stage: str) -> str:
        return self.overrides.get(stage, self.default)

    def allow_tf32(self, stage: str) -> bool:
        return TF32[self(stage)]

    def numerics(self, stage: str):
        """``stage``'s TF32 switches for one call."""
        return tf32_numerics(self.allow_tf32(stage))

    def __repr__(self):
        return f"StagePrecision({self.default!r}, {self.overrides})"


def bf16_norm(x: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    """The normalisation of a bf16 ``x`` over ``dim`` as the JAX package's
    jitted bf16 LayerNorm and GroupNorm compute it: the mean and variance in
    f32, each rounded to bf16; ``x - mean`` rounded to bf16; rsqrt of
    ``var + eps`` (``eps`` rounded to bf16, as a weakly typed scalar is) in
    f32, rounded to bf16; their product in f32 -> f32. The affine follows in
    f32. (PyTorch's bf16 ``rsqrt`` rounds the square root before the
    reciprocal, which misses bf16's nearest value in about one row of 100.)"""
    xf = x.float()
    mu = xf.mean(dim, keepdim=True).to(x.dtype)
    var = xf.var(dim, unbiased=False, keepdim=True).to(x.dtype)
    r = torch.rsqrt((var + torch.tensor(eps, dtype=x.dtype)).float()).to(x.dtype)
    return (x - mu).float() * r.float()


#: The "mixed" mode of semantic_m: the stages that run at "highest" while
#: the rest run at "high" (TF32). Derived on an H100 by
#: ``scripts/bisect_precision_torch.py`` over 4 seeds x 12 cases of
#: ``battery_semantic_m.npz`` (tests/torch_goldens/BISECT_H100.log), not
#: taken from the TPU map, which was measured on bf16x3 numerics: each of
#: the five stage groups (front, ffn, attn, conv, vq) moves exactness-row
#: ids when it alone runs in TF32, and no group's promotion alone restores
#: "highest"'s ids. So every stage stays at "highest", and on this card
#: "mixed" gives "highest"'s tokens at "highest"'s speed.
W2VBERT_MIXED_OVERRIDES = {stage: "highest" for stage in StagePrecision.STAGES}


def resolve_mixed(precision, stage_overrides, mixed_overrides):
    """Expand the named "mixed" policy into (base policy, overrides);
    explicit ``stage_overrides`` win over the named set."""
    if precision == "mixed":
        return "high", {**mixed_overrides, **(stage_overrides or {})}
    return precision, stage_overrides


def as_stage_precision(precision) -> StagePrecision:
    """A policy name or :class:`Policy` as a constant stage map;
    :class:`StagePrecision` instances pass through."""
    if isinstance(precision, StagePrecision):
        return precision
    return StagePrecision(precision)
