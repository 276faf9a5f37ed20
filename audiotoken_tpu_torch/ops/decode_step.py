"""K7: the GPT decode step's products around the attention, one token a row.

Counterpart of ``audiotoken_tpu/ops/decode_step_fused.py``:

    decode_qkv:  qkv = LN1(x) Wqkv + bqkv
    decode_ffn:  x1 = x + a Wo + bo;  out = x1 + GELU(LN2(x1) Win + bi) Wout2 + b2

The CUDA kernels (``csrc/decode_step.cu``) compute each product as a GEMV
over the rows with an optional LayerNorm prologue and a bias / exact-GELU /
residual epilogue; ``decode_qkv`` (one product) and ``decode_ffn`` (three)
are one C call each. In bf16 (the main path) the products run on the
tensor cores as a weight stream spread over the whole card, each LayerNorm
in a small kernel of its own; in f32 (the greedy parity path) as IEEE
FMAs, the LayerNorm in the product's prologue. Weights are in torch's ``[out, in]``
layout; absent biases (the GPT has none) are None. The numerics follow the
Pallas kernels' staging, so that bf16 runs differ from the reference only
by rounding: LN statistics in f32; the normalised row, scale and shift
rounded to the activation dtype in turn; products accumulated in f32 and
rounded, then the bias, the GELU (exact erf, in f32) and the residual,
each rounded. The plain versions below spell that staging out.

``decode_ffn_tp`` is ``decode_ffn`` for a tensor-parallel rank, whose
out-projection and MLP output are row-parallel: each product's f32 sums
pass through the caller's ``reduce`` (the all-reduce over the ranks)
before their rounding, bias and residual add. It is three C calls, split
at those two points; with ``reduce`` the identity and whole weights it
computes ``decode_ffn``'s bits.
"""

import torch
import torch.nn.functional as F

from . import _build


def _layer_norm_staged(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    h = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w
    return h if b is None else h + b


def _product(x, w, b):
    y = torch.matmul(x.float(), w.float().t()).to(x.dtype)
    return y if b is None else y + b


def decode_qkv_plain(x, ln_w, ln_b, w_qkv, b_qkv=None, eps: float = 1e-5):
    """x [B, C]; ln_w, ln_b [C] (ln_b may be None); w_qkv [3C, C]; b_qkv
    [3C] or None -> [B, 3C] in x's dtype."""
    return _product(_layer_norm_staged(x, ln_w, ln_b, eps), w_qkv, b_qkv)


def decode_ffn_plain(x, a, w_out, ln_w, ln_b, w_in, w_out2, b_out=None, b_in=None,
                     b_out2=None, eps: float = 1e-5):
    """x, a [B, C]; w_out [C, C]; w_in [4C, C]; w_out2 [C, 4C] -> [B, C]."""
    x1 = x + _product(a, w_out, b_out)
    h = _product(_layer_norm_staged(x1, ln_w, ln_b, eps), w_in, b_in)
    h = F.gelu(h.float()).to(x.dtype)
    return x1 + _product(h, w_out2, b_out2)


def _sums(x, w):
    return torch.matmul(x.float(), w.float().t())


def _residual(r, s, b):
    """r + (the f32 sums s rounded to r's dtype, then the bias b)."""
    y = s.to(r.dtype)
    return r + (y if b is None else y + b)


def decode_ffn_tp_plain(x, a, w_out, ln_w, ln_b, w_in, w_out2, reduce, b_out=None, b_in=None,
                        b_out2=None, eps: float = 1e-5):
    """x [B, C]; a [B, K] (the rank's attention columns); w_out [C, K];
    w_in [H, C] (the rank's MLP columns); w_out2 [C, H]; ``reduce`` maps
    f32 sums [B, C] to their sum over the ranks -> [B, C]."""
    x1 = _residual(x, reduce(_sums(a, w_out)), b_out)
    h = _product(_layer_norm_staged(x1, ln_w, ln_b, eps), w_in, b_in)
    h = F.gelu(h.float()).to(x.dtype)
    return _residual(x1, reduce(_sums(h, w_out2)), b_out2)


#: widths the bf16 kernel takes: a LayerNorm prologue needs whole rows in
#: one block (``KR_MAX`` in csrc/decode_step.cu), any other product splits
#: its input width over at most 8 blocks of a cluster
BF16_LN_WIDTH, BF16_WIDTH = 1024, 8 * 1024


def _check(who, act, ln_width, width, **operands):
    """The device and dtype of the activations ``act``, then every operand
    (name=(tensor or None, shape)) against them. The kernel reads weights
    16 bytes at a time, so their rows must be multiples of 8 wide; in bf16
    the LN product's input width is at most ``BF16_LN_WIDTH`` and every
    other one's at most ``BF16_WIDTH``."""
    if act.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {act.device}")
    if act.dtype not in _build.DTYPE_SUFFIX:
        raise ValueError(f"{who}: dtype {act.dtype}, the kernel takes bf16 or f32")
    if act.dtype == torch.bfloat16 and (ln_width > BF16_LN_WIDTH or width > BF16_WIDTH):
        raise ValueError(f"{who}: widths {ln_width} (LN) and {width}, the bf16 kernel takes "
                         f"up to {BF16_LN_WIDTH} and {BF16_WIDTH}")
    for name, (t, shape) in operands.items():
        if t is not None:
            _build.check_tensor(t, name, shape, act.dtype, act.device, vector_loads=True)
        if len(shape) == 2 and shape[1] % 8:
            raise ValueError(f"{who}: {name} rows are {shape[1]} wide, not a multiple of 8")


def decode_qkv(x, ln_w, ln_b, w_qkv, b_qkv=None, eps: float = 1e-5):
    """The function of :func:`decode_qkv_plain`: one call of K7 for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return decode_qkv_plain(x, ln_w, ln_b, w_qkv, b_qkv, eps)
    B, C = x.shape
    N = w_qkv.shape[0]
    _check("decode_qkv", x, C, C, x=(x, (B, C)), ln_w=(ln_w, (C,)), ln_b=(ln_b, (C,)),
           w_qkv=(w_qkv, (N, C)), b_qkv=(b_qkv, (N,)))
    y = torch.empty((B, N), dtype=x.dtype, device=x.device)
    _build.launch(f"decode_qkv_{_build.DTYPE_SUFFIX[x.dtype]}", x.device,
                  x, ln_w, ln_b, w_qkv, b_qkv, y, B, C, N, eps)
    decode_qkv.launches += 1
    return y


decode_qkv.launches = 0


def decode_ffn(x, a, w_out, ln_w, ln_b, w_in, w_out2, b_out=None, b_in=None, b_out2=None,
               eps: float = 1e-5):
    """The function of :func:`decode_ffn_plain`: one call of K7 for CUDA
    tensors (the out-projection, the MLP input and the MLP output; in bf16
    with LN2 between the first two, and each kernel after the first
    starting its weight loads while the one before it runs), the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return decode_ffn_plain(x, a, w_out, ln_w, ln_b, w_in, w_out2, b_out, b_in, b_out2, eps)
    B, C = x.shape
    H = w_in.shape[0]
    _check("decode_ffn", x, C, H, x=(x, (B, C)), a=(a, (B, C)), w_out=(w_out, (C, C)),
           b_out=(b_out, (C,)), ln_w=(ln_w, (C,)), ln_b=(ln_b, (C,)), w_in=(w_in, (H, C)),
           b_in=(b_in, (H,)), w_out2=(w_out2, (C, H)), b_out2=(b_out2, (C,)))
    x1 = torch.empty_like(x)
    h = torch.empty((B, H), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.launch(f"decode_ffn_{_build.DTYPE_SUFFIX[x.dtype]}", x.device, x, a, w_out, b_out,
                  ln_w, ln_b, w_in, b_in, w_out2, b_out2, x1, h, out, B, C, H, eps)
    decode_ffn.launches += 1
    return out


decode_ffn.launches = 0


def decode_ffn_tp(x, a, w_out, ln_w, ln_b, w_in, w_out2, reduce, b_out=None, b_in=None,
                  b_out2=None, eps: float = 1e-5):
    """The function of :func:`decode_ffn_tp_plain`: one call of K7's tp
    entry for CUDA tensors (the out-projection's f32 sums; ``reduce``; the
    MLP, LN2 before it, to the MLP output's f32 sums; ``reduce``; the
    residual add), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return decode_ffn_tp_plain(x, a, w_out, ln_w, ln_b, w_in, w_out2, reduce, b_out, b_in,
                                   b_out2, eps)
    B, C = x.shape
    K, H = a.shape[1], w_in.shape[0]
    _check("decode_ffn_tp", x, C, max(K, H), x=(x, (B, C)), a=(a, (B, K)),
           w_out=(w_out, (C, K)), b_out=(b_out, (C,)), ln_w=(ln_w, (C,)), ln_b=(ln_b, (C,)),
           w_in=(w_in, (H, C)), b_in=(b_in, (H,)), w_out2=(w_out2, (C, H)),
           b_out2=(b_out2, (C,)))
    sfx, dev = _build.DTYPE_SUFFIX[x.dtype], x.device

    def reduced(s):
        s = reduce(s)
        _build.check_tensor(s, "reduce(sums)", (B, C), torch.float32, dev)
        return s

    s1 = torch.empty((B, C), dtype=torch.float32, device=dev)
    _build.launch(f"decode_ffn_tp_out_{sfx}", dev, a, w_out, s1, B, K, C)
    s1 = reduced(s1)
    x1 = torch.empty_like(x)
    h = torch.empty((B, H), dtype=x.dtype, device=dev)
    s2 = torch.empty((B, C), dtype=torch.float32, device=dev)
    _build.launch(f"decode_ffn_tp_mlp_{sfx}", dev, x, s1, b_out, ln_w, ln_b, w_in, b_in, w_out2,
                  x1, h, s2, B, C, H, eps)
    s2 = reduced(s2)
    out = torch.empty_like(x)
    _build.launch(f"decode_ffn_tp_add_{sfx}", dev, x1, s2, b_out2, out, B, C)
    decode_ffn_tp.launches += 1
    return out


decode_ffn_tp.launches = 0
