"""Operations and bytes of Mimi's encode side, from the shapes a call runs,
as the plain algorithm needs them.

An operation is a multiply or an add of a product: a conv of ``c_in`` ->
``c_out`` channels, kernel ``k``, over ``L`` output positions is ``2 * k *
c_in * c_out * L``, a linear the same with ``k`` 1. The window attention
is ``4 * dh`` a (query, key) pair in the band (q k^T and p v), a head and a
layer; the RVQ ``2 * C * D`` a row and codebook. Element-wise work (ELU,
norms, RoPE, softmax, GELU, LayerScale, biases, the residual updates) is
not counted. Bytes count each input read once and each output written
once, in f32.
"""

import math


def _frames(cfg, samples: int):
    """(25 Hz frames, code frames) of a row of ``samples``."""
    T = samples
    for r in reversed(cfg["upsampling_ratios"]):
        T = -(-T // r)
    return T, -(-T // cfg["downsample_stride"])


def pairs(T: int, window: int) -> int:
    """(query, key) pairs in the causal band of ``window`` over T frames."""
    w = min(T, window)
    return w * (w + 1) // 2 + (T - w) * w


def seanet_row(cfg, samples: int) -> float:
    d, L = cfg["num_filters"], samples
    ops = 2 * L * cfg["kernel_size"] * cfg["audio_channels"] * d
    for r in reversed(cfg["upsampling_ratios"]):
        h = d // cfg["compress"]
        ops += 2 * L * (cfg["residual_kernel_size"] * d * h + h * d)
        L = -(-L // r)
        ops += 2 * L * (2 * r) * d * (2 * d)
        d *= 2
    return ops + 2 * L * cfg["last_kernel_size"] * d * cfg["hidden_size"]


def encode_row(cfg, samples: int) -> float:
    """Operations to encode one row of ``samples``."""
    T, Tc = _frames(cfg, samples)
    D, I, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    linears = 2 * T * (4 * D * D + 2 * D * I)
    attn = 4 * cfg["head_dim"] * cfg["num_attention_heads"] * pairs(T, cfg["sliding_window"])
    down = 2 * Tc * 2 * cfg["downsample_stride"] * D * D
    dc = cfg["vector_quantization_hidden_dimension"]
    rvq = 2 * Tc * (2 * D * dc + cfg["encode_codebooks"] * cfg["codebook_size"] * dc)
    return seanet_row(cfg, samples) + n * (linears + attn) + down + rvq


def step_flops(cfg, path: str, lengths):
    """Operations of one encode call on rows ``lengths`` samples long (None
    for another entry)."""
    if path != "encode":
        return None
    return sum(encode_row(cfg, int(n)) for n in lengths)


def window_attention(cfg, path: str, lengths):
    """(operations, bytes) of the window kernel in one call, every layer:
    ``4 * dh`` a pair in the band, each head; reading q, k and v and writing
    the output once, [T, dh] each a head."""
    if path != "encode":
        return None
    H, dh, n = cfg["num_attention_heads"], cfg["head_dim"], cfg["num_hidden_layers"]
    flops = nbytes = 0
    for x in lengths:
        T, _ = _frames(cfg, int(x))
        flops += n * H * 4 * dh * pairs(T, cfg["sliding_window"])
        nbytes += n * H * 4 * 4 * T * dh
    return flops, nbytes


def rvq(cfg, path: str, lengths):
    """(operations, bytes) of K3 in one call, both launches: ``2 * C * D`` a
    row and codebook; reading the rows and the codebooks once and writing
    the codes (int32) once."""
    if path != "encode":
        return None
    K, C, D = cfg["encode_codebooks"], cfg["codebook_size"], cfg["codebook_dim"]
    S = min(K, cfg["num_semantic_quantizers"])
    rows = sum(_frames(cfg, int(x))[1] for x in lengths)
    flops = 2 * rows * K * C * D
    launches = 1 + (K > S)
    nbytes = 4 * (launches * rows * D + K * C * D + K * rows)
    return flops, nbytes
