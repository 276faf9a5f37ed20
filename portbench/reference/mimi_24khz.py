"""Plain PyTorch reference of Mimi's encode side (``kyutai/mimi``; Defossez
et al., Moshi, arXiv:2410.00037), in IEEE float32, and the number that
judges the program's codes.

Written from the published config and transformers' ``modeling_mimi.py``
equations: SEANet of 64 filters (causal convs zero-padded by K_eff -
stride on the left and the extra on the right that completes the last
frame, ELU, one residual block a stage of kernel 3 then 1 with an identity
shortcut, strided down-convs of kernel 2r, no LSTM, a last conv of kernel
3); 8 pre-LN transformer layers on [B, T, 512] (LayerNorm with weight and
bias, RoPE at positions 0..T-1 in the rotate-half form, 8 heads of 64,
scale 1/8, dense scores masked to the causal window of 250 frames, exact
GELU MLP of 2048, no biases, LayerScale on both sub-layers); a downsample
conv of kernel 4 and stride 2, no bias, replicate-padded; the split RVQ:
``s = P_s z`` quantized by codebook 0, ``a = P_a z`` by codebooks 1.. as a
residual chain, nearest codeword by Euclidean distance.

One departure from transformers 4.57, on purpose: its eager and SDPA
attention attend to every earlier frame (``create_causal_mask``), while the
published model bounds attention to ``sliding_window`` = 250 frames, which
this reference follows; the two agree up to 250 frames (10 s).

The parameters are named as the program's ``MimiEncode`` state dict names
them (``seanet.*``, ``layers.<i>.{norm1, in_proj, out_proj, scale1, norm2,
fc1, fc2, scale2}``, ``downsample``, ``semantic_proj``, ``acoustic_proj``,
``semantic_codebooks``, ``acoustic_codebooks``); ``in_proj`` is q, k and v
stacked. Imports torch, numpy and the benchmark's own modules, never the
program.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.encodec_24khz import code_gap, ieee_f32, row_blocks
from portbench.seeded import generator, make_weights as _draw

# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

#: LayerScale's draw, mean and spread: each sub-layer then moves the
#: residual stream by about a third to a half of its own norm (the
#: published initial value, 0.01, would leave the attention invisible)
LAYER_SCALE = (0.25, 0.05)


def _conv(spec, name, cout, cin, k, bias=True):
    spec.append((f"{name}.weight", (cout, cin, k), math.sqrt(2.0 / (k * cin)), 0.0))
    if bias:
        spec.append((f"{name}.bias", (cout,), 0.02, 0.0))


def seanet_spec(cfg):
    """(name, shape, std, base) of every SEANet leaf."""
    spec, dim = [], cfg["num_filters"]
    _conv(spec, "seanet.conv_in", dim, cfg["audio_channels"], cfg["kernel_size"])
    for i, r in enumerate(reversed(cfg["upsampling_ratios"])):
        h = dim // cfg["compress"]
        _conv(spec, f"seanet.stages.{i}.res.0.conv1", h, dim, cfg["residual_kernel_size"])
        _conv(spec, f"seanet.stages.{i}.res.0.conv2", dim, h, 1)
        _conv(spec, f"seanet.stages.{i}.down", 2 * dim, dim, 2 * r)
        dim *= 2
    _conv(spec, "seanet.conv_out", cfg["hidden_size"], dim, cfg["last_kernel_size"])
    return spec


def encoder_spec(cfg):
    """(name, shape, std, base) of every leaf but the codebooks (``fit``'s)."""
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    spec = seanet_spec(cfg)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        for n, shape in (("in_proj", (3 * D, D)), ("out_proj", (D, D)), ("fc1", (I, D)),
                         ("fc2", (D, I))):
            spec.append((p + n, shape, 1.0 / math.sqrt(shape[1]), 0.0))
        for n in ("norm1", "norm2"):
            spec.append((p + n + ".weight", (D,), 0.1, 1.0))
            spec.append((p + n + ".bias", (D,), 0.1, 0.0))
        for n in ("scale1", "scale2"):
            spec.append((p + n, (D,), LAYER_SCALE[1], LAYER_SCALE[0]))
    k = 2 * cfg["downsample_stride"]
    spec.append(("downsample", (D, D, k), 1.0 / math.sqrt(D * k), 0.0))
    for n in ("semantic_proj", "acoustic_proj"):
        spec.append((n, (cfg["vector_quantization_hidden_dimension"], D), 1.0 / math.sqrt(D), 0.0))
    return spec


def make_weights(cfg, mix, seed: int, device) -> dict:
    """The seed's weights for encode: ``{"encoder": {leaf: tensor}}``, from
    the stream "weights.encoder" (the codebooks are ``fit``'s)."""
    return {"encoder": _draw(encoder_spec(cfg), seed, "weights.encoder", device)}


def fit(cfg, mix, weights, pool, seed: int, device) -> dict:
    """The codebooks, made from the traffic so that its frames spread over
    the codewords: for each stage in turn, codewords drawn from a normal
    distribution with each dimension's mean and spread of that stage's
    inputs (``s`` for the semantic codebook; ``a``, then each residual
    after the codebooks fitted before it, for the acoustic chain) over the
    frames of the first two rows of every request of ``pool``, computed as
    the check computes them, on each row's own length."""
    S, K, C = cfg["num_semantic_quantizers"], cfg["num_quantizers"], cfg["codebook_size"]
    W = weights["encoder"]
    g = generator(seed, "weights.codebooks", device)
    s_all, a_all = [], []
    with torch.inference_mode(), ieee_f32():
        for req in pool:
            for n, rows in row_blocks(req.lengths[:2], 2):
                wav = torch.as_tensor(req.batch[rows, :n], device=device).float() / 32768.0
                s, a = projections(W, cfg, latents(W, cfg, wav))
                s_all.append(s.reshape(-1, s.shape[-1]))
                a_all.append(a.reshape(-1, a.shape[-1]))

        def chain(r, n):
            books = []
            for _ in range(n):
                mu, sd = r.mean(0), r.std(0)
                cb = mu + sd * torch.randn((C, r.shape[1]), generator=g, device=device)
                books.append(cb)
                r = r - cb[nearest(r, cb)]
            return torch.stack(books)

        return {"semantic_codebooks": chain(torch.cat(s_all), S),
                "acoustic_codebooks": chain(torch.cat(a_all), K - S)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def conv1d(x, w, b, stride=1, mode="constant"):
    """Mimi's causal conv of x [B, C, T]: K - stride samples of padding on
    the left and, on the right, what completes the last frame; zeros, or
    the edge samples repeated (``mode="replicate"``)."""
    k = w.shape[-1]
    pad = k - stride
    length = x.shape[-1]
    n_frames = (length - k + pad) / stride + 1
    extra = (math.ceil(n_frames) - 1) * stride + k - pad - length
    x = F.pad(x, (pad, extra), mode=mode)
    return F.conv1d(x, w, b, stride=stride)


def seanet(W, cfg, wav):
    """wav [B, N] -> [B, hidden, ceil(N / hop)] at 25 Hz."""
    h = conv1d(wav[:, None, :], W["seanet.conv_in.weight"], W["seanet.conv_in.bias"])
    for i, r in enumerate(reversed(cfg["upsampling_ratios"])):
        p = f"seanet.stages.{i}."
        y = conv1d(F.elu(h), W[p + "res.0.conv1.weight"], W[p + "res.0.conv1.bias"])
        y = conv1d(F.elu(y), W[p + "res.0.conv2.weight"], W[p + "res.0.conv2.bias"])
        h = h + y  # identity shortcut
        h = conv1d(F.elu(h), W[p + "down.weight"], W[p + "down.bias"], stride=r)
    return conv1d(F.elu(h), W["seanet.conv_out.weight"], W["seanet.conv_out.bias"])


def _rope(T, dh, theta, device):
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.int64, device=device).float() / dh))
    ang = torch.arange(T, device=device).float()[:, None] * inv[None, :]
    emb = torch.cat((ang, ang), dim=-1)
    return emb.cos(), emb.sin()


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat((-x[..., half:], x[..., :half]), dim=-1) * sin


def band(T, window, device):
    """[T (query), T (key)]: key j visible to query i iff i - window < j <= i."""
    t = torch.arange(T, device=device)
    return (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - window)


def layer(W, i, cfg, h, cos, sin, mask):
    """One transformer layer on h [B, T, D]."""
    p = f"layers.{i}."
    B, T, D = h.shape
    H = cfg["num_attention_heads"]
    dh = D // H
    eps = cfg["norm_eps"]
    x = F.layer_norm(h, (D,), W[p + "norm1.weight"], W[p + "norm1.bias"], eps)
    wq, wk, wv = W[p + "in_proj"].chunk(3)

    def heads(w):
        return (x @ w.t()).view(B, T, H, dh).transpose(1, 2)

    q, k, v = _rotate(heads(wq), cos, sin), _rotate(heads(wk), cos, sin), heads(wv)
    s = (q @ k.transpose(-1, -2)) * dh**-0.5
    s = s.masked_fill(~mask, float("-inf"))
    a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, T, D)
    h = h + W[p + "scale1"] * (a @ W[p + "out_proj"].t())
    x = F.layer_norm(h, (D,), W[p + "norm2.weight"], W[p + "norm2.bias"], eps)
    return h + W[p + "scale2"] * (F.gelu(x @ W[p + "fc1"].t()) @ W[p + "fc2"].t())


def latents(W, cfg, wav):
    """wav [B, N] -> the downsampled latents [B, ceil(N / (hop * stride)), D]."""
    h = seanet(W, cfg, wav).transpose(1, 2)  # [B, T, D]
    T = h.shape[1]
    cos, sin = _rope(T, cfg["hidden_size"] // cfg["num_attention_heads"], cfg["rope_theta"],
                     h.device)
    mask = band(T, cfg["sliding_window"], h.device)
    for i in range(cfg["num_hidden_layers"]):
        h = layer(W, i, cfg, h, cos, sin, mask)
    z = conv1d(h.transpose(1, 2), W["downsample"], None, stride=cfg["downsample_stride"],
               mode="replicate")
    return z.transpose(1, 2)


def projections(W, cfg, z):
    """The split RVQ's inputs: s = P_s z and a = P_a z, [B, T, codebook_dim]."""
    return z @ W["semantic_proj"].t(), z @ W["acoustic_proj"].t()


def nearest(r, cb):
    """[N] the nearest codeword of each row of r [N, D] in cb [C, D], by
    Euclidean distance, ties to the first index."""
    d = (r * r).sum(-1, keepdim=True) - 2.0 * r @ cb.t() + (cb * cb).sum(-1)
    return d.argmin(-1)


def encode(W, cfg, wav, num_q: int):
    """wav [B, N] -> codes [B, num_q, frames], the reference's own (IEEE
    f32): semantic first, then the acoustic chain."""
    s, a = projections(W, cfg, latents(W, cfg, wav))
    B, T, _ = s.shape
    S = W["semantic_codebooks"].shape[0]
    codes = []
    for r, books in ((s, W["semantic_codebooks"][:num_q]),
                     (a, W["acoustic_codebooks"][:max(0, num_q - S)])):
        r = r.reshape(B * T, -1)
        for cb in books:
            idx = nearest(r, cb)
            codes.append(idx.view(B, T))
            r = r - cb[idx]
    return torch.stack(codes, dim=1)


# ---------------------------------------------------------------------------
# the number that judges the program
# ---------------------------------------------------------------------------


def _frames(cfg, samples: int) -> int:
    hop = math.prod(cfg["upsampling_ratios"]) * cfg["downsample_stride"]
    return -(-samples // hop)


def encode_check(weights, cfg, req, codes, device, block: int = 8) -> dict:
    """{"code_gap": ...} of the program's codes [B, K, T] for the int16 PCM
    rows of ``req`` it encoded: EnCodec's measure (``encodec_24khz.
    code_gap``) on each RVQ chain, following the program's codes along the
    reference's own residuals, ``s`` for codebook 0 and ``a`` for codebooks
    1..K-1; the reference run on each row's own length in blocks of
    ``block`` rows. Each row is judged on the frames that lie wholly
    inside it (all 375 of a 30 s row): a partial last frame depends on the
    padding, the program's bucket or the reference's own."""
    W = weights["encoder"]
    sem, aco = weights["semantic_codebooks"], weights["acoustic_codebooks"]
    S, K = sem.shape[0], cfg["encode_codebooks"]
    pcm16, width = req.batch, req.batch.shape[1]
    hop = math.prod(cfg["upsampling_ratios"]) * cfg["downsample_stride"]
    if codes.shape != (pcm16.shape[0], K, _frames(cfg, width)):
        return {"code_gap": float("inf")}
    worst = 0.0
    with torch.inference_mode(), ieee_f32():
        for n, rows in row_blocks(req.lengths, block):
            wav = torch.as_tensor(pcm16[rows, :n], device=device).float() / 32768.0
            frames = n // hop
            s, a = projections(W, cfg, latents(W, cfg, wav)[:, :frames])
            c = torch.as_tensor(np.asarray(codes[rows, :, :frames]), device=device)
            worst = max(worst, code_gap(s, sem[:min(K, S)], c[:, :S]))
            if K > S:
                worst = max(worst, code_gap(a, aco[:K - S], c[:, S:]))
    return {"code_gap": worst}
