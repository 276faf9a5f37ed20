"""Plain PyTorch reference of EnCodec 24 kHz (Defossez et al., arXiv:2210.13438):
the SEANet encoder and decoder, their 2-layer LSTM, residual VQ, in IEEE
float32, and the numbers that judge the program's codes and waveforms.

Written from the published architecture (the ``facebook/encodec_24khz``
config): causal convs with reflect padding and EnCodec's extra right
padding, ELU, one residual block a stage (kernel 3 then 1, dilation 1, a
1x1 conv shortcut), strided down-convs of kernel 2r, the LSTM with a
residual skip, transposed up-convs trimmed on the right. Weight norm is
folded into plain weights. Imports torch, numpy and the benchmark's own
seeded draws, never the program.

The parameters are named as the configuration's layers are: ``conv_in``,
``stages.<i>.res.0.{conv1,conv2,shortcut}``, ``stages.<i>.down`` (encoder)
or ``stages.<i>.up`` (decoder), ``lstm.<l>.{wih,whh,bih,bhh}``,
``conv_out``, and ``codebooks`` [n_q, codebook_size, codebook_dim].
"""

import contextlib
import math

import numpy as np

import torch
import torch.nn.functional as F

from portbench.seeded import make_weights as _draw


@contextlib.contextmanager
def tf32(allow: bool):
    """The f32 products and convolutions in TF32 (``allow``) or in IEEE f32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def ieee_f32():
    """The f32 products and convolutions in IEEE f32 (TF32 off)."""
    return tf32(False)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

#: std of the decoder's last conv: puts the waveform of random codes at an
#: rms of about 0.3 of full scale, so that a few samples in a thousand clip
DECODER_OUT_STD = 0.01


def _hop(cfg) -> int:
    return math.prod(cfg["upsampling_ratios"])


def _conv(spec, name, cout, cin, k, transposed=False):
    std = math.sqrt(2.0 / (k * cin))
    shape = (cin, cout, k) if transposed else (cout, cin, k)
    spec.append((f"{name}.weight", shape, std, 0.0))
    spec.append((f"{name}.bias", (cout,), 0.02, 0.0))


def _res(spec, name, cfg, dim):
    hidden = dim // cfg["compress"]
    _conv(spec, f"{name}.conv1", hidden, dim, cfg["residual_kernel_size"])
    _conv(spec, f"{name}.conv2", dim, hidden, 1)
    _conv(spec, f"{name}.shortcut", dim, dim, 1)


def _lstm(spec, cfg, dim):
    std = 1.0 / math.sqrt(3 * dim)  # PyTorch's uniform(-1/sqrt(H), 1/sqrt(H)) spread
    for l in range(cfg["num_lstm_layers"]):
        for n, shape in (("wih", (4 * dim, dim)), ("whh", (4 * dim, dim)),
                         ("bih", (4 * dim,)), ("bhh", (4 * dim,))):
            spec.append((f"lstm.{l}.{n}", shape, std, 0.0))


def encoder_spec(cfg):
    """(name, shape, std, base) of every encoder leaf."""
    spec, dim = [], cfg["num_filters"]
    _conv(spec, "conv_in", dim, cfg["audio_channels"], cfg["kernel_size"])
    for i, r in enumerate(reversed(cfg["upsampling_ratios"])):
        _res(spec, f"stages.{i}.res.0", cfg, dim)
        _conv(spec, f"stages.{i}.down", 2 * dim, dim, 2 * r)
        dim *= 2
    _lstm(spec, cfg, dim)
    _conv(spec, "conv_out", cfg["hidden_size"], dim, cfg["last_kernel_size"])
    return spec


def decoder_spec(cfg):
    """(name, shape, std, base) of every decoder leaf; ``conv_out`` is
    scaled so that the waveform sits well inside full scale."""
    spec = []
    dim = cfg["num_filters"] * 2 ** len(cfg["upsampling_ratios"])
    _conv(spec, "conv_in", dim, cfg["hidden_size"], cfg["kernel_size"])
    _lstm(spec, cfg, dim)
    for i, r in enumerate(cfg["upsampling_ratios"]):
        _conv(spec, f"stages.{i}.up", dim // 2, dim, 2 * r, transposed=True)
        _res(spec, f"stages.{i}.res.0", cfg, dim // 2)
        dim //= 2
    spec.append(("conv_out.weight", (cfg["audio_channels"], dim, cfg["last_kernel_size"]),
                 DECODER_OUT_STD, 0.0))
    spec.append(("conv_out.bias", (cfg["audio_channels"],), 0.0, 0.0))
    return spec


def codebook_spec(cfg):
    return [("codebooks", (cfg["num_quantizers"], cfg["codebook_size"], cfg["codebook_dim"]),
             1.0, 0.0)]


def make_weights(cfg, mix, seed: int, device) -> dict:
    """The seed's weights for the mix's path ("encode" or "decode"): the
    encoder's or the decoder's leaves and the codebooks, each part from a
    stream of its own."""
    part = "encoder" if mix["path"] == "encode" else "decoder"
    spec = encoder_spec(cfg) if part == "encoder" else decoder_spec(cfg)
    return {part: _draw(spec, seed, f"weights.{part}", device),
            "codebooks": _draw(codebook_spec(cfg), seed, "weights.codebooks", device)["codebooks"]}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def conv1d(x, w, b, stride=1, dilation=1):
    """EnCodec's causal conv of x [B, C, T]: reflect padding of K_eff -
    stride on the left, and on the right what lands the last window on the
    end of the input."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    pad = k_eff - stride
    length = x.shape[-1]
    n_frames = (length - k_eff + pad) / stride + 1
    extra = (math.ceil(n_frames) - 1) * stride + k_eff - pad - length
    grow = max(0, max(pad, extra) - length + 1)  # reflect needs a longer signal
    if grow:
        x = F.pad(x, (0, grow))
    x = F.pad(x, (pad, extra), mode="reflect")
    if grow:
        x = x[..., : x.shape[-1] - grow]
    return F.conv1d(x, w, b, stride=stride, dilation=dilation)


def conv_transpose1d(x, w, b, stride):
    """Causal transposed conv: of K - stride extra samples all come off the
    right (trim_right_ratio 1)."""
    out = F.conv_transpose1d(x, w, b, stride=stride)
    return out[..., : out.shape[-1] - (w.shape[-1] - stride)]


def lstm_skip(W, cfg, x):
    """x [B, T, C] -> x + LSTM_L(...LSTM_1(x)), gates (i, f, g, o), a loop
    over the steps."""
    h0 = x
    for l in range(cfg["num_lstm_layers"]):
        wih, whh = W[f"lstm.{l}.wih"], W[f"lstm.{l}.whh"]
        xi = x @ wih.t() + (W[f"lstm.{l}.bih"] + W[f"lstm.{l}.bhh"])
        B, T, _ = xi.shape
        H = whh.shape[1]
        h, c = xi.new_zeros(B, H), xi.new_zeros(B, H)
        out = xi.new_empty(B, T, H)
        for t in range(T):
            i, f, g, o = (xi[:, t] + h @ whh.t()).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[:, t] = h
        x = out
    return h0 + x


def _res_block(W, name, x):
    y = conv1d(F.elu(x), W[f"{name}.conv1.weight"], W[f"{name}.conv1.bias"])
    y = conv1d(F.elu(y), W[f"{name}.conv2.weight"], W[f"{name}.conv2.bias"])
    return conv1d(x, W[f"{name}.shortcut.weight"], W[f"{name}.shortcut.bias"]) + y


def encode_latents(W, cfg, wav):
    """wav [B, N] f32 -> latents [B, ceil(N / hop), hidden_size]."""
    h = conv1d(wav[:, None, :], W["conv_in.weight"], W["conv_in.bias"])
    for i, r in enumerate(reversed(cfg["upsampling_ratios"])):
        h = _res_block(W, f"stages.{i}.res.0", h)
        h = conv1d(F.elu(h), W[f"stages.{i}.down.weight"], W[f"stages.{i}.down.bias"], stride=r)
    h = lstm_skip(W, cfg, h.transpose(1, 2)).transpose(1, 2)
    h = conv1d(F.elu(h), W["conv_out.weight"], W["conv_out.bias"])
    return h.transpose(1, 2)


def decode_waveform(W, codebooks, cfg, codes):
    """codes [B, n_q, T] -> waveform [B, T * hop] f32."""
    codes = codes.long()
    z = sum(codebooks[k][codes[:, k]] for k in range(codes.shape[1]))  # [B, T, D]
    h = conv1d(z.transpose(1, 2), W["conv_in.weight"], W["conv_in.bias"])
    h = lstm_skip(W, cfg, h.transpose(1, 2)).transpose(1, 2)
    for i, r in enumerate(cfg["upsampling_ratios"]):
        h = conv_transpose1d(F.elu(h), W[f"stages.{i}.up.weight"], W[f"stages.{i}.up.bias"], r)
        h = _res_block(W, f"stages.{i}.res.0", h)
    return conv1d(F.elu(h), W["conv_out.weight"], W["conv_out.bias"])[:, 0, :]


# ---------------------------------------------------------------------------
# the numbers that judge the program
# ---------------------------------------------------------------------------


def code_gap(latents, codebooks, codes) -> float:
    """The program's residual-VQ codes [B, n_q, T] judged against the
    reference's latents [B, T, D]: at every frame and stage, following the
    program's own choices, how far the squared distance of the chosen
    codeword lies above the nearest one's, over the mean distance to the
    codebook. 0 where every choice is the nearest; a near tie between two
    codewords gives about the relative error of the latents. Distances in
    float64."""
    B, n_q, T = codes.shape
    r = latents.reshape(B * T, -1).double()
    idx = codes.permute(0, 2, 1).reshape(B * T, n_q).long()
    worst = 0.0
    rows = torch.arange(B * T, device=r.device)
    for k in range(n_q):
        cb = codebooks[k].double()
        d = (r * r).sum(-1, keepdim=True) - 2.0 * r @ cb.t() + (cb * cb).sum(-1)
        gap = (d[rows, idx[:, k]] - d.min(-1).values) / d.mean(-1)
        worst = max(worst, float(gap.max()))
        r = r - cb[idx[:, k]]
    return worst


def pcm16_err(wave_f32, pcm16) -> float:
    """The largest distance, in int16 steps, between the program's int16
    waveform and the reference's f32 waveform taken through the same
    save-audio clamp (0.99 of full scale) and scaling, before rounding: at
    most 0.5 where the program is exact."""
    ref = wave_f32.double().clamp(-0.99, 0.99) * 32768.0
    return float((pcm16.double() - ref).abs().max())


def row_blocks(lengths, block: int):
    """Rows grouped by equal length, in blocks of at most ``block``:
    [(length, [row, ...])]."""
    by = {}
    for i, n in enumerate(lengths):
        by.setdefault(int(n), []).append(i)
    return [(n, rows[j:j + block]) for n, rows in by.items() for j in range(0, len(rows), block)]


def encode_check(weights, cfg, req, codes, device, block: int = 8) -> dict:
    """{"code_gap": ...} of the program's codes [B, n_q, T] for the int16
    PCM rows of ``req`` it encoded, the reference run on each row's own
    length in blocks of ``block`` rows. A row shorter than the batch is
    judged on the frames that lie wholly inside it: the last, partial one
    depends on the padding."""
    W, codebooks = weights["encoder"], weights["codebooks"]
    pcm16, width, hop = req.batch, req.batch.shape[1], _hop(cfg)
    if codes.shape != (pcm16.shape[0], cfg["encode_codebooks"], -(-width // hop)):
        return {"code_gap": float("inf")}
    worst = 0.0
    with torch.inference_mode(), ieee_f32():
        for n, rows in row_blocks(req.lengths, block):
            wav = torch.as_tensor(pcm16[rows, :n], device=device).float() / 32768.0
            frames = -(-n // hop) if n == width else n // hop
            z = encode_latents(W, cfg, wav)[:, :frames]
            c = torch.as_tensor(np.asarray(codes[rows, :, :frames]), device=device)
            worst = max(worst, code_gap(z, codebooks, c))
    return {"code_gap": worst}


def decode_check(weights, cfg, req, waves, device, block: int = 8) -> dict:
    """{"pcm16_err": ...} of the program's int16 waveforms (a list of
    [1, T * hop]) for the list of codes [n_q, T] of ``req`` it decoded, the
    reference run in blocks of ``block`` rows of one length."""
    W, codebooks = weights["decoder"], weights["codebooks"]
    codes, hop = req.batch, _hop(cfg)
    if len(waves) != len(codes) or any(w.shape != (1, c.shape[-1] * hop) or w.dtype != np.int16
                                       for w, c in zip(waves, codes)):
        return {"pcm16_err": float("inf")}
    worst = 0.0
    with torch.inference_mode(), ieee_f32():
        for n, rows in row_blocks([c.shape[-1] for c in codes], block):
            c = torch.as_tensor(np.stack([codes[i] for i in rows]), device=device)
            wave = decode_waveform(W, codebooks, cfg, c)
            pcm = torch.as_tensor(np.concatenate([waves[i] for i in rows]), device=device)
            worst = max(worst, pcm16_err(wave, pcm))
    return {"pcm16_err": worst}
