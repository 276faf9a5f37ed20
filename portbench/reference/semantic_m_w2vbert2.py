"""Plain PyTorch reference of the semantic_m tokenizer: Kaldi log-mel fbank,
the w2v-BERT 2.0 conformer (``facebook/w2v-bert-2.0``) read at block 19,
an affine-free LayerNorm and the nearest of 2048 codewords, in IEEE
float32 (the fbank in float64), and the number that judges the program's
ids.

Written from the published description: the fbank of the w2v-BERT feature
extractor (x 2^15, 25 ms frames every 10 ms, DC removal, 0.97
pre-emphasis, the povey window, a 512-point power spectrum, 80 mel bins of
20-8000 Hz on the Kaldi mel scale, log with a floor, mean and variance
normalisation over the utterance, two frames stacked to 160); then
LayerNorm and a 160 -> 1024 projection; then conformer blocks (half-step
swish FFN, self-attention with the relative_key bias of 64 left and 8
right positions, the convolution module with a GLU, a causal depthwise
conv of kernel 31 and LayerNorm, half-step FFN, final LayerNorm). Imports
torch, numpy and the benchmark's own modules, never the program.

The parameters are named as the blocks' layers are: ``fp_layer_norm``,
``projection``, ``layers.<i>.{ffn1_layer_norm, ffn1.inp, ffn1.out,
self_attn_layer_norm, attn.{q,k,v,out}, attn.distance_embedding,
conv.{layer_norm, pw1, dw_weight, dw_layer_norm, pw2}, ffn2_layer_norm,
ffn2.inp, ffn2.out, final_layer_norm}``, and ``codebook`` [2048, 1024].
"""

import json
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import encodec_24khz as encodec
from portbench.reference.encodec_24khz import ieee_f32, row_blocks
from portbench.seeded import generator, make_weights as _draw


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _linear(spec, name, din, dout, bias=True):
    spec.append((f"{name}.weight", (dout, din), 1.0 / math.sqrt(din), 0.0))
    if bias:
        spec.append((f"{name}.bias", (dout,), 0.02, 0.0))


def _norm(spec, name, d):
    spec.append((f"{name}.weight", (d,), 0.1, 1.0))
    spec.append((f"{name}.bias", (d,), 0.1, 0.0))


def encoder_spec(cfg):
    """(name, shape, std, base) of every leaf of the blocks read."""
    H, F_in, K = cfg["hidden_size"], cfg["feature_projection_input_dim"], cfg["conv_depthwise_kernel_size"]
    I, dh = cfg["intermediate_size"], cfg["hidden_size"] // cfg["num_attention_heads"]
    P = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    spec = []
    _norm(spec, "fp_layer_norm", F_in)
    _linear(spec, "projection", F_in, H)
    for i in range(cfg["output_layer"]):
        pre = f"layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            _norm(spec, f"{pre}.{ffn}_layer_norm", H)
            _linear(spec, f"{pre}.{ffn}.inp", H, I)
            _linear(spec, f"{pre}.{ffn}.out", I, H)
        _norm(spec, f"{pre}.self_attn_layer_norm", H)
        for n in ("q", "k", "v", "out"):
            _linear(spec, f"{pre}.attn.{n}", H, H)
        spec.append((f"{pre}.attn.distance_embedding", (P, dh), 0.05, 0.0))
        _norm(spec, f"{pre}.conv.layer_norm", H)
        _linear(spec, f"{pre}.conv.pw1", H, 2 * H, bias=False)
        spec.append((f"{pre}.conv.dw_weight", (H, 1, K), 1.0 / math.sqrt(K), 0.0))
        _norm(spec, f"{pre}.conv.dw_layer_norm", H)
        _linear(spec, f"{pre}.conv.pw2", H, H, bias=False)
        _norm(spec, f"{pre}.final_layer_norm", H)
    return spec


def _blocks(spec, g, ln_bias: bool):
    """The GPT's and Bark-fine's layers: pre-LN, fused qkv, 4x MLP, no
    linear biases."""
    C = g["n_embd"]
    for i in range(g["n_layer"]):
        for n in ("ln1", "ln2"):
            spec.append((f"layers.{i}.{n}.weight", (C,), 0.1, 1.0))
            if ln_bias:
                spec.append((f"layers.{i}.{n}.bias", (C,), 0.1, 0.0))
        for n, shape in (("qkv", (3 * C, C)), ("out", (C, C)), ("mlp_in", (4 * C, C)),
                         ("mlp_out", (C, 4 * C))):
            spec.append((f"layers.{i}.{n}.weight", shape, 0.02, 0.0))


def gpt_spec(cfg):
    g = cfg["decoder"]["gpt"]
    spec = [("wte", (g["vocab_size"], g["n_embd"]), 0.02, 0.0),
            ("wpe", (g["block_size"], g["n_embd"]), 0.02, 0.0),
            ("ln_f.weight", (g["n_embd"],), 0.1, 1.0)]
    _blocks(spec, g, ln_bias=False)
    return spec


def bark_fine_spec(cfg):
    b = cfg["decoder"]["bark_fine"]
    V, C = b["vocab_size"], b["n_embd"]
    spec = [(f"wtes.{i}", (V, C), 0.02, 0.0) for i in range(b["n_codes_total"])]
    spec += [("wpe", (b["block_size"], C), 0.02, 0.0), ("ln_f.weight", (C,), 0.1, 1.0),
             ("ln_f.bias", (C,), 0.1, 0.0)]
    spec += [(f"lm_heads.{i}", (V, C), 0.02, 0.0)
             for i in range(b["n_codes_total"] - b["n_codes_given"])]
    _blocks(spec, b, ln_bias=True)
    return spec


def _acoustic(cfg):
    """The configuration of the decoder's EnCodec stage."""
    path = Path(__file__).resolve().parents[1] / "configs" / f"{cfg['decoder']['acoustic']}.json"
    return json.loads(path.read_text())


def make_weights(cfg, mix, seed: int, device) -> dict:
    """The seed's weights for the mix's path, each part from a stream of its
    own: for "encode" the blocks read (the VQ codebook is ``fit``'s); for
    "decode" the GPT, Bark-fine and the EnCodec decoder with its
    codebooks."""
    if mix["path"] == "encode":
        return {"encoder": _draw(encoder_spec(cfg), seed, "weights.encoder", device)}
    return {"gpt": _draw(gpt_spec(cfg), seed, "weights.gpt", device),
            "bark_fine": _draw(bark_fine_spec(cfg), seed, "weights.bark_fine", device),
            **encodec.make_weights(_acoustic(cfg), {"path": "decode"}, seed, device)}


def fit(cfg, mix, weights, pool, seed: int, device) -> dict:
    """What the reference makes from the weights and the traffic before the
    program is built: for "encode" the VQ codebook (``fit_codebook``)."""
    if mix["path"] != "encode":
        return {}
    return {"codebook": fit_codebook(cfg, weights["encoder"], pool, seed, device)}


def fit_codebook(cfg, encoder, pool, seed: int, device) -> torch.Tensor:
    """The VQ codebook [num_clusters, hidden], made so that the ids show how
    exactly the program computed the states: pairs of codewords on either
    side of the normalised block-``output_layer`` state ``s`` (this
    reference's, in IEEE f32) of a frame of the traffic, ``s + (+-R + r)
    u``: a random direction ``u``, an arm ``R`` of a quarter of a state's
    norm, and a rung ``r`` drawn log-uniformly from 1e-6 to 1e-1 of a
    state's component scale. The reference's state lies nearer the ``-R``
    codeword, by ``4 R r``; a state moved by more than ``r`` along ``u``
    picks the other, and the rungs that the program's ids cross read the
    error of its states on every seed, whatever the frames' natural ties
    (random codewords leave every frame far nearer one codeword than the
    next), and well above the f32 rounding of the distances the VQ takes
    (the arm keeps the two codewords far apart). The frames are drawn from
    the first two rows of each request of ``pool``, whose states are
    computed as the check computes them, on each row's own length."""
    pairs = cfg["num_clusters"] // 2
    states = []
    with torch.inference_mode(), ieee_f32():
        for req in pool:
            for n, rows in row_blocks(req.lengths[:2], 2):
                wav = torch.as_tensor(req.batch[rows, :n], device=device).float() / 32768.0
                h = features(encoder, cfg, wav)
                states.append(F.layer_norm(h, h.shape[-1:], eps=1e-5).reshape(-1, h.shape[-1]))
        s = torch.cat(states)
        g = generator(seed, "weights.codebook", device)
        frames = torch.randperm(s.shape[0], generator=g, device=device)[:pairs]
        u = torch.randn((pairs, s.shape[1]), generator=g, device=device)
        u = u / u.norm(dim=-1, keepdim=True)
        arm = s.shape[1] ** 0.5 / 4
        rungs = torch.logspace(-6, -1, pairs, device=device)[:, None]
        return torch.cat([s[frames] + (arm + rungs) * u, s[frames] + (rungs - arm) * u])


# ---------------------------------------------------------------------------
# fbank, float64
# ---------------------------------------------------------------------------


def _mel(cfg) -> np.ndarray:
    """[fft/2 + 1, mel bins] triangular filters on the Kaldi mel scale
    (1127 ln(1 + f / 700)), over the bins' centre frequencies, the Nyquist
    bin left out."""
    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    n_fft, M = cfg["fft_length"], cfg["num_mel_bins"]
    edges = np.linspace(mel(cfg["min_frequency"]), mel(cfg["max_frequency"]), M + 2)
    bins = mel(cfg["sampling_rate"] / n_fft * np.arange(n_fft // 2))
    lo, mid, hi = edges[:-2], edges[1:-1], edges[2:]
    up = (bins[:, None] - lo) / (mid - lo)
    down = (hi - bins[:, None]) / (hi - mid)
    fb = np.maximum(0.0, np.minimum(up, down))
    return np.concatenate([fb, np.zeros((1, M))])


def fbank(cfg, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, N] (in [-1, 1]) -> normalised, stacked features
    [B, frames // 2, 2 * mel bins] f32, computed in float64."""
    L, hop, n_fft = cfg["frame_length"], cfg["hop_length"], cfg["fft_length"]
    x = wav.double() * 2.0**15
    frames = x.unfold(-1, L, hop)  # [B, F, L]
    frames = frames - frames.mean(-1, keepdim=True)
    pre = cfg["preemphasis"]
    frames = torch.cat([frames[..., :1] * (1 - pre), frames[..., 1:] - pre * frames[..., :-1]], -1)
    n = torch.arange(L, dtype=torch.float64, device=wav.device)
    frames = frames * (0.5 - 0.5 * torch.cos(2 * math.pi * n / (L - 1))) ** 0.85
    power = torch.fft.rfft(frames, n=n_fft).abs() ** 2  # [B, F, n_fft/2 + 1]
    mel = torch.as_tensor(_mel(cfg), device=wav.device)
    feats = torch.log(torch.clamp(power @ mel, min=cfg["mel_floor"]))
    feats = (feats - feats.mean(1, keepdim=True)) / torch.sqrt(feats.var(1, unbiased=False,
                                                                         keepdim=True) + 1e-7)
    B, Fr, M = feats.shape
    keep = Fr - Fr % cfg["stride"]
    return feats[:, :keep].reshape(B, keep // cfg["stride"], M * cfg["stride"]).float()


# ---------------------------------------------------------------------------
# conformer, float32
# ---------------------------------------------------------------------------


def _ln(W, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], W[f"{name}.weight"], W[f"{name}.bias"], eps)


def _lin(W, name, x):
    return F.linear(x, W[f"{name}.weight"], W.get(f"{name}.bias"))


def _attention(W, pre, cfg, x):
    B, T, H = x.shape
    nh = cfg["num_attention_heads"]
    dh = H // nh
    left = cfg["left_max_position_embeddings"]

    def heads(t):
        return t.reshape(B, T, nh, dh).transpose(1, 2)

    q, k, v = (heads(_lin(W, f"{pre}.attn.{n}", x)) for n in ("q", "k", "v"))
    E = W[f"{pre}.attn.distance_embedding"]
    t = torch.arange(T, device=x.device)
    idx = (t[None, :] - t[:, None] + left).clamp(0, E.shape[0] - 1)  # [T (query), T (key)]
    s = q @ k.transpose(-1, -2) + (q @ E.t())[:, :, t[:, None], idx]
    a = torch.softmax(s / math.sqrt(dh), dim=-1) @ v
    return _lin(W, f"{pre}.attn.out", a.transpose(1, 2).reshape(B, T, H))


def _conv_module(W, pre, cfg, x, eps):
    h = F.glu(_lin(W, f"{pre}.conv.pw1", _ln(W, f"{pre}.conv.layer_norm", x, eps)), dim=-1)
    K = cfg["conv_depthwise_kernel_size"]
    h = F.conv1d(F.pad(h.transpose(1, 2), (K - 1, 0)), W[f"{pre}.conv.dw_weight"],
                 groups=h.shape[-1]).transpose(1, 2)
    return _lin(W, f"{pre}.conv.pw2", F.silu(_ln(W, f"{pre}.conv.dw_layer_norm", h, eps)))


def _ffn(W, name, x):
    return _lin(W, f"{name}.out", F.silu(_lin(W, f"{name}.inp", x)))


def features(W, cfg, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, N] -> the hidden states after block ``output_layer``
    [B, T, hidden], f32."""
    eps = cfg["layer_norm_eps"]
    h = _lin(W, "projection", _ln(W, "fp_layer_norm", fbank(cfg, wav), eps))
    for i in range(cfg["output_layer"]):
        pre = f"layers.{i}"
        h = h + 0.5 * _ffn(W, f"{pre}.ffn1", _ln(W, f"{pre}.ffn1_layer_norm", h, eps))
        h = h + _attention(W, pre, cfg, _ln(W, f"{pre}.self_attn_layer_norm", h, eps))
        h = h + _conv_module(W, pre, cfg, h, eps)
        h = h + 0.5 * _ffn(W, f"{pre}.ffn2", _ln(W, f"{pre}.ffn2_layer_norm", h, eps))
        h = _ln(W, f"{pre}.final_layer_norm", h, eps)
    return h


def id_err(feats: torch.Tensor, codebook: torch.Tensor, ids: torch.Tensor) -> float:
    """The least error of the states that the program's ids [B, T] imply,
    judged against the reference's features [B, T, D] after the affine-free
    LayerNorm, in float64: a frame whose id is not the nearest codeword
    ``a`` but ``b`` had its state moved by at least ``(d_b - d_a) / (2 |c_b -
    c_a|)`` along ``c_b - c_a``; the largest over the frames (0 where every
    id is the nearest). In the states' component scale (about 1)."""
    f = F.layer_norm(feats.double(), feats.shape[-1:], eps=1e-5).reshape(-1, feats.shape[-1])
    c = codebook.double()
    d = (f * f).sum(-1, keepdim=True) - 2.0 * f @ c.t() + (c * c).sum(-1)
    rows = torch.arange(d.shape[0], device=d.device)
    best, pick = d.argmin(-1), ids.reshape(-1).long()
    gap = (d[rows, pick] - d[rows, best]).clamp_min(0.0)
    apart = (c[pick] - c[best]).norm(dim=-1).clamp_min(1e-30)
    return float((gap / (2.0 * apart)).max())


def _frames(cfg, samples: int) -> int:
    """The frames of ``samples`` of audio: fbank frames, two stacked."""
    return (1 + (samples - cfg["frame_length"]) // cfg["hop_length"]) // cfg["stride"]


def encode_check(weights, cfg, req, ids, device, block: int = 2) -> dict:
    """{"id_err": ...} of the program's ids [B, 1, T] for the int16 PCM rows
    of ``req`` it encoded, the reference run on each row's own length in
    blocks of ``block`` rows, each row judged on its own frames."""
    pcm16 = req.batch
    if ids.shape != (pcm16.shape[0], 1, _frames(cfg, pcm16.shape[1])):
        return {"id_err": float("inf")}
    worst = 0.0
    with torch.inference_mode(), ieee_f32():
        for n, rows in row_blocks(req.lengths, block):
            wav = torch.as_tensor(pcm16[rows, :n], device=device).float() / 32768.0
            feats = features(weights["encoder"], cfg, wav)
            got = torch.as_tensor(np.asarray(ids[rows, 0, :feats.shape[1]]), device=device)
            worst = max(worst, id_err(feats, weights["codebook"], got))
    return {"id_err": worst}


# ---------------------------------------------------------------------------
# decode: the GPT's AR tokens, Bark-fine's codes, EnCodec's waveform
# ---------------------------------------------------------------------------
#
# The GPT (nanoGPT: pre-LN blocks without biases, fused q k v, GELU MLP of
# 4x, a causal mask, the head tied to the token embedding) samples each
# row's coarse tokens after its prompt (the ids moved into the joint
# vocabulary, truncated to ``max_source_tokens``, then the acoustic INFER
# token) within a context of ``block_size``: the sampler's rounds (prompts
# bucketed to ``prompt_bucket``, the context cut to its last
# ``block_size - slide_keep_margin`` tokens when a round would overflow, a
# round ending at half the block) decide which context each token was drawn
# under. Bark-fine (pre-LN blocks with LayerNorm biases, no mask, the
# embeddings of the codebooks up to the predicted one summed, one head a
# predicted codebook) fills the codebooks after the coarse ones over a
# window of ``block_size`` frames (Bark's generator slides the window for
# longer rows; a row of at most 1024 coarse tokens fits one). Both as
# served: every leaf rounded to bfloat16, the arithmetic in IEEE f32.


def _bf16(W: dict) -> dict:
    return {k: v.to(torch.bfloat16).float() for k, v in W.items()}


def _fp8(W: dict) -> dict:
    """The control's leaves: every matrix in fp8 (e4m3) with a scale a row,
    the vectors in bfloat16."""
    out = {}
    for k, v in _bf16(W).items():
        if v.dim() == 2:
            scale = v.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 448.0
            v = (v / scale).to(torch.float8_e4m3fn).float() * scale
        out[k] = v
    return out


def _block_stack(W, g: dict, x, causal: bool):
    """The pre-LN blocks over x [B, T, C], attention under a causal mask or
    none."""
    B, T, C = x.shape
    nh = g["n_head"]
    dh = C // nh
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril() if causal else None
    for i in range(g["n_layer"]):
        pre = f"layers.{i}"
        h = F.layer_norm(x, (C,), W[f"{pre}.ln1.weight"], W.get(f"{pre}.ln1.bias"), 1e-5)
        q, k, v = F.linear(h, W[f"{pre}.qkv.weight"]).view(B, T, 3, nh, dh).permute(2, 0, 3, 1, 4)
        s = (q @ k.transpose(-1, -2)) * dh**-0.5
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, T, C)
        x = x + F.linear(a, W[f"{pre}.out.weight"])
        h = F.layer_norm(x, (C,), W[f"{pre}.ln2.weight"], W.get(f"{pre}.ln2.bias"), 1e-5)
        x = x + F.linear(F.gelu(F.linear(h, W[f"{pre}.mlp_in.weight"])), W[f"{pre}.mlp_out.weight"])
    return F.layer_norm(x, (C,), W["ln_f.weight"], W.get("ln_f.bias"), 1e-5)


def _bucket(n: int, bucket: int, cap: int) -> int:
    return min(cap, -(-n // bucket) * bucket)


def ar_rounds(prompt_lens, counts, cfg):
    """The sampler's rounds for rows whose prompts are ``prompt_lens`` long
    and which kept ``counts`` tokens (a row that kept fewer than
    ``max_new_tokens`` drew the stop token next): for each round, for each
    row, (context start, context end, tokens drawn, whether it drew the
    stop token), indices into the row's prompt and tokens."""
    d = cfg["decoder"]
    bs, max_new = d["gpt"]["block_size"], d["max_new_tokens"]
    bucket = min(d["prompt_bucket"], max(1, bs // 4))
    keep = bs - max(2 * bucket, min(d["slide_keep_margin"], bs // 2))
    start = [max(0, p - bs) for p in prompt_lens]
    end = list(prompt_lens)
    taken = [0] * len(prompt_lens)
    done = [False] * len(prompt_lens)
    remaining, rounds = max_new, []
    while remaining > 0 and not all(done):
        ctx = max(e - s for s, e in zip(start, end))
        room = bs - _bucket(ctx, bucket, bs)
        if room < min(remaining, bucket):
            start = [max(s, e - keep) for s, e in zip(start, end)]
            ctx = max(e - s for s, e in zip(start, end))
            room = bs - _bucket(ctx, bucket, bs)
        pad = _bucket(ctx, bucket, bs)
        n_new = min(remaining, room)
        if bs >= 512 and pad < bs // 2 < pad + _bucket(n_new, bucket, bs):
            n_new = min(n_new, bs // 2 - pad)
        this = []
        for i in range(len(prompt_lens)):
            n = 0 if done[i] else min(n_new, counts[i] - taken[i])
            stop = not done[i] and n < n_new
            this.append((start[i], end[i], n, stop))
            taken[i] += n
            end[i] += n
            start[i] = max(start[i], end[i] - bs)
            done[i] = done[i] or stop
        rounds.append(this)
        remaining -= n_new
    return rounds


def _prompts(cfg, ids):
    d = cfg["decoder"]
    return [np.concatenate([np.asarray(r, np.int64).reshape(-1)[: d["max_source_tokens"]]
                            + d["semantic_offset"], [d["infer_token"]]]) for r in ids]


def _pick(logits, k: int, temperature: float, gen):
    """The token a decoder at these logits would draw: the best where
    ``k`` is 1, else a draw from the best ``k`` at ``temperature``."""
    if k == 1:
        return logits.argmax(-1)
    vals, idxs = torch.topk(logits / temperature, k, dim=-1)
    return idxs.gather(-1, torch.multinomial(torch.softmax(vals, -1), 1, generator=gen))[:, 0]


def ar_gap(W, cfg, ids, tokens, greedy: bool, device, control=None, block: int = 8) -> float:
    """How far a drawn token's logit lies below the reference's ``k``-th
    best (``k`` 1 for a greedy request, ``top_k`` else), the largest over
    every token the GPT drew (the stop token too), each judged under the
    context the sampler drew it in. With ``control`` (the control's
    leaves), the token judged at each position is the one the control
    would draw there instead, on the same prompts and tokens."""
    d = cfg["decoder"]
    k = 1 if greedy else d["top_k"]
    kept = [t[t >= 0] for t in np.asarray(tokens)]
    prompts = _prompts(cfg, ids)
    stop = d["stop_token"]
    seqs = [np.concatenate([p, t, [stop]]) for p, t in zip(prompts, kept)]
    W, Wc = _bf16(W), control
    gen = generator(0, "control.ar", device)
    worst = 0.0
    for rnd in ar_rounds([len(p) for p in prompts], [len(t) for t in kept], cfg):
        rows = [(i, s, e, n + stop_) for i, (s, e, n, stop_) in enumerate(rnd) if n + stop_]
        for j in range(0, len(rows), block):
            part = rows[j:j + block]
            L = max(e - s + m - 1 for _, s, e, m in part)
            idx = torch.zeros((len(part), L), dtype=torch.long, device=device)
            at, want = [], []
            for r, (i, s, e, m) in enumerate(part):
                seq = torch.as_tensor(seqs[i][s:e + m - 1], device=device)
                idx[r, :len(seq)] = seq
                at += [(r, e - s - 1 + q) for q in range(m)]
                want += list(seqs[i][e:e + m])
            rr, pp = (torch.as_tensor(x, device=device) for x in zip(*at))
            want = torch.as_tensor(np.asarray(want, np.int64), device=device)
            x = W["wte"][idx] + W["wpe"][: idx.shape[1]]
            h = _block_stack(W, d["gpt"], x, causal=True)[rr, pp]
            logits = h @ W["wte"].t()
            if Wc is not None:
                xc = Wc["wte"][idx] + Wc["wpe"][: idx.shape[1]]
                hc = _block_stack(Wc, d["gpt"], xc, causal=True)[rr, pp]
                want = _pick(hc @ Wc["wte"].t(), k, d["temperature"], gen)
            kth = torch.topk(logits, k, dim=-1).values[:, -1]
            gap = kth - logits.gather(-1, want[:, None])[:, 0]
            worst = max(worst, float(gap.clamp_min(0.0).max()))
    return worst


def coarse_codes(cfg, tokens):
    """The AR tokens of each row -> its coarse codes [2, T]: the tokens
    before the stop, moved out of the joint vocabulary, clipped to the two
    codebooks' range, de-interleaved (the second codebook's offset
    removed)."""
    d = cfg["decoder"]
    per = d["per_codebook_size"]
    out = []
    for t in np.asarray(tokens):
        y = np.clip(t[t >= 0].astype(np.int64) - d["acoustic_offset"], 0, 2 * per - 1)
        n = len(y) // 2 * 2
        out.append(np.clip(np.stack([y[0:n:2], y[1:n:2] - per]), 0, per - 1))
    return out


def fine_gap(W, cfg, window, device, control=None, block: int = 8) -> float:
    """How far the codes that Bark-fine filled (greedy) lie below the
    reference's best at their positions, the mean over every code it
    filled: ``window`` [B, block_size, 8] is the program's window as it
    filled it (its rows padded past T with the filler id, and the padding
    filled too), teacher-forced codebook by codebook: the codebooks before
    the one predicted as filled, it and the rest the filler id. (The
    largest gap, and the share of codes that are not the best, do not
    separate the program from its control: PERF.md.) With ``control``, the
    code judged at each position is the control's best instead."""
    b = cfg["decoder"]["bark_fine"]
    filler = b["codebook_size"]
    given, total = cfg["decoder"]["coarse_codebooks"], b["n_codes_total"]
    W = _bf16(W)
    win = torch.as_tensor(window, device=device).long()
    gap_sum, n = 0.0, 0
    for cb in range(given, total):
        head = f"lm_heads.{cb - b['n_codes_given']}"
        inp = win.clone()
        inp[:, :, cb:] = filler

        def logits_of(V, rows):
            x = sum(V[f"wtes.{i}"][inp[rows, :, i]] for i in range(cb + 1)) + V["wpe"][:inp.shape[1]]
            return (_block_stack(V, b, x, causal=False) @ V[head].t())[:, :, :filler]

        for r in range(0, win.shape[0], block):
            rows = slice(r, r + block)
            logits = logits_of(W, rows)
            pick = win[rows, :, cb] if control is None else logits_of(control, rows).argmax(-1)
            gap = logits.max(-1).values - logits.gather(-1, pick[..., None])[..., 0]
            gap_sum += float(gap.double().sum())
            n += gap.numel()
    return gap_sum / n


def _pcm16_err(weights, cfg, fine, lens, waves, device, block: int = 8) -> float:
    """The EnCodec stage: each row's waveform against the reference's from
    the fine codes it was handed, on the row's own length."""
    acfg = _acoustic(cfg)
    hop = math.prod(acfg["upsampling_ratios"])
    worst = 0.0
    for n, rows in row_blocks(lens, block):
        codes = torch.as_tensor(np.asarray(fine)[rows, :, :n], device=device)
        wave = encodec.decode_waveform(weights["decoder"], weights["codebooks"], acfg, codes)
        pcm = torch.as_tensor(np.concatenate([waves[i] for i in rows]), device=device)
        worst = max(worst, encodec.pcm16_err(wave, pcm))
    return worst


def _stages_agree(cfg, req, waves) -> bool:
    """The answer's shapes, and the codes each stage handed the next: the
    fine stage's first codebooks are the AR tokens' coarse codes (the
    filler past a row), Bark-fine's window holds the fine codes and the
    filler past them in its first codebooks (one window: rows of at most
    ``block_size`` frames), each waveform is its row's length."""
    d, acfg = cfg["decoder"], _acoustic(cfg)
    hop, filler = math.prod(acfg["upsampling_ratios"]), d["bark_fine"]["codebook_size"]
    tokens, window, fine, lens = (getattr(waves, k, None) for k in ("tokens", "window", "fine", "lens"))
    B = len(req.batch)
    if (tokens is None or window is None or fine is None or lens is None or len(waves) != B
            or len(lens) != B or np.shape(tokens) != (B, d["max_new_tokens"])):
        return False
    coarse = coarse_codes(cfg, tokens)
    T, given = max(c.shape[1] for c in coarse), d["coarse_codebooks"]
    window = torch.as_tensor(window).cpu().numpy()
    if (np.shape(fine) != (B, d["codebooks"], T) or list(lens) != [c.shape[1] for c in coarse]
            or window.shape != (B, d["bark_fine"]["block_size"], d["codebooks"])):
        return False
    head = np.full((B, given, T), filler, np.int64)
    for i, c in enumerate(coarse):
        head[i, :, : c.shape[1]] = c
    body = window[:, :, given:]
    return (np.array_equal(np.asarray(fine)[:, :given], head)
            and np.array_equal(window[:, :T], np.swapaxes(np.asarray(fine), 1, 2))
            and (window[:, T:, :given] == filler).all()
            and body.min() >= 0 and body.max() < acfg["codebook_size"]
            and all(w.shape == (1, n * hop) and w.dtype == np.int16 for w, n in zip(waves, lens)))


def decode_check(weights, cfg, req, waves, device) -> dict:
    """The numbers of a decode call's answer: ``ar_gap`` of the GPT's
    tokens (``waves.tokens``), ``fine_gap`` of Bark-fine's codes
    (``waves.window``; judged in greedy requests, whose codes are the best
    at each position; a sampled request's codes are draws from the whole
    codebook, any of which is legal), and ``pcm16_err`` of the waveforms
    against the reference's EnCodec stage on the fine codes (``waves.fine``,
    ``waves.lens`` long)."""
    if not _stages_agree(cfg, req, waves):
        return {k: float("inf") for k in cfg["limits"]["decode"]}
    with torch.inference_mode(), ieee_f32():
        out = {"ar_gap": ar_gap(weights["gpt"], cfg, req.batch, waves.tokens, req.greedy, device),
               "pcm16_err": _pcm16_err(weights, cfg, waves.fine, waves.lens, waves, device)}
        if req.greedy:
            out["fine_gap"] = fine_gap(weights["bark_fine"], cfg, waves.window, device)
    return out


def decode_control(weights, cfg, req, waves, device) -> dict:
    """The control's numbers on the same prompts and tokens: the GPT and
    Bark-fine with fp8 leaves (``_fp8``), the EnCodec stage in TF32, each
    judged by the reference."""
    if not _stages_agree(cfg, req, waves):
        return {k: float("inf") for k in cfg["limits"]["decode"]}
    acfg = _acoustic(cfg)
    with torch.inference_mode(), ieee_f32():
        out = {"ar_gap": ar_gap(weights["gpt"], cfg, req.batch, waves.tokens, req.greedy, device,
                                control=_fp8(weights["gpt"]))}
        if req.greedy:
            out["fine_gap"] = fine_gap(weights["bark_fine"], cfg, waves.window, device,
                                       control=_fp8(weights["bark_fine"]))
        worst = 0.0
        for n, rows in row_blocks(waves.lens, 8):
            codes = torch.as_tensor(np.asarray(waves.fine)[rows, :, :n], device=device)
            ref = encodec.decode_waveform(weights["decoder"], weights["codebooks"], acfg, codes)
            with encodec.tf32(True):
                low = encodec.decode_waveform(weights["decoder"], weights["codebooks"], acfg, codes)
            pcm = torch.round(low.double().clamp(-0.99, 0.99) * 32768.0)
            worst = max(worst, encodec.pcm16_err(ref, pcm))
        out["pcm16_err"] = worst
    return out
