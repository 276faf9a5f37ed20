"""Decoder-only transformer (GPT-2 family) with KV-cache sampling: the
semantic -> acoustic model of semantic decode.

Counterpart of ``audiotoken_tpu/nn/gpt.py``: pre-LN blocks, causal
attention, exact-GELU 4x MLP, weight-tied lm_head; 12 layers, 12 heads x
64, 768 wide, block 1024, vocab 53,376 at full size.

:class:`GPT` holds the weights (linears in torch's ``[out, in]`` layout)
and runs the full and the prefill forward in plain PyTorch; the full
forward is also the training forward (:func:`gpt_loss`,
``train/gpt_train.py``), which the JAX package too runs without a kernel. The decode
step, one token a row over the KV cache, is the kernel path: per layer
K7 ``decode_qkv`` -> K6 ``decode_attention`` (which takes q unscaled from
the qkv row and also appends the token to the cache) -> K7 ``decode_ffn``,
chained by programmatic dependent launch on the card, then ``ln_f`` and the tied logits as a
plain product. On a CPU tensor each kernel wrapper runs its plain version.

:class:`GPT` also runs tensor parallel over a mesh axis ``tp`` (Megatron,
``parallel/shard.py:gpt_param_spec``): it then holds rank r's shard, heads
``r*nh/tp ... (r+1)*nh/tp`` of the column-parallel qkv (q, k and v alike),
the matching rows of the row-parallel out-projection, a column block of
``mlp/in`` and rows of ``mlp/out``, and rows ``r*V/tp ...`` of the
vocab-parallel ``wte``, used both for the embedding and for the tied head;
``wpe`` and the LayerNorms are whole. The collectives are
``parallel/collectives.py``'s: an all-reduce after each row-parallel
product, before its bias and the residual add. In the decode step the
rank's K7 ``decode_qkv`` and K6 run on its heads; K7 ``decode_ffn`` fuses
the out-projection through the MLP, across both all-reduces, so under
tp > 1 its tensor-parallel entry ``decode_ffn_tp`` runs instead: the same
products on the rank's shard, each row-parallel one's f32 sums all-reduced
before ``decode_ffn``'s rounding, bias and residual add.

:class:`GPTSampler` copies the JAX sampler's host logic: prompt buckets,
left padding, the slide to the trailing context when the cache has no
room, the phase split at ``block_size // 2`` and per-row stop bookkeeping.
Sampling is exact ``torch.topk`` and ``torch.multinomial`` over the
candidates with an explicit ``torch.Generator``, argmax when ``top_k == 1``;
the RNG streams differ from JAX's, so sampled outputs agree only in
distribution.
"""

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode_attention import decode_attention
from ..ops.decode_step import decode_ffn, decode_ffn_tp, decode_qkv
from ..parallel.collectives import (
    all_gather,
    all_reduce,
    copy_to,
    row_linear,
    vocab_cross_entropy,
    vocab_embedding,
)
from ..parallel.mesh import Axis, check_mesh, single_axis


@dataclass(frozen=True)
class GPTConfig:
    block_size: int = 1024
    vocab_size: int = 53_376
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    bias: bool = False
    causal: bool = True
    layer_norm_eps: float = 1e-5


def _param(*shape):
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, bias: bool):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim) if bias else None


class Linear(nn.Module):
    """weight [out, in]; bias [out] or None."""

    def __init__(self, din: int, dout: int, bias: bool):
        super().__init__()
        self.weight = _param(dout, din)
        self.bias = _param(dout) if bias else None


class Block(nn.Module):
    """One layer; under tp the rank's shard (``tp`` ranks)."""

    def __init__(self, cfg: GPTConfig, tp: int = 1):
        super().__init__()
        C = cfg.n_embd
        self.ln1 = LayerNorm(C, cfg.bias)
        self.qkv = Linear(C, 3 * C // tp, cfg.bias)
        self.out = Linear(C // tp, C, cfg.bias)
        self.ln2 = LayerNorm(C, cfg.bias)
        self.mlp_in = Linear(C, 4 * C // tp, cfg.bias)
        self.mlp_out = Linear(4 * C // tp, C, cfg.bias)


def _ln(m: LayerNorm, x, eps):
    return F.layer_norm(x, x.shape[-1:], m.weight, m.bias, eps)


def _lin(m: Linear, x):
    return F.linear(x, m.weight, m.bias)


class GPT(nn.Module):
    """The GPT, or with ``tp`` (a ``parallel.mesh.Axis`` of more than one
    rank) this rank's tensor-parallel shard of it."""

    def __init__(self, cfg: GPTConfig, tp: Optional[Axis] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp = tp or single_axis("tp")
        if cfg.n_head % tp.size or cfg.vocab_size % tp.size:
            raise ValueError(f"tp = {tp.size} must divide the {cfg.n_head} heads and the "
                             f"vocab of {cfg.vocab_size}")
        self.n_head = cfg.n_head // tp.size  # heads held by this rank
        self.wte = _param(cfg.vocab_size // tp.size, cfg.n_embd)
        self.wpe = _param(cfg.block_size, cfg.n_embd)
        self.ln_f = LayerNorm(cfg.n_embd, cfg.bias)
        self.layers = nn.ModuleList(Block(cfg, tp.size) for _ in range(cfg.n_layer))

    def _attention(self, layer: Block, h, bias):
        """Multi-head attention (this rank's heads) of h [B, T, C] under an
        additive bias [B or 1, 1, T, T]; scores and softmax in f32 -> (out
        [B, T, nh*dh], k, v [B, nh, T, dh])."""
        B, T, C = h.shape
        nh, dh = self.n_head, C // self.cfg.n_head
        q, k, v = _lin(layer.qkv, h).view(B, T, 3, nh, dh).permute(2, 0, 3, 1, 4)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh ** -0.5 + bias
        p = torch.softmax(s, dim=-1).to(h.dtype)
        a = torch.matmul(p.float(), v.float()).to(h.dtype)
        return a.transpose(1, 2).reshape(B, T, nh * dh), k, v

    def _blocks(self, x, bias):
        """The layer stack -> (ln_f(x), [(k, v)] per layer)."""
        eps, tp = self.cfg.layer_norm_eps, self.tp
        kv = []
        for layer in self.layers:
            a, k, v = self._attention(layer, copy_to(_ln(layer.ln1, x, eps), tp), bias)
            kv.append((k, v))
            x = x + row_linear(a, layer.out.weight, layer.out.bias, tp)
            h = F.gelu(_lin(layer.mlp_in, copy_to(_ln(layer.ln2, x, eps), tp)))
            x = x + row_linear(h, layer.mlp_out.weight, layer.mlp_out.bias, tp)
        return _ln(self.ln_f, x, eps), kv

    def logits(self, x):
        """Tied lm_head: hidden [..., C] -> logits [..., vocab] f32 (under
        tp, this rank's vocab rows: [..., vocab / tp])."""
        return F.linear(copy_to(x, self.tp), self.wte).float()

    def full_logits(self, x):
        """:meth:`logits` over the whole vocab, gathered over tp."""
        return all_gather(self.logits(x), self.tp, dim=-1)

    def _embed(self, idx, pos_ids):
        return vocab_embedding(idx, self.wte, self.tp) + self.wpe[pos_ids]

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        """Full causal forward: ids [B, T] -> logits [B, T, vocab] f32 (under
        tp, this rank's vocab rows)."""
        T = idx.shape[1]
        x = self._embed(idx, slice(None, T))
        bias = torch.zeros((T, T), device=idx.device)
        if self.cfg.causal:
            bias = torch.full((T, T), torch.finfo(torch.float32).min, device=idx.device).triu(1)
        return self.logits(self._blocks(x, bias)[0])

    def prefill(self, padded: torch.Tensor, start: torch.Tensor):
        """Causal forward over left-padded prompts: padded [B, T], start [B]
        (row i's tokens occupy slots start[i]..T-1) -> (last hidden
        [B, C] after ln_f, [(k, v)] per layer, each [B, nh, T, dh]).
        Position ids are ``max(t - start, 0)``; keys before a row's start
        are masked."""
        B, T = padded.shape
        t = torch.arange(T, device=padded.device)
        pos_ids = (t[None, :] - start[:, None]).clamp(min=0)
        x = self._embed(padded, pos_ids)
        allowed = (t[None, :] <= t[:, None])[None] & (t[None, :] >= start[:, None])[:, None, :]
        bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min)[:, None]
        x, kv = self._blocks(x, bias)
        return x[:, -1], kv

    def decode_weights(self):
        """Per layer, the tensors a decode step reads, in decode_step's
        order. A round looks them up once: module attribute access costs
        host time at every step, and the step is host-bound."""
        return [(m.ln1.weight, m.ln1.bias, m.qkv.weight, m.qkv.bias, m.out.weight, m.out.bias,
                 m.ln2.weight, m.ln2.bias, m.mlp_in.weight, m.mlp_in.bias, m.mlp_out.weight,
                 m.mlp_out.bias) for m in self.layers]

    def decode_step(self, tok, pos: int, start, k_cache, v_cache, weights):
        """One token per row: tok [B] at cache slot ``pos`` (row i's position
        id ``pos - start[i]``); k_cache, v_cache [n_layer, B, nh, slots, dh]
        gain the token's k and v at slot ``pos``; ``weights`` is
        :meth:`decode_weights`. -> logits [B, vocab] f32. Under tp the
        caches hold this rank's heads and the logits are gathered."""
        cfg, tp = self.cfg, self.tp
        C, eps = cfg.n_embd, cfg.layer_norm_eps
        Cl = C // tp.size  # this rank's q (and k, and v) columns
        reduce = functools.partial(all_reduce, axis=tp)
        x = self._embed(tok, (pos - start).long())
        for li, (ln1_w, ln1_b, w_qkv, b_qkv, w_out, b_out, ln2_w, ln2_b, w_in, b_in, w_out2,
                 b_out2) in enumerate(weights):
            qkv = decode_qkv(x, ln1_w, ln1_b, w_qkv, b_qkv, eps)
            a = decode_attention(qkv[:, :Cl], k_cache[li], v_cache[li], start, pos,
                                 qkv[:, Cl:2 * Cl], qkv[:, 2 * Cl:], chained=True)
            if tp.size == 1:
                x = decode_ffn(x, a, w_out, ln2_w, ln2_b, w_in, w_out2, b_out, b_in, b_out2, eps)
            else:
                x = decode_ffn_tp(x, a, w_out, ln2_w, ln2_b, w_in, w_out2, reduce, b_out, b_in,
                                  b_out2, eps)
        return self.full_logits(F.layer_norm(x, (C,), self.ln_f.weight, self.ln_f.bias, eps))


def gpt_loss(model: GPT, idx: torch.Tensor, targets: torch.Tensor,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the targets that are not -1:
    the sum of their negative log-likelihoods over max(count, 1), so a batch
    with no valid target gives 0, not NaN (``audiotoken_tpu.nn.gpt.gpt_loss``).
    ``count`` (default: the valid targets here) is the divisor's count: a
    data-parallel rank divides by the whole batch's. Under tp the
    cross-entropy runs vocab-parallel, without gathering the logits."""
    logits = model(idx)
    if count is None:
        count = (targets >= 0).sum()
    if model.tp.size == 1:
        nll = F.cross_entropy(logits.flatten(0, 1), targets.flatten().long(), ignore_index=-1,
                              reduction="sum")
    else:
        valid = targets >= 0
        nll = (vocab_cross_entropy(logits, torch.where(valid, targets, 0).long(), model.tp)
               * valid).sum()
    return nll / count.clamp(min=1)


def expand_vocab(params, new_vocab_size: int, seed: int = 0):
    """Grow the tied embedding / lm_head of a JAX-layout GPT tree to
    ``new_vocab_size`` rows: the new rows are drawn from a gaussian with the
    old rows' mean and 1e-5 times their covariance (Hewitt's vocabulary
    expansion), with the JAX package's numpy draw, bit for bit."""
    old = np.asarray(params["wte"], np.float64)
    old_v = old.shape[0]
    if new_vocab_size <= old_v:
        raise ValueError(f"new vocab {new_vocab_size} <= old {old_v}")
    mu = old.mean(axis=0)
    centered = old - mu
    sigma = centered.T @ centered / old_v
    rng = np.random.default_rng(seed)
    new_rows = rng.multivariate_normal(mu, 1e-5 * sigma, size=new_vocab_size - old_v,
                                       method="svd")
    return {**params, "wte": np.concatenate([old, new_rows]).astype(np.float32)}


def _bucket_len(n: int, bucket: int, cap: int) -> int:
    return min(cap, ((n + bucket - 1) // bucket) * bucket)


class GPTSampler:
    """Batched KV-cache generation with per-row stop bookkeeping and
    context-window sliding (``audiotoken_tpu/nn/gpt.py:GPTSampler``).

    With ``mesh`` (``parallel/mesh.py``) the sampler runs on the mesh's
    device, tensor parallel over its "tp" axis under
    ``parallel/shard.py:gpt_sampler_param_spec`` (a copy of ``model``'s
    weights, sharded); "dp" replicates it, as in JAX: every rank gets the
    same prompts and returns the same tokens. The last position's logits
    are gathered over tp and every rank draws with the same seeded
    generator, so the tp ranks pick the same token."""

    #: prompt lengths are bucketed to this multiple
    PROMPT_BUCKET = 32
    #: context kept when sliding the window on overflow (trailing tokens)
    SLIDE_KEEP_MARGIN = 256
    #: the decode loop reads the rows' stop flags back every this many steps;
    #: a row's outputs after its stop are -1 whatever is sampled, so the
    #: check changes when the loop ends, not what it returns
    DONE_CHECK_EVERY = 16

    def __init__(self, model: GPT, mesh=None):
        check_mesh(mesh)
        self.mesh = mesh
        if mesh is not None:
            model = _shard_model(model, mesh)
        self.model = model
        self.cfg = model.cfg
        #: decode steps run so far (each one launches K6 and both K7 entry
        #: points once per layer on a CUDA device)
        self.decode_steps = 0

    @property
    def device(self) -> torch.device:
        return self.model.wte.device

    def generate(self, prompt, max_new_tokens: int = 1024, temperature: float = 0.8,
                 top_k: Optional[int] = 100, stop_token: Optional[int] = None,
                 seed: int = 0) -> np.ndarray:
        """prompt [1, P] or [P] -> new tokens [max_new_tokens] (stop token
        not included; unused slots -1)."""
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        return self.generate_batch(prompt, max_new_tokens=max_new_tokens,
                                   temperature=temperature, top_k=top_k,
                                   stop_token=stop_token, seed=seed)[0]

    def generate_batch(self, prompts, lengths=None, max_new_tokens: int = 1024,
                       temperature: float = 0.8, top_k: Optional[int] = 100,
                       stop_token: Optional[int] = None, seed: int = 0) -> np.ndarray:
        """``prompts``: [B, P] ints (right-padded rows, with ``lengths``) or a
        list of 1-D arrays -> [B, max_new_tokens] int32, -1 at and after each
        row's stop token."""
        if isinstance(prompts, (list, tuple)):
            rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        else:
            arr = np.asarray(prompts, np.int32)
            if arr.ndim == 1:
                arr = arr[None]
            L = arr.shape[1] if lengths is None else None
            rows = [arr[i, : (L if L is not None else int(lengths[i]))]
                    for i in range(arr.shape[0])]
        B = len(rows)
        bs = self.cfg.block_size
        stop = -1 if stop_token is None else int(stop_token)
        bucket = min(self.PROMPT_BUCKET, max(1, bs // 4))
        keep = bs - max(2 * bucket, min(self.SLIDE_KEEP_MARGIN, bs // 2))

        collected = [np.zeros((0,), np.int32) for _ in range(B)]
        seqs = [r[-bs:] for r in rows]
        done = np.zeros((B,), bool)
        remaining = int(max_new_tokens)
        rounds = 0
        while remaining > 0 and not done.all():
            ctx_len = max(len(s) for s in seqs)
            room = bs - _bucket_len(ctx_len, bucket, bs)
            if room < min(remaining, bucket):
                seqs = [s[-keep:] for s in seqs]
                ctx_len = max(len(s) for s in seqs)
                room = bs - _bucket_len(ctx_len, bucket, bs)
            P_pad = _bucket_len(ctx_len, bucket, bs)
            n_new = min(remaining, room)
            if bs >= 512:
                phase = bs // 2
                if P_pad < phase and P_pad + _bucket_len(n_new, bucket, bs) > phase:
                    n_new = min(n_new, phase - P_pad)

            padded = np.zeros((B, P_pad), np.int32)
            lens = np.zeros((B,), np.int32)
            for i, s in enumerate(seqs):
                padded[i, P_pad - len(s):] = s
                lens[i] = len(s)
            gen = torch.Generator(device=self.device)
            gen.manual_seed((int(seed) + 0x9E3779B1 * rounds) % 2**63)
            out, done = self._round(padded, lens, done, n_new, temperature, top_k, stop, gen,
                                    cache_len=min(bs, P_pad + _bucket_len(n_new, bucket, bs)))
            for i in range(B):
                row = out[i]
                stops = np.flatnonzero(row < 0)
                new = row[: stops[0]] if stops.size else row
                collected[i] = np.concatenate([collected[i], new])
                seqs[i] = np.concatenate([seqs[i], new])[-bs:]
            remaining -= n_new
            rounds += 1

        result = np.full((B, max_new_tokens), -1, np.int32)
        for i in range(B):
            n = min(len(collected[i]), max_new_tokens)
            result[i, :n] = collected[i][:n]
        return result

    @torch.inference_mode()
    def _round(self, padded, lens, done, n_new: int, temperature: float, top_k, stop: int,
               gen: torch.Generator, cache_len: int):
        """Prefill the left-padded prompts, then up to ``n_new`` decode steps
        -> (tokens [B, n_new] with -1 at and after each stop, done [B])."""
        model, cfg, dev = self.model, self.cfg, self.device
        B, P = padded.shape
        nh, dh = model.n_head, cfg.n_embd // cfg.n_head
        start = torch.from_numpy((P - lens).astype(np.int32)).to(dev)  # K6 reads int32
        last_h, kv = model.prefill(torch.from_numpy(padded).long().to(dev), start.long())
        dtype = last_h.dtype
        k_cache = torch.empty((cfg.n_layer, B, nh, cache_len, dh), dtype=dtype, device=dev)
        v_cache = torch.empty_like(k_cache)
        for li, (k, v) in enumerate(kv):
            k_cache[li, :, :, :P] = k
            v_cache[li, :, :, :P] = v
        del kv
        logits = model.full_logits(last_h)
        done_t = torch.from_numpy(done).to(dev)
        out = torch.full((B, n_new), -1, dtype=torch.int32, device=dev)
        weights = model.decode_weights()
        for i in range(n_new):
            tok = _sample(logits, temperature, top_k, gen)
            is_stop = tok == stop
            out[:, i] = torch.where(done_t | is_stop, -1, tok).int()
            done_t = done_t | is_stop
            if i == n_new - 1:
                break  # the last token's logits are not needed
            if (i + 1) % self.DONE_CHECK_EVERY == 0 and bool(done_t.all()):
                break  # every row has stopped: the rest stays -1
            logits = model.decode_step(tok, P + i, start, k_cache, v_cache, weights)
            self.decode_steps += 1
        return out.cpu().numpy(), done_t.cpu().numpy()


def _shard_model(model: GPT, mesh) -> GPT:
    """``model``'s tensor-parallel shard for this rank of ``mesh``, on the
    mesh's device and in ``model``'s dtype."""
    from ..parallel.shard import gpt_sampler_param_spec, shard_tree
    from ..weights import gpt_from_numpy, gpt_to_numpy

    tree = gpt_to_numpy(model)
    local = shard_tree(tree, gpt_sampler_param_spec(tree), mesh, mesh.rank)
    with torch.device("meta"):
        shard = GPT(model.cfg, mesh.axis("tp"))
    shard.load_state_dict(gpt_from_numpy(local), assign=True)
    return shard.to(device=mesh.device, dtype=model.wte.dtype).eval()


def _sample(logits: torch.Tensor, temperature: float, top_k: Optional[int],
            gen: torch.Generator) -> torch.Tensor:
    """logits [B, V] f32 -> token ids [B] (int64): argmax when top_k is 1,
    else a draw from softmax(logits / temperature) over the top_k
    candidates (all of them when top_k is None)."""
    if top_k == 1:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is None:
        return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=gen)[:, 0]
    vals, idxs = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1, generator=gen)
    return idxs.gather(-1, choice)[:, 0]


# ---------------------------------------------------------------------------
# Random init, numpy only: the JAX package's draws, in its order.
# ---------------------------------------------------------------------------


def init_gpt_params(rng, cfg: GPTConfig):
    """JAX-layout parameter tree (linear kernels [in, out]); the same draws
    as ``audiotoken_tpu.nn.gpt.init_gpt_params``."""
    C, V = cfg.n_embd, cfg.vocab_size

    def lin(din, dout, bias):
        return {"kernel": (rng.standard_normal((din, dout)) * 0.02).astype(np.float32),
                "bias": np.zeros((dout,), np.float32) if bias else None}

    def ln(d):
        return {"scale": np.ones((d,), np.float32),
                "bias": np.zeros((d,), np.float32) if cfg.bias else None}

    params = {
        "wte": (rng.standard_normal((V, C)) * 0.02).astype(np.float32),
        "wpe": (rng.standard_normal((cfg.block_size, C)) * 0.02).astype(np.float32),
        "ln_f": ln(C),
        "layers": [],
    }
    std_proj = 0.02 / np.sqrt(2 * cfg.n_layer)
    for _ in range(cfg.n_layer):
        out_attn = lin(C, C, cfg.bias)  # drawn, then redrawn at std_proj
        out_attn["kernel"] = (rng.standard_normal((C, C)) * std_proj).astype(np.float32)
        out_mlp = lin(4 * C, C, cfg.bias)
        out_mlp["kernel"] = (rng.standard_normal((4 * C, C)) * std_proj).astype(np.float32)
        params["layers"].append({
            "ln1": ln(C),
            "attn": {"qkv": lin(C, 3 * C, cfg.bias), "out": out_attn},
            "ln2": ln(C),
            "mlp": {"in": lin(C, 4 * C, cfg.bias), "out": out_mlp},
        })
    return params
