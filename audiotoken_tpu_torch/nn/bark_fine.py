"""Bark "fine acoustics" model: a non-causal GPT that fills EnCodec
codebooks n_coarse..7 over 1024-frame windows sliding by 512.

Counterpart of ``audiotoken_tpu/nn/bark_fine.py``: 24 pre-LN blocks
without a causal mask, 1024 wide, 16 heads x 64, one embedding table per
codebook (summed up to the predicted one), one lm_head per predicted
codebook. The attention is K5 (``ops/flash_attention.py:
flash_attention_plain``) on a CUDA tensor and its plain version on a CPU
one; everything else is plain PyTorch. One window's whole codebook
cascade runs on the device; the host only slides the windows.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention_plain
from .gpt import LayerNorm, Linear, _lin, _ln, _param


@dataclass(frozen=True)
class BarkFineConfig:
    block_size: int = 1024
    vocab_size: int = 1056  # codebook 1024 + specials
    n_layer: int = 24
    n_head: int = 16
    n_embd: int = 1024
    n_codes_total: int = 8
    n_codes_given: int = 1
    bias: bool = False  # linear layers; layer norms always carry a bias
    layer_norm_eps: float = 1e-5
    codebook_size: int = 1024  # also the filler id for unknown slots
    max_history: int = 512  # window slide


class FineBlock(nn.Module):
    def __init__(self, cfg: BarkFineConfig):
        super().__init__()
        C = cfg.n_embd
        self.ln1 = LayerNorm(C, True)
        self.qkv = Linear(C, 3 * C, cfg.bias)
        self.out = Linear(C, C, cfg.bias)
        self.ln2 = LayerNorm(C, True)
        self.mlp_in = Linear(C, 4 * C, cfg.bias)
        self.mlp_out = Linear(4 * C, C, cfg.bias)


class BarkFine(nn.Module):
    def __init__(self, cfg: BarkFineConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.n_embd
        self.wtes = nn.ParameterList(_param(cfg.vocab_size, C) for _ in range(cfg.n_codes_total))
        self.wpe = _param(cfg.block_size, C)
        self.ln_f = LayerNorm(C, True)
        # torch layout [vocab, C]
        self.lm_heads = nn.ParameterList(
            _param(cfg.vocab_size, C) for _ in range(cfg.n_codes_total - cfg.n_codes_given))
        self.layers = nn.ModuleList(FineBlock(cfg) for _ in range(cfg.n_layer))

    def forward(self, codes: torch.Tensor, codebook_idx: int) -> torch.Tensor:
        """codes [B, T, n_codes_total] -> logits [B, T, vocab] f32 for
        codebook ``codebook_idx`` (embeddings of codebooks 0..idx summed)."""
        cfg = self.cfg
        B, T, _ = codes.shape
        nh, C, eps = cfg.n_head, cfg.n_embd, cfg.layer_norm_eps
        dh = C // nh
        x = self.wtes[0][codes[:, :, 0]]
        for i in range(1, codebook_idx + 1):
            x = x + self.wtes[i][codes[:, :, i]]
        x = x + self.wpe[:T]
        for layer in self.layers:
            qkv = _lin(layer.qkv, _ln(layer.ln1, x, eps)).view(B, T, 3, nh, dh)
            q, k, v = (qkv[:, :, j].transpose(1, 2).contiguous() for j in range(3))
            a = flash_attention_plain((q * dh**-0.5).to(x.dtype), k, v)  # [B, nh, T, dh]
            x = x + _lin(layer.out, a.transpose(1, 2).reshape(B, T, C))
            h = F.gelu(_lin(layer.mlp_in, _ln(layer.ln2, x, eps)))
            x = x + _lin(layer.mlp_out, h)
        x = _ln(self.ln_f, x, eps)
        head = self.lm_heads[codebook_idx - cfg.n_codes_given]
        return F.linear(x.float(), head.float())


class BarkFineGenerator:
    """Sliding-window fine-codebook inpainting (bark ``generate_fine``),
    batched over sequences of one length."""

    def __init__(self, model: BarkFine):
        self.model = model
        self.cfg = model.cfg
        #: codebook passes run so far (each one launches K5 once per layer
        #: on a CUDA device)
        self.passes = 0

    @property
    def device(self) -> torch.device:
        return self.model.wpe.device

    def generate_fine(self, coarse: np.ndarray, temperature: Optional[float] = 0.5,
                      seed: int = 0) -> np.ndarray:
        """coarse [n_coarse, T] ids in [0, codebook_size) -> fine
        [n_codes_total, T]."""
        return self.generate_fine_batch(np.asarray(coarse)[None], temperature, seed)[0]

    @torch.inference_mode()
    def _fill_window(self, buf: torch.Tensor, rel_fill: int, n_coarse: int,
                     temperature: Optional[float], gen: torch.Generator) -> torch.Tensor:
        """Fill codebooks n_coarse..7 of a [B, window, 8] buffer on the
        device; positions before ``rel_fill`` keep their values."""
        cfg = self.cfg
        keep_new = torch.arange(buf.shape[1], device=buf.device)[None, :] >= rel_fill
        for cb in range(n_coarse, cfg.n_codes_total):
            relevant = self.model(buf, cb)[:, :, : cfg.codebook_size]
            self.passes += 1
            if temperature is None:
                preds = relevant.argmax(dim=-1)
            else:
                probs = torch.softmax(relevant / temperature, dim=-1)
                preds = torch.multinomial(probs.reshape(-1, cfg.codebook_size), 1,
                                          generator=gen).view(relevant.shape[:-1])
            buf[:, :, cb] = torch.where(keep_new, preds, buf[:, :, cb])
        return buf

    def generate_fine_batch(self, coarse: np.ndarray, temperature: Optional[float] = 0.5,
                            seed: int = 0) -> np.ndarray:
        """coarse [B, n_coarse, T] -> fine [B, n_codes_total, T]; argmax
        when ``temperature`` is None. Rows share T: pad shorter rows with
        the filler id (``codebook_size``) and trim the result."""
        cfg = self.cfg
        B, n_coarse, T = coarse.shape
        filler, window, slide = cfg.codebook_size, cfg.block_size, cfg.max_history

        buf = np.full((B, T, cfg.n_codes_total), filler, np.int32)
        buf[:, :, :n_coarse] = np.swapaxes(coarse, 1, 2)
        n_remove = 0
        if T < window:
            n_remove = window - T
            buf = np.pad(buf, ((0, 0), (0, n_remove), (0, 0)), constant_values=filler)

        n_loops = max(0, int(np.ceil((T - window) / slide))) + 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        for n_outer in range(n_loops):
            start = min(n_outer * slide, buf.shape[1] - window)
            start_fill = min(n_outer * slide, buf.shape[1] - slide)
            rel_fill = start_fill - start
            win = torch.from_numpy(np.ascontiguousarray(buf[:, start : start + window]))
            win = win.to(self.device).long()
            filled = self._fill_window(win, rel_fill, n_coarse, temperature, gen).cpu().numpy()
            buf[:, start_fill : start_fill + (window - rel_fill), n_coarse:] = filled[
                :, rel_fill:, n_coarse:]

        out = np.swapaxes(buf, 1, 2)  # [B, 8, T(+pad)]
        if n_remove > 0:
            out = out[:, :, :-n_remove]
        return out


# ---------------------------------------------------------------------------
# Random init, numpy only: the JAX package's draws, in its order.
# ---------------------------------------------------------------------------


def init_bark_fine_params(rng, cfg: BarkFineConfig = BarkFineConfig()):
    """JAX-layout parameter tree (linear kernels and lm_heads [in, out]);
    the same draws as ``audiotoken_tpu.nn.bark_fine.init_bark_fine_params``."""
    C = cfg.n_embd

    def lin(din, dout, bias):
        return {"kernel": (rng.standard_normal((din, dout)) * 0.02).astype(np.float32),
                "bias": np.zeros((dout,), np.float32) if bias else None}

    def ln(d):
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    return {
        "wtes": [(rng.standard_normal((cfg.vocab_size, C)) * 0.02).astype(np.float32)
                 for _ in range(cfg.n_codes_total)],
        "wpe": (rng.standard_normal((cfg.block_size, C)) * 0.02).astype(np.float32),
        "ln_f": ln(C),
        "lm_heads": [(rng.standard_normal((C, cfg.vocab_size)) * 0.02).astype(np.float32)
                     for _ in range(cfg.n_codes_total - cfg.n_codes_given)],
        "layers": [
            {
                "ln1": ln(C),
                "attn": {"qkv": lin(C, 3 * C, cfg.bias), "out": lin(C, C, cfg.bias)},
                "ln2": ln(C),
                "mlp": {"in": lin(C, 4 * C, cfg.bias), "out": lin(4 * C, C, cfg.bias)},
            }
            for _ in range(cfg.n_layer)
        ],
    }
