"""Where the time of one w2v-BERT conformer block goes, on an NVIDIA GPU.

    python scripts/profile_conformer_stages_torch.py [--batch 8] [--precision highest]
        [--attn-kernel highest]

One block of semantic_m's encoder at its real width (1024, 16 heads, FFN
4096, depthwise kernel 31; random weights) on B rows of 30 s (T = 1500
frames, the last row cut short by the mask), under ``--precision``
(``highest``, IEEE f32 in cuBLAS and cuDNN, as the encoder runs for token
parity, by default; ``high`` and ``default`` TF32, with K4 in one TF32
pass). ``--attn-kernel`` overrides the ``attn_kernel`` stage alone, so
that ``--precision high --attn-kernel highest`` times the block under
``high`` with the 3xTF32 K4. Each
component is timed alone with CUDA events (a warm-up, the median of 5) on
inputs of its real shape, in the order the block runs them:

  norms      the five LayerNorms (two FFN, attention, conv, final)
  ffn        both half-step FFNs: the 1024 -> 4096 SGEMMs with SiLU, the
             4096 -> 1024 SGEMMs, the scale and residual
  attention  the q, k, v projections, K4 (rel-key flash attention, at the
             ``attn_kernel`` stage's precision),
             the out projection, the head reshapes
  conv       its LayerNorm and mask, pw1 (1024 -> 2048) and the GLU, the
             depthwise conv (IEEE under every setting), its LayerNorm and
             SiLU, pw2 (1024 -> 1024)

then sums them against the block's own time; the gap is what the parts
do not see (the residual adds and the launches between them).
Needs a CUDA device; imports no JAX.
"""

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from profile_fine_stages_torch import cuda_ms  # noqa: E402
from audiotoken_tpu_torch.nn.conformer import ConformerBlock, W2VBertConfig  # noqa: E402
from audiotoken_tpu_torch.ops.flash_attention import flash_attention_relkey  # noqa: E402
from audiotoken_tpu_torch.runtime.precision import StagePrecision, tf32_numerics  # noqa: E402


def components(block, x, mask, P, cfg):
    """(group, name, fn) of every component of ``block`` on inputs shaped
    as the block gives them."""
    B, T, H = x.shape
    nh, dh, K = cfg.num_attention_heads, cfg.head_size, cfg.conv_depthwise_kernel_size
    at, cv, f1 = block.attn, block.conv, block.ffn1
    h4 = torch.randn((B, T, cfg.intermediate_size), device=x.device)
    heads = lambda t: t.reshape(B, T, nh, dh).transpose(1, 2).contiguous()  # noqa: E731
    q, k, v = heads(at.q(x)), heads(at.k(x)), heads(at.v(x))
    a = torch.randn((B, nh, T, dh), device=x.device)

    def numerics(stage, fn):
        def run():
            with P.numerics(stage):
                return fn()
        return run

    def numerics_off(fn):
        def run():
            with tf32_numerics(False):
                return fn()
        return run

    return [
        ("norms", "5 LayerNorms", lambda: [ln(x) for ln in (
            block.ffn1_layer_norm, block.self_attn_layer_norm, cv.layer_norm,
            block.ffn2_layer_norm, block.final_layer_norm)]),
        ("ffn", "2 x 1024->4096 SGEMM + SiLU", numerics(
            "ffn_in", lambda: [F.silu(f.inp(x)) for f in (f1, block.ffn2)])),
        ("ffn", "2 x 4096->1024 SGEMM", numerics(
            "ffn_out", lambda: [f.out(h4) for f in (f1, block.ffn2)])),
        ("ffn", "2 x scale + residual", lambda: [x * 0.5 + x for _ in range(2)]),
        ("attention", "q, k, v projections", numerics(
            "attn_qkv", lambda: (at.q(x), at.k(x), at.v(x)))),
        ("attention", "head reshapes", lambda: (heads(x), heads(x), heads(x),
                                                a.transpose(1, 2).reshape(B, T, H))),
        ("attention", "K4", lambda: flash_attention_relkey(
            q, k, v, at.distance_embedding, mask, left=cfg.left_max_position_embeddings,
            right=cfg.right_max_position_embeddings, precision=P("attn_kernel"))),
        ("attention", "out projection", numerics("attn_out", lambda: at.out(x))),
        ("conv", "mask multiply", lambda: x * mask[:, :, None]),
        ("conv", "pw1 1024->2048 SGEMM + GLU", numerics(
            "conv", lambda: F.glu(cv.pw1(x), dim=-1))),
        ("conv", "depthwise conv (IEEE)", numerics_off(lambda: F.conv1d(
            F.pad(x.transpose(1, 2), (K - 1, 0)), cv.dw_weight, groups=H).transpose(1, 2))),
        ("conv", "dw LayerNorm + SiLU", lambda: F.silu(cv.dw_layer_norm(x))),
        ("conv", "pw2 1024->1024 SGEMM", numerics("conv", lambda: cv.pw2(x))),
    ]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--precision", default="highest")
    ap.add_argument("--attn-kernel", default=None,
                    help="the attn_kernel stage's policy, over --precision's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs on an NVIDIA GPU")
    dev, B, T = torch.device("cuda", 0), args.batch, 1500
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0], flush=True)
    cfg = W2VBertConfig()
    torch.manual_seed(0)
    block = ConformerBlock(cfg).to(dev).eval()
    with torch.no_grad():
        block.attn.distance_embedding.normal_(0.0, 0.02)
        block.conv.dw_weight.normal_(0.0, 0.1)
    P = StagePrecision(args.precision,
                       None if args.attn_kernel is None else {"attn_kernel": args.attn_kernel})
    x = torch.randn((B, T, cfg.hidden_size), device=dev)
    mask = torch.ones((B, T), device=dev)
    mask[-1, T // 2:] = 0.0
    block_ms = cuda_ms(lambda: block(x, mask, P))  # each stage sets its own switches
    parts = [(g, name, cuda_ms(fn)) for g, name, fn in components(block, x, mask, P, cfg)]
    print(f"w2v-BERT block, B={B} x T={T}, hidden {cfg.hidden_size}, precision "
          f"{args.precision}, attn_kernel {P('attn_kernel')}: block {block_ms:.3f} ms",
          flush=True)
    total = 0.0
    for g, name, ms in parts:
        total += ms
        print(f"  {g:9s} {name:32s} {ms:8.3f} ms  {100 * ms / block_ms:5.1f} %", flush=True)
    for g in dict.fromkeys(p[0] for p in parts):
        s = sum(ms for gg, _, ms in parts if gg == g)
        print(f"  {g:9s} total {s:.3f} ms ({100 * s / block_ms:.1f} %)", flush=True)
    print(f"  sum of the components {total:.3f} ms against the block's {block_ms:.3f} ms "
          f"({100 * total / block_ms:.1f} %)", flush=True)


if __name__ == "__main__":
    main()
