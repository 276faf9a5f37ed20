"""Mimi (kyutai/mimi) checkpoint -> the state dict of ``nn/mimi.py:MimiEncode``.

Reads the key names of transformers' ``MimiModel`` (``kyutai/mimi``'s
``model.safetensors``), encode side: ``encoder.layers.N.conv`` (SEANet,
``block.1`` and ``block.3`` in a residual block), ``encoder_transformer.
layers.i.{self_attn.{q,k,v,o}_proj, mlp.fc1, mlp.fc2, input_layernorm,
post_attention_layernorm, self_attn_layer_scale, mlp_layer_scale}``,
``downsample.conv`` and ``quantizer.{semantic,acoustic}_residual_vector_
quantizer.{input_proj, layers.K.codebook.{embed_sum, cluster_usage}}``.
Weight norm, where a checkpoint keeps it, is folded. q, k and v are
stacked into one ``in_proj``; the 1x1 projections become [256, 512]
matrices; each codebook is ``embed_sum / max(cluster_usage, 1e-5)`` in f32,
as ``MimiEuclideanCodebook.embed`` computes it. The decode side is not
read.
"""

from typing import Dict

import numpy as np

from ..nn.mimi import MimiConfig
from .encodec import _conv, _normalize_keys

#: ``MimiEuclideanCodebook``'s epsilon
USAGE_EPS = 1e-5


def _codebooks(sd, prefix: str, n: int) -> np.ndarray:
    out = []
    for k in range(n):
        p = f"{prefix}.layers.{k}.codebook"
        usage = np.maximum(np.asarray(sd[f"{p}.cluster_usage"], np.float32), np.float32(USAGE_EPS))
        out.append(np.asarray(sd[f"{p}.embed_sum"], np.float32) / usage[:, None])
    return np.stack(out)


def convert_mimi(sd: Dict[str, np.ndarray], cfg: MimiConfig = MimiConfig()) -> Dict[str, np.ndarray]:
    """A numpy state dict of ``MimiModel`` -> ``MimiEncode``'s, numpy f32."""
    sd = _normalize_keys(sd)
    out = {}

    def conv(dst, src):
        p = _conv(sd, f"encoder.layers.{src}.conv")
        out[f"seanet.{dst}.weight"] = p["kernel"].transpose(2, 1, 0)
        out[f"seanet.{dst}.bias"] = p["bias"]

    conv("conv_in", 0)
    R, i = cfg.num_residual_layers, 1
    for si in range(len(cfg.ratios)):
        for j in range(R):
            conv(f"stages.{si}.res.{j}.conv1", f"{i + j}.block.1")
            conv(f"stages.{si}.res.{j}.conv2", f"{i + j}.block.3")
        conv(f"stages.{si}.down", i + R + 1)  # after the ELU
        i += R + 2
    conv("conv_out", i + 1)
    D = cfg.hidden_size
    for li in range(cfg.num_hidden_layers):
        p, q = f"encoder_transformer.layers.{li}.", f"layers.{li}."
        qkv = [np.asarray(sd[f"{p}self_attn.{n}_proj.weight"], np.float32) for n in "qkv"]
        if any(w.shape != (D, D) for w in qkv):
            raise ValueError(f"convert_mimi: q, k, v of {[w.shape for w in qkv]}; the port "
                             f"takes as many key and value heads as query heads")
        out[q + "in_proj"] = np.concatenate(qkv)
        for dst, src in (("out_proj", "self_attn.o_proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            out[q + dst] = np.asarray(sd[f"{p}{src}.weight"], np.float32)
        for dst, src in (("norm1", "input_layernorm"), ("norm2", "post_attention_layernorm")):
            for leaf in ("weight", "bias"):
                out[f"{q}{dst}.{leaf}"] = np.asarray(sd[f"{p}{src}.{leaf}"], np.float32)
        out[q + "scale1"] = np.asarray(sd[f"{p}self_attn_layer_scale.scale"], np.float32)
        out[q + "scale2"] = np.asarray(sd[f"{p}mlp_layer_scale.scale"], np.float32)
    out["downsample"] = _conv(sd, "downsample.conv")["kernel"].transpose(2, 1, 0)
    S = cfg.num_semantic_quantizers
    for kind, n in (("semantic", S), ("acoustic", cfg.num_quantizers - S)):
        prefix = f"quantizer.{kind}_residual_vector_quantizer"
        out[f"{kind}_proj"] = np.asarray(sd[f"{prefix}.input_proj.weight"], np.float32)[:, :, 0]
        out[f"{kind}_codebooks"] = _codebooks(sd, prefix, n)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}
