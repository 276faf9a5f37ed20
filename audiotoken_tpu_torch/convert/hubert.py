"""HF ``HubertModel`` state dict (mHuBERT-base) -> parameter tree.

Counterpart of ``audiotoken_tpu/convert/hubert.py``; the tree is the one
``weights.get_hubert_params`` returns (conv kernels [K, C_in, C_out],
linear kernels [in, out]). The positional conv's weight norm (over dims 0
and 1, one norm a tap) is folded in f64.
"""

from typing import Dict

import numpy as np

from ..nn.hubert import HubertConfig
from ._common import layer_norm, linear


def _norm_keys(sd):
    out = {}
    for k, v in sd.items():
        k = k.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        out[k] = v
    return out


def convert_hubert(sd: Dict[str, np.ndarray], cfg: HubertConfig = HubertConfig()):
    sd = _norm_keys(sd)
    convs = []
    for i in range(len(cfg.conv_kernel)):
        w = np.asarray(sd[f"feature_extractor.conv_layers.{i}.conv.weight"], np.float32)
        b = sd.get(f"feature_extractor.conv_layers.{i}.conv.bias")
        convs.append({"kernel": w.transpose(2, 1, 0),  # [K, C_in, C_out]
                      "bias": None if b is None else np.asarray(b, np.float32)})
    params = {
        "feature_extractor": {
            "convs": convs,
            "group_norm": layer_norm(sd, "feature_extractor.conv_layers.0.layer_norm"),
        },
        "feature_projection": {
            "layer_norm": layer_norm(sd, "feature_projection.layer_norm"),
            "projection": linear(sd, "feature_projection.projection"),
        },
        "encoder_layer_norm": layer_norm(sd, "encoder.layer_norm"),
    }
    g = np.asarray(sd["encoder.pos_conv_embed.conv.weight_g"], np.float64)
    v = np.asarray(sd["encoder.pos_conv_embed.conv.weight_v"], np.float64)
    norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
    w = (g * v / norm).astype(np.float32)  # [C_out, C_in / groups, K]
    params["pos_conv"] = {
        "kernel": w.transpose(2, 1, 0),  # [K, C_in / groups, C_out]
        "bias": np.asarray(sd["encoder.pos_conv_embed.conv.bias"], np.float32),
    }
    params["layers"] = []
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layers.{i}"
        params["layers"].append({
            "attn": {name: linear(sd, f"{pre}.attention.{name}_proj")
                     for name in ("q", "k", "v", "out")},
            "layer_norm": layer_norm(sd, f"{pre}.layer_norm"),
            "ffn": {
                "in": linear(sd, f"{pre}.feed_forward.intermediate_dense"),
                "out": linear(sd, f"{pre}.feed_forward.output_dense"),
            },
            "final_layer_norm": layer_norm(sd, f"{pre}.final_layer_norm"),
        })
    return params
