"""HF ``Wav2Vec2BertModel`` state dict (w2v-BERT 2.0, trimmed to 21
layers) -> parameter tree.

Counterpart of ``audiotoken_tpu/convert/w2vbert.py``; the tree is the one
``weights.get_w2vbert_params`` returns.
"""

from typing import Dict

import numpy as np

from ..nn.conformer import W2VBertConfig
from ._common import layer_norm, linear


def convert_w2vbert(sd: Dict[str, np.ndarray], cfg: W2VBertConfig = W2VBertConfig()):
    params = {
        "feature_projection": {
            "layer_norm": layer_norm(sd, "feature_projection.layer_norm"),
            "projection": linear(sd, "feature_projection.projection"),
        },
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layers.{i}"
        cm = f"{pre}.conv_module"
        pw1 = np.asarray(sd[f"{cm}.pointwise_conv1.weight"], np.float32)
        pw2 = np.asarray(sd[f"{cm}.pointwise_conv2.weight"], np.float32)
        dw = np.asarray(sd[f"{cm}.depthwise_conv.weight"], np.float32)
        params["layers"].append({
            "ffn1_layer_norm": layer_norm(sd, f"{pre}.ffn1_layer_norm"),
            "ffn1": {
                "in": linear(sd, f"{pre}.ffn1.intermediate_dense"),
                "out": linear(sd, f"{pre}.ffn1.output_dense"),
            },
            "self_attn_layer_norm": layer_norm(sd, f"{pre}.self_attn_layer_norm"),
            "attn": {
                "q": linear(sd, f"{pre}.self_attn.linear_q"),
                "k": linear(sd, f"{pre}.self_attn.linear_k"),
                "v": linear(sd, f"{pre}.self_attn.linear_v"),
                "out": linear(sd, f"{pre}.self_attn.linear_out"),
                "distance_embedding": np.asarray(
                    sd[f"{pre}.self_attn.distance_embedding.weight"], np.float32),
            },
            "conv": {
                "layer_norm": layer_norm(sd, f"{cm}.layer_norm"),
                "pw1": {"kernel": pw1[:, :, 0].T, "bias": None},
                "dw_kernel": dw.transpose(2, 1, 0),  # [K, 1, H]
                "dw_layer_norm": layer_norm(sd, f"{cm}.depthwise_layer_norm"),
                "pw2": {"kernel": pw2[:, :, 0].T, "bias": None},
            },
            "ffn2_layer_norm": layer_norm(sd, f"{pre}.ffn2_layer_norm"),
            "ffn2": {
                "in": linear(sd, f"{pre}.ffn2.intermediate_dense"),
                "out": linear(sd, f"{pre}.ffn2.output_dense"),
            },
            "final_layer_norm": layer_norm(sd, f"{pre}.final_layer_norm"),
        })
    return params
