"""EnCodec 24 kHz (SEANet + RVQ) torch checkpoint -> parameter tree.

Counterpart of ``audiotoken_tpu/convert/encodec.py``; the tree is the one
``weights.get_acoustic_params`` returns. Accepts both checkpoint namings:

  * facebookresearch/encodec: ``encoder.model.N.conv.conv.weight_g``,
    ``decoder.model.N.convtr.convtr.weight_v``,
    ``quantizer.vq.layers.K._codebook.embed``;
  * HF transformers ``EncodecModel``: ``encoder.layers.N.conv.weight_g`` or
    ``.conv.parametrizations.weight.original0``,
    ``quantizer.layers.K.codebook.embed``.

Weight norm is folded (``w = g * v / ||v||`` in f64), conv kernels become
[K, C_in, C_out], transposed-conv kernels [K, C_out, C_in], LSTM weights
stay in torch's layout.
"""

from typing import Dict

import numpy as np

from ..nn.rvq import RVQConfig
from ..nn.seanet import SeanetConfig


def fold_weight_norm(g, v) -> np.ndarray:
    """w = g * v / ||v|| with the norm over every dim but 0 (torch's
    ``weight_norm(dim=0)``), in f64, rounded to f32 once.

    g [C_out, 1, 1], v [C_out, C_in, K] (torch Conv1d layout) -> [C_out, C_in, K].
    """
    v = np.asarray(v, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    norm = np.sqrt((v**2).sum(axis=(1, 2), keepdims=True))
    return (g * v / norm).astype(np.float32)


def _normalize_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        k = k.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        # facebookresearch/encodec naming -> the HF one
        k = k.replace("encoder.model.", "encoder.layers.")
        k = k.replace("decoder.model.", "decoder.layers.")
        k = k.replace(".convtr.convtr.", ".conv.")
        k = k.replace(".conv.conv.", ".conv.")
        if "quantizer.vq.layers." in k:
            k = k.replace("quantizer.vq.layers.", "quantizer.layers.")
            k = k.replace("._codebook.", ".codebook.")
        out[k] = v
    return out


def _conv(sd, prefix: str):
    """Fold weight norm -> {kernel, bias}. Both conv kinds take the same
    permutation: [C_out, C_in, K] -> [K, C_in, C_out], and a transposed
    conv's [C_in, C_out, K] -> [K, C_out, C_in]."""
    if f"{prefix}.weight_g" in sd:
        w = fold_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"])
    else:
        w = np.asarray(sd[f"{prefix}.weight"], dtype=np.float32)
    kernel = w.transpose(2, 1, 0).astype(np.float32)
    bias = sd.get(f"{prefix}.bias")
    bias = None if bias is None else np.asarray(bias, dtype=np.float32)
    return {"kernel": kernel, "bias": bias}


def _lstm(sd, prefix: str, num_layers: int):
    return {"layers": [
        {name: np.asarray(sd[f"{prefix}.{key}_l{i}"], np.float32)
         for name, key in (("wih", "weight_ih"), ("whh", "weight_hh"),
                           ("bih", "bias_ih"), ("bhh", "bias_hh"))}
        for i in range(num_layers)
    ]}


def _resnet(sd, prefix: str, use_shortcut: bool):
    p = {
        "conv1": _conv(sd, f"{prefix}.block.1.conv"),
        "conv2": _conv(sd, f"{prefix}.block.3.conv"),
    }
    if use_shortcut:
        p["shortcut"] = _conv(sd, f"{prefix}.shortcut.conv")
    return p


def convert_encoder(sd: Dict[str, np.ndarray], cfg: SeanetConfig):
    sd = _normalize_keys(sd)
    idx = 0
    p = {"conv_in": _conv(sd, f"encoder.layers.{idx}.conv")}
    idx += 1
    stages = []
    for _ratio in reversed(cfg.ratios):
        res = []
        for _ in range(cfg.num_residual_layers):
            res.append(_resnet(sd, f"encoder.layers.{idx}", cfg.use_conv_shortcut))
            idx += 1
        idx += 1  # ELU
        stages.append({"res": res, "down": _conv(sd, f"encoder.layers.{idx}.conv")})
        idx += 1
    p["stages"] = stages
    p["lstm"] = _lstm(sd, f"encoder.layers.{idx}.lstm", cfg.lstm_layers)
    idx += 2  # lstm, ELU
    p["conv_out"] = _conv(sd, f"encoder.layers.{idx}.conv")
    return p


def convert_decoder(sd: Dict[str, np.ndarray], cfg: SeanetConfig):
    sd = _normalize_keys(sd)
    idx = 0
    p = {"conv_in": _conv(sd, f"decoder.layers.{idx}.conv")}
    idx += 1
    p["lstm"] = _lstm(sd, f"decoder.layers.{idx}.lstm", cfg.lstm_layers)
    idx += 1
    stages = []
    for _ratio in cfg.ratios:
        idx += 1  # ELU
        up = _conv(sd, f"decoder.layers.{idx}.conv")
        idx += 1
        res = []
        for _ in range(cfg.num_residual_layers):
            res.append(_resnet(sd, f"decoder.layers.{idx}", cfg.use_conv_shortcut))
            idx += 1
        stages.append({"up": up, "res": res})
    p["stages"] = stages
    idx += 1  # ELU
    p["conv_out"] = _conv(sd, f"decoder.layers.{idx}.conv")
    return p


def convert_codebooks(sd: Dict[str, np.ndarray], cfg: RVQConfig) -> np.ndarray:
    sd = _normalize_keys(sd)
    return np.stack([np.asarray(sd[f"quantizer.layers.{k}.codebook.embed"], np.float32)
                     for k in range(cfg.num_quantizers)])  # [K, C, D]


def convert_encodec(sd: Dict[str, np.ndarray], seanet_cfg=None, rvq_cfg=None):
    """The whole codec: {'encoder', 'decoder', 'codebooks' [K, C, D]}."""
    seanet_cfg = seanet_cfg or SeanetConfig()
    rvq_cfg = rvq_cfg or RVQConfig()
    return {
        "encoder": convert_encoder(sd, seanet_cfg),
        "decoder": convert_decoder(sd, seanet_cfg),
        "codebooks": convert_codebooks(sd, rvq_cfg),
    }
