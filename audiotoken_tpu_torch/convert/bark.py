"""Bark fine-acoustics checkpoint -> parameter tree (``nn/bark_fine.py``'s
layout, the one ``weights.get_bark_fine_params`` returns).

Counterpart of ``audiotoken_tpu/convert/bark.py``. Two namings:

  * the suno/bark package's FineGPT (``transformer.wtes.{i}.weight``,
    ``transformer.h.{i}.attn.c_attn.weight``, ``lm_heads.{i}.weight``),
    shipped behind torch.compile's ``_orig_mod.`` prefix;
  * HF transformers ``BarkFineModel`` (``input_embeds_layers.{i}.weight``,
    ``layers.{i}.attn.att_proj.weight``, ``lm_heads.{i}.weight``).
"""

from typing import Dict

import numpy as np

from ..nn.bark_fine import BarkFineConfig
from ._common import layer_norm, linear, strip_compile_prefix


def _tree(sd, cfg: BarkFineConfig, names: dict):
    out = {
        "wtes": [np.asarray(sd[names["wte"].format(i)], np.float32)
                 for i in range(cfg.n_codes_total)],
        "wpe": np.asarray(sd[names["wpe"]], np.float32),
        "ln_f": layer_norm(sd, names["ln_f"]),
        "lm_heads": [np.asarray(sd[f"lm_heads.{i}.weight"], np.float32).T  # [C, vocab]
                     for i in range(cfg.n_codes_total - cfg.n_codes_given)],
        "layers": [],
    }
    for i in range(cfg.n_layer):
        pre = names["layer"].format(i)
        out["layers"].append({
            "ln1": layer_norm(sd, f"{pre}.{names['ln1']}"),
            "attn": {"qkv": linear(sd, f"{pre}.attn.{names['qkv']}"),
                     "out": linear(sd, f"{pre}.attn.{names['out']}")},
            "ln2": layer_norm(sd, f"{pre}.{names['ln2']}"),
            "mlp": {"in": linear(sd, f"{pre}.mlp.{names['mlp_in']}"),
                    "out": linear(sd, f"{pre}.mlp.{names['mlp_out']}")},
        })
    return out


_SUNO = {"wte": "transformer.wtes.{}.weight", "wpe": "transformer.wpe.weight",
         "ln_f": "transformer.ln_f", "layer": "transformer.h.{}", "ln1": "ln_1",
         "ln2": "ln_2", "qkv": "c_attn", "out": "c_proj", "mlp_in": "c_fc",
         "mlp_out": "c_proj"}
_HF = {"wte": "input_embeds_layers.{}.weight", "wpe": "position_embeds_layer.weight",
       "ln_f": "layernorm_final", "layer": "layers.{}", "ln1": "layernorm_1",
       "ln2": "layernorm_2", "qkv": "att_proj", "out": "out_proj", "mlp_in": "in_proj",
       "mlp_out": "out_proj"}


def convert_bark_fine(sd: Dict[str, np.ndarray], cfg: BarkFineConfig = BarkFineConfig()):
    """suno/bark FineGPT naming, with or without the ``_orig_mod.`` prefix;
    a state dict in HF naming goes to :func:`convert_bark_fine_hf`."""
    if _HF["wte"].format(0) in sd:
        return convert_bark_fine_hf(sd, cfg)
    return _tree(strip_compile_prefix(sd), cfg, _SUNO)


def convert_bark_fine_hf(sd: Dict[str, np.ndarray], cfg: BarkFineConfig = BarkFineConfig()):
    """HF transformers BarkFineModel naming."""
    return _tree(sd, cfg, _HF)
