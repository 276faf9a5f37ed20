"""Semantic -> acoustic GPT checkpoint -> parameter tree (``nn/gpt.py``'s
layout, the one ``weights.get_semantic_gpt_params`` returns).

Counterpart of ``audiotoken_tpu/convert/gpt.py``: nanoGPT checkpoints
(``hubert_semantic_acoustic_gpt_en.pt``, ``w2vbert2_semantic_acoustic_gpt_hi.pt``;
``nn.Linear`` weights [out, in], keys often behind torch.compile's
``_orig_mod.`` prefix) and HF ``GPT2LMHeadModel`` (Conv1D weights [in, out]).
"""

from typing import Dict

import numpy as np

from ..nn.gpt import GPTConfig
from ._common import layer_norm, linear, strip_compile_prefix


def convert_gpt(sd: Dict[str, np.ndarray], cfg: GPTConfig = GPTConfig(),
                hf_conv1d: bool = False) -> dict:
    """``hf_conv1d=True`` for HF GPT-2 checkpoints (no transpose), False for
    nanoGPT's ``nn.Linear``."""
    sd = strip_compile_prefix(sd)

    def lin(name):
        return linear(sd, name, transpose=not hf_conv1d)

    params = {
        "wte": np.asarray(sd["transformer.wte.weight"], np.float32),
        "wpe": np.asarray(sd["transformer.wpe.weight"], np.float32),
        "ln_f": layer_norm(sd, "transformer.ln_f"),
        "layers": [],
    }
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}"
        params["layers"].append({
            "ln1": layer_norm(sd, f"{pre}.ln_1"),
            "attn": {"qkv": lin(f"{pre}.attn.c_attn"), "out": lin(f"{pre}.attn.c_proj")},
            "ln2": layer_norm(sd, f"{pre}.ln_2"),
            "mlp": {"in": lin(f"{pre}.mlp.c_fc"), "out": lin(f"{pre}.mlp.c_proj")},
        })
    return params
