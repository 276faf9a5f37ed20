"""Acoustic model parameters: a converted store, or seeded random ones.

``get_acoustic_params`` returns the JAX package's parameter tree (numpy,
conv kernels [K, C_in, C_out]); ``acoustic_from_numpy`` is the bridge from
that tree to the port's ``SeanetEncoder`` state and codebook tensor.
"""

import os

import numpy as np
import torch

from .convert.store import load_params


def get_acoustic_params(weights: str = "artifacts", seed: int = 0):
    """{'encoder', 'decoder', 'codebooks'} for the SEANet + RVQ codec.

    ``weights`` is a directory holding ``acoustic.npz`` (the converted
    store), or ``"random"``: seeded numpy draws, bit-identical to
    ``audiotoken_tpu.weights.get_acoustic_params("random", seed)``.
    """
    if weights == "artifacts":
        raise NotImplementedError(
            'weights="artifacts" needs the checkpoint converters, which come '
            "with a later slice of the port; convert with the JAX package's "
            'converter and pass its output directory, or use weights="random"'
        )
    if weights == "random":
        from .nn.rvq import RVQConfig, init_codebooks
        from .nn.seanet import SeanetConfig, init_decoder_params, init_encoder_params

        rng = np.random.default_rng(seed)
        cfg = SeanetConfig()
        return {
            "encoder": init_encoder_params(rng, cfg),
            "decoder": init_decoder_params(rng, cfg),
            "codebooks": init_codebooks(rng, RVQConfig()),
        }
    path = os.path.join(weights, "acoustic.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no acoustic.npz under {weights}")
    return load_params(path)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def acoustic_from_numpy(tree):
    """JAX-layout acoustic tree -> (SeanetEncoder state dict, codebooks).

    Conv kernels [K, C_in, C_out] become [C_out, C_in, K]; LSTM weights are
    already in torch layout; codebooks stay [K, C, D]. The decoder's
    parameters are not used by the encoder.
    """
    enc = tree["encoder"]
    state = {}

    def conv(prefix, p):
        state[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
        state[f"{prefix}.bias"] = _t(p["bias"])

    conv("conv_in", enc["conv_in"])
    for si, stage in enumerate(enc["stages"]):
        for j, res in enumerate(stage["res"]):
            for name in ("conv1", "conv2", "shortcut"):
                if name in res:
                    conv(f"stages.{si}.res.{j}.{name}", res[name])
        conv(f"stages.{si}.down", stage["down"])
    for li, layer in enumerate(enc["lstm"]["layers"]):
        for name in ("wih", "whh", "bih", "bhh"):
            state[f"lstm.{li}.{name}"] = _t(layer[name])
    conv("conv_out", enc["conv_out"])
    return state, _t(tree["codebooks"])
