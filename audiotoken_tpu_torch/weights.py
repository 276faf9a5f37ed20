"""Model parameters: a converted store, the upstream checkpoints, or
seeded random ones.

``get_acoustic_params``, ``get_hubert_params``, ``get_w2vbert_params``,
``get_semantic_gpt_params`` and ``get_bark_fine_params`` return the JAX package's parameter trees
(numpy, conv kernels [K, C_in, C_out], linear kernels [in, out]); the
``*_from_numpy`` functions are the bridges from those trees to the port's
modules' state dicts (f32; a caller casts to its stage dtype after), and
``gpt_to_numpy`` the bridge back from a (trained) ``GPT``.

``weights`` is one of:
  * a directory of converted ``.npz`` files (``acoustic.npz``,
    ``hubert.npz`` + ``hubert_kmeans.npz``, ``w2vbert.npz`` +
    ``w2vbert_vq.npz``, ``gpt_semantic_s_en.npz``, ``gpt_semantic_m_hi.npz``,
    ``bark_fine.npz``), as ``python -m audiotoken_tpu_torch.cli convert``
    and ``scripts/convert_real_torch.py`` write them;
  * ``"artifacts"``: the upstream torch checkpoints, converted on the fly
    (``convert/checkpoints.py``): each looked up first in
    ``$AUDIOTOKEN_ARTIFACTS``, then on the Hugging Face hub where
    ``transformers`` (or ``huggingface_hub``) imports;
  * ``"random"``: seeded numpy draws, bit-identical to the JAX package's.
"""

import os

import numpy as np
import torch

from .convert.checkpoints import artifact_tree
from .convert.store import load_params


def get_acoustic_params(weights: str = "artifacts", seed: int = 0):
    """{'encoder', 'decoder', 'codebooks'} for the SEANet + RVQ codec, from
    ``acoustic.npz`` under ``weights``, EnCodec 24 kHz (``"artifacts"``) or
    seeded draws (``"random"``)."""
    if weights == "artifacts":
        return artifact_tree("acoustic")
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


def acoustic_decoder_from_numpy(tree):
    """JAX-layout acoustic tree -> (SeanetDecoder state dict, codebooks).

    Conv kernels [K, C_in, C_out] become [C_out, C_in, K]; transposed-conv
    kernels [K, C_out, C_in] become torch's [C_in, C_out, K]; LSTM weights
    are already in torch layout. The encoder's parameters are not used.
    """
    dec = tree["decoder"]
    state = {}

    def conv(prefix, p):
        state[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
        state[f"{prefix}.bias"] = _t(p["bias"])

    conv("conv_in", dec["conv_in"])
    for li, layer in enumerate(dec["lstm"]["layers"]):
        for name in ("wih", "whh", "bih", "bhh"):
            state[f"lstm.{li}.{name}"] = _t(layer[name])
    for si, stage in enumerate(dec["stages"]):
        conv(f"stages.{si}.up", stage["up"])  # [K, C_out, C_in] -> [C_in, C_out, K]
        for j, res in enumerate(stage["res"]):
            for name in ("conv1", "conv2", "shortcut"):
                if name in res:
                    conv(f"stages.{si}.res.{j}.{name}", res[name])
    conv("conv_out", dec["conv_out"])
    return state, _t(tree["codebooks"])


def get_w2vbert_params(weights: str = "artifacts", seed: int = 0, config=None):
    """(conformer params, VQ codebook [num_clusters, hidden_dim]) for
    semantic_m, from ``w2vbert.npz`` + ``w2vbert_vq.npz`` under ``weights``,
    the artifacts ``config.weights_artifact`` and ``config.quantizer_artifact``
    (``"artifacts"``), or ``"random"``: the params and then the codebook from
    one generator."""
    from .configs import Wav2VecBertConfig
    from .nn.conformer import W2VBertConfig, init_w2vbert_params

    config = config or Wav2VecBertConfig()
    if weights == "artifacts":
        return (artifact_tree("w2vbert", artifact=config.weights_artifact),
                artifact_tree("w2vbert_vq", artifact=config.quantizer_artifact)["codebook"])
    if weights == "random":
        rng = np.random.default_rng(seed)
        params = init_w2vbert_params(rng, W2VBertConfig())
        codebook = rng.standard_normal((config.num_clusters, config.hidden_dim)).astype(np.float32)
        return params, codebook
    paths = [os.path.join(weights, f"{name}.npz") for name in ("w2vbert", "w2vbert_vq")]
    if not all(os.path.exists(p) for p in paths):
        raise FileNotFoundError(f"no w2vbert.npz + w2vbert_vq.npz under {weights}")
    return load_params(paths[0]), load_params(paths[1])["codebook"]


def w2vbert_from_numpy(tree, num_layers: int):
    """JAX-layout conformer tree -> state dict of the port's
    ``W2VBertFeatures`` with its first ``num_layers`` blocks.

    Linear kernels [in, out] become [out, in]; the depthwise kernel
    [K, 1, H] becomes [H, 1, K]; LayerNorm scale/bias become weight/bias.
    """
    state = {}

    def linear(prefix, p):
        state[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
        if p.get("bias") is not None:
            state[f"{prefix}.bias"] = _t(p["bias"])

    def layer_norm(prefix, p):
        state[f"{prefix}.weight"] = _t(p["scale"])
        state[f"{prefix}.bias"] = _t(p["bias"])

    fp = tree["feature_projection"]
    layer_norm("fp_layer_norm", fp["layer_norm"])
    linear("projection", fp["projection"])
    for i, p in enumerate(tree["layers"][:num_layers]):
        pre = f"layers.{i}"
        for name in ("ffn1_layer_norm", "self_attn_layer_norm", "ffn2_layer_norm",
                     "final_layer_norm"):
            layer_norm(f"{pre}.{name}", p[name])
        for ffn in ("ffn1", "ffn2"):
            linear(f"{pre}.{ffn}.inp", p[ffn]["in"])
            linear(f"{pre}.{ffn}.out", p[ffn]["out"])
        for name in ("q", "k", "v", "out"):
            linear(f"{pre}.attn.{name}", p["attn"][name])
        state[f"{pre}.attn.distance_embedding"] = _t(p["attn"]["distance_embedding"])
        conv = p["conv"]
        layer_norm(f"{pre}.conv.layer_norm", conv["layer_norm"])
        linear(f"{pre}.conv.pw1", conv["pw1"])
        state[f"{pre}.conv.dw_weight"] = _t(np.asarray(conv["dw_kernel"]).transpose(2, 1, 0))
        layer_norm(f"{pre}.conv.dw_layer_norm", conv["dw_layer_norm"])
        linear(f"{pre}.conv.pw2", conv["pw2"])
    return state


def get_hubert_params(weights: str = "artifacts", seed: int = 0, config=None):
    """(HuBERT params, k-means centroids [num_clusters, hidden_dim]) for
    semantic_s, from ``hubert.npz`` + ``hubert_kmeans.npz`` under
    ``weights``, mHuBERT-base and its k-means (``"artifacts"``: the model
    staged as ``convert.checkpoints.STAGED["hubert"]``, else from the hub;
    the k-means through ``config.quantizer_artifact``), or ``"random"``: the params and then the
    centroids from one generator."""
    from .configs import HubertEncoderConfig
    from .nn.hubert import HubertConfig, init_hubert_params

    config = config or HubertEncoderConfig()
    if weights == "artifacts":
        return (artifact_tree("hubert", model_id=config.model_id),
                artifact_tree("hubert_kmeans", artifact=config.quantizer_artifact)["centroids"])
    if weights == "random":
        rng = np.random.default_rng(seed)
        params = init_hubert_params(rng, HubertConfig())
        centroids = rng.standard_normal((config.num_clusters, config.hidden_dim)).astype(np.float32)
        return params, centroids
    paths = [os.path.join(weights, f"{name}.npz") for name in ("hubert", "hubert_kmeans")]
    if not all(os.path.exists(p) for p in paths):
        raise FileNotFoundError(f"no hubert.npz + hubert_kmeans.npz under {weights}")
    return load_params(paths[0]), load_params(paths[1])["centroids"]


def hubert_from_numpy(tree, num_layers: int):
    """JAX-layout HuBERT tree -> state dict of the port's ``HubertFeatures``
    with its first ``num_layers`` layers.

    Conv kernels [K, C_in, C_out] and the grouped positional kernel
    [K, H / groups, H] become [C_out, C_in (per group), K]; linear kernels
    [in, out] become [out, in]; LayerNorm and GroupNorm scale/bias become
    weight/bias.
    """
    state = {}

    def conv(prefix, p):
        state[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
        if p.get("bias") is not None:
            state[f"{prefix}.bias"] = _t(p["bias"])

    def linear(prefix, p):
        state[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
        if p.get("bias") is not None:
            state[f"{prefix}.bias"] = _t(p["bias"])

    def norm(prefix, p):
        state[f"{prefix}.weight"] = _t(p["scale"])
        state[f"{prefix}.bias"] = _t(p["bias"])

    fe = tree["feature_extractor"]
    for i, p in enumerate(fe["convs"]):
        conv(f"extractor.convs.{i}", p)
    norm("extractor.group_norm", fe["group_norm"])
    norm("fp_layer_norm", tree["feature_projection"]["layer_norm"])
    linear("projection", tree["feature_projection"]["projection"])
    conv("pos_conv.conv", tree["pos_conv"])
    norm("encoder_layer_norm", tree["encoder_layer_norm"])
    for i, p in enumerate(tree["layers"][:num_layers]):
        pre = f"layers.{i}"
        for name in ("q", "k", "v", "out"):
            linear(f"{pre}.attn.{name}", p["attn"][name])
        norm(f"{pre}.layer_norm", p["layer_norm"])
        linear(f"{pre}.ffn_in", p["ffn"]["in"])
        linear(f"{pre}.ffn_out", p["ffn"]["out"])
        norm(f"{pre}.final_layer_norm", p["final_layer_norm"])
    return state


def get_semantic_gpt_params(weights: str, seed: int, artifact_key: str, vocab_size: int,
                            config=None):
    """(GPT params, GPTConfig) of the semantic -> acoustic model (12 layers,
    12 heads, 768 wide, block 1024, ``vocab_size``).

    ``weights`` is a directory holding ``<artifact_key>.npz`` (for example
    ``gpt_semantic_m_hi.npz``), ``"artifacts"`` (the nanoGPT checkpoint
    ``configs.ARTIFACTS[artifact_key]``) or ``"random"``. ``config``
    replaces the full-size GPTConfig (tests)."""
    from .nn.gpt import GPTConfig, init_gpt_params

    cfg = config or GPTConfig(vocab_size=vocab_size)
    if weights == "artifacts":
        return artifact_tree(artifact_key, cfg), cfg
    if weights == "random":
        return init_gpt_params(np.random.default_rng(seed), cfg), cfg
    path = os.path.join(weights, f"{artifact_key}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {artifact_key}.npz under {weights}")
    return load_params(path), cfg


def get_bark_fine_params(weights: str, seed: int, config=None):
    """(Bark-fine params, BarkFineConfig): 24 layers, 16 heads, 1024 wide.

    ``weights`` is a directory holding ``bark_fine.npz``, ``"artifacts"``
    (suno's fine checkpoint staged as ``convert.checkpoints.STAGED["bark_fine"]``, else HF's
    ``BarkFineModel`` from the hub) or ``"random"``. ``config`` replaces the
    full-size BarkFineConfig (tests)."""
    from .nn.bark_fine import BarkFineConfig, init_bark_fine_params

    cfg = config or BarkFineConfig()
    if weights == "artifacts":
        return artifact_tree("bark_fine", cfg), cfg
    if weights == "random":
        return init_bark_fine_params(np.random.default_rng(seed), cfg), cfg
    path = os.path.join(weights, "bark_fine.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no bark_fine.npz under {weights}")
    return load_params(path), cfg


def _transformer_state(layers, state):
    """Blocks of the GPT and of Bark-fine, which share their layout:
    linear kernels [in, out] -> weight [out, in]; LN scale/bias ->
    weight/bias."""

    def linear(prefix, p):
        state[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
        if p.get("bias") is not None:
            state[f"{prefix}.bias"] = _t(p["bias"])

    def layer_norm(prefix, p):
        state[f"{prefix}.weight"] = _t(p["scale"])
        if p.get("bias") is not None:
            state[f"{prefix}.bias"] = _t(p["bias"])

    for i, p in enumerate(layers):
        layer_norm(f"layers.{i}.ln1", p["ln1"])
        layer_norm(f"layers.{i}.ln2", p["ln2"])
        linear(f"layers.{i}.qkv", p["attn"]["qkv"])
        linear(f"layers.{i}.out", p["attn"]["out"])
        linear(f"layers.{i}.mlp_in", p["mlp"]["in"])
        linear(f"layers.{i}.mlp_out", p["mlp"]["out"])
    return layer_norm


def gpt_from_numpy(tree):
    """JAX-layout GPT tree -> state dict of the port's ``GPT``."""
    state = {"wte": _t(tree["wte"]), "wpe": _t(tree["wpe"])}
    layer_norm = _transformer_state(tree["layers"], state)
    layer_norm("ln_f", tree["ln_f"])
    return state


def gpt_to_numpy(model):
    """The port's ``GPT`` -> JAX-layout tree (f32 numpy; linear kernels
    [in, out], absent biases None): the inverse of :func:`gpt_from_numpy`,
    so that a trained GPT goes to ``save_params`` and back through
    ``weights=<dir>``."""

    def a(t):
        return t.detach().float().cpu().numpy()

    def linear(m):
        return {"kernel": np.ascontiguousarray(a(m.weight).T),
                "bias": None if m.bias is None else a(m.bias)}

    def layer_norm(m):
        return {"scale": a(m.weight), "bias": None if m.bias is None else a(m.bias)}

    return {
        "wte": a(model.wte), "wpe": a(model.wpe), "ln_f": layer_norm(model.ln_f),
        "layers": [{"ln1": layer_norm(b.ln1),
                    "attn": {"qkv": linear(b.qkv), "out": linear(b.out)},
                    "ln2": layer_norm(b.ln2),
                    "mlp": {"in": linear(b.mlp_in), "out": linear(b.mlp_out)}}
                   for b in model.layers],
    }


def bark_fine_from_numpy(tree):
    """JAX-layout Bark-fine tree -> state dict of the port's ``BarkFine``;
    the lm_heads [C, vocab] become [vocab, C]."""
    state = {"wpe": _t(tree["wpe"])}
    for i, w in enumerate(tree["wtes"]):
        state[f"wtes.{i}"] = _t(w)
    for i, w in enumerate(tree["lm_heads"]):
        state[f"lm_heads.{i}"] = _t(np.asarray(w).T)
    layer_norm = _transformer_state(tree["layers"], state)
    layer_norm("ln_f", tree["ln_f"])
    return state
