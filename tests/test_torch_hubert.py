"""The port's HuBERT (``nn/hubert.py``) against the JAX package's, on the CPU.

Both packages get the same parameters (the JAX package's draws, bridged
with ``hubert_from_numpy``) and the same audio. ``hubert_features`` runs
with both attention forms: ``"xla"`` and ``"flash"`` (the Pallas kernel in
interpret mode; the port's K4 plain version), with a valid-prefix mask and
with a mask that has a hole, at a small config (2 layers, 128 wide) and at
full width (11 layers) on 0.5 s of audio. The features are O(1); both
sides compute in f32 and sum in other orders, so they agree within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.hubert import HubertConfig as JaxHubertConfig
from audiotoken_tpu.nn.hubert import feature_lengths as jax_feature_lengths
from audiotoken_tpu.nn.hubert import hubert_features
from audiotoken_tpu.nn.hubert import init_hubert_params as jax_init_hubert_params
from audiotoken_tpu_torch.nn.hubert import (
    HubertConfig,
    HubertFeatures,
    feature_lengths,
    init_hubert_params,
)
from audiotoken_tpu_torch.weights import hubert_from_numpy

ATOL = 1e-4
SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256, conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)
N = 8000  # 0.5 s at 16 kHz: 24 frames


def _leaves(tree):
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (None if v is None else np.asarray(v)) for p, v in paths}


@pytest.fixture(scope="module")
def full_params():
    return jax_init_hubert_params(np.random.default_rng(0), JaxHubertConfig())


def _audio_and_masks():
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2, N)) * 0.5).astype(np.float32)
    prefix = np.ones((2, N), np.float32)
    prefix[1, N - 2500:] = 0.0
    x = x * prefix
    holes = prefix.copy()
    holes[0, 3000:3400] = 0.0
    return x, {"prefix": prefix, "holes": holes, "none": None}


def _port_model(params, cfg_kw, attn_impl, layers):
    model = HubertFeatures(HubertConfig(attn_impl=attn_impl, **cfg_kw), output_layer=layers)
    model.load_state_dict(hubert_from_numpy(params, layers))
    return model.eval()


def _compare(params, cfg_kw, attn_impl, mask_name, layers):
    x, masks = _audio_and_masks()
    mask = masks[mask_name]
    jcfg = JaxHubertConfig(attn_impl=attn_impl, **cfg_kw)
    ref = np.asarray(hubert_features(params, x, mask, jcfg, output_layer=layers))
    model = _port_model(params, cfg_kw, attn_impl, layers)
    with torch.inference_mode():
        out = model(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert out.shape == ref.shape == (2, feature_lengths(N, HubertConfig(**cfg_kw)),
                                      cfg_kw.get("hidden_size", 768))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mask_name", ["prefix", "holes", "none"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_small_config_matches_jax(attn_impl, mask_name):
    params = jax_init_hubert_params(np.random.default_rng(5), JaxHubertConfig(**SMALL))
    _compare(params, SMALL, attn_impl, mask_name, layers=2)


@pytest.mark.parametrize("mask_name", ["prefix", "holes"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_full_width_matches_jax(full_params, attn_impl, mask_name):
    _compare(full_params, {}, attn_impl, mask_name, layers=11)


def test_init_draws_bit_identical(full_params):
    ours = _leaves(init_hubert_params(np.random.default_rng(0), HubertConfig()))
    ref = _leaves(full_params)
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if v is None:
            assert ours[k] is None, k
        else:
            assert ours[k].dtype == np.float32 and np.array_equal(ours[k], v), k


def test_bridge_fills_every_parameter(full_params):
    model = HubertFeatures(HubertConfig(), output_layer=11)
    state = hubert_from_numpy(full_params, 11)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # shapes match
    # the grouped positional kernel [K, H / groups, H] -> [H, H / groups, K]
    np.testing.assert_array_equal(state["pos_conv.conv.weight"][5, :, 7].numpy(),
                                  np.asarray(full_params["pos_conv"]["kernel"])[7, :, 5])


@pytest.mark.parametrize("n", [400, 401, 719, 720, 8000, 480_000])
def test_feature_lengths_match(n):
    assert feature_lengths(n, HubertConfig()) == jax_feature_lengths(n, JaxHubertConfig())
    lengths = feature_lengths(torch.tensor([n]), HubertConfig())
    assert int(lengths[0]) == feature_lengths(n, HubertConfig())


def test_refuses_unknown_attention():
    with pytest.raises(ValueError, match="attn_impl"):
        HubertFeatures(HubertConfig(attn_impl="sdpa"))
