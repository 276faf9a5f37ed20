"""Port weights against the JAX package's: random init, the npz store, and
the layout bridges to the port's SeanetEncoder and W2VBertFeatures."""

import jax
import numpy as np
import pytest
import torch

from audiotoken_tpu.convert.store import load_params as jax_load_params
from audiotoken_tpu.convert.store import save_params as jax_save_params
from audiotoken_tpu.configs import Wav2VecBertConfig as JaxWav2VecBertConfig
from audiotoken_tpu.weights import get_acoustic_params as jax_get_acoustic_params
from audiotoken_tpu.weights import get_w2vbert_params as jax_get_w2vbert_params
from audiotoken_tpu_torch.convert.store import load_params
from audiotoken_tpu_torch.nn.conformer import W2VBertConfig, W2VBertFeatures, init_w2vbert_params
from audiotoken_tpu_torch.nn.seanet import SeanetEncoder
from audiotoken_tpu_torch.weights import (
    acoustic_from_numpy,
    get_acoustic_params,
    get_w2vbert_params,
    w2vbert_from_numpy,
)
from test_torch_offline import offline


def _leaves(tree):
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in paths}


def _assert_trees_bitwise_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype == np.float32, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
def test_random_params_bitwise_equal(seed):
    _assert_trees_bitwise_equal(
        get_acoustic_params("random", seed), jax_get_acoustic_params("random", seed)
    )


def test_npz_store_loads_identically(tmp_path):
    params = jax_get_acoustic_params("random", 3)
    jax_save_params(str(tmp_path / "acoustic.npz"), params)
    _assert_trees_bitwise_equal(get_acoustic_params(str(tmp_path)), params)
    _assert_trees_bitwise_equal(
        load_params(str(tmp_path / "acoustic.npz")),
        jax_load_params(str(tmp_path / "acoustic.npz")),
    )


def test_npz_store_none_leaves(tmp_path):
    tree = {"a": {"w": np.ones((2, 3), np.float32), "b": None},
            "layers": [{"x": np.zeros(2, np.float32)}, {"x": np.ones(2, np.float32)}]}
    jax_save_params(str(tmp_path / "t.npz"), tree)
    out = load_params(str(tmp_path / "t.npz"))
    assert out["a"]["b"] is None and isinstance(out["layers"], list)
    np.testing.assert_array_equal(out["layers"][1]["x"], tree["layers"][1]["x"])


def test_bridge_layout():
    params = get_acoustic_params("random", 0)
    state, codebooks = acoustic_from_numpy(params)
    enc = SeanetEncoder()
    enc.load_state_dict(state)  # strict: every parameter named and shaped
    kin = params["encoder"]["conv_in"]["kernel"]  # [K, C_in, C_out]
    np.testing.assert_array_equal(enc.conv_in.weight.numpy(), kin.transpose(2, 1, 0))
    down = params["encoder"]["stages"][2]["down"]["kernel"]
    np.testing.assert_array_equal(enc.stages[2].down.weight.numpy(), down.transpose(2, 1, 0))
    whh = params["encoder"]["lstm"]["layers"][1]["whh"]
    np.testing.assert_array_equal(enc.lstm[1].whh.numpy(), whh)
    assert codebooks.dtype == torch.float32 and tuple(codebooks.shape) == (32, 1024, 128)
    np.testing.assert_array_equal(codebooks.numpy(), params["codebooks"])


def test_unavailable_sources_raise(tmp_path, monkeypatch):
    offline(monkeypatch, tmp_path)  # weights="artifacts" with nothing staged
    with pytest.raises(FileNotFoundError, match="AUDIOTOKEN_ARTIFACTS"):
        get_acoustic_params("artifacts")
    with pytest.raises(FileNotFoundError):
        get_acoustic_params(str(tmp_path))


def test_w2vbert_random_params_bitwise_equal():
    """All 21 blocks and then the [2048, 1024] codebook, from one generator."""
    params, codebook = get_w2vbert_params("random", 0)
    jparams, jcodebook = jax_get_w2vbert_params("random", 0, JaxWav2VecBertConfig())
    _assert_trees_bitwise_equal(params, jparams)
    assert codebook.dtype == np.float32 and codebook.shape == (2048, 1024)
    np.testing.assert_array_equal(codebook, jcodebook)


def test_w2vbert_npz_store_loads_identically(tmp_path):
    cfg = W2VBertConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=64)
    params = init_w2vbert_params(np.random.default_rng(4), cfg)
    codebook = np.random.default_rng(5).standard_normal((8, 32)).astype(np.float32)
    jax_save_params(str(tmp_path / "w2vbert.npz"), params)
    jax_save_params(str(tmp_path / "w2vbert_vq.npz"), {"codebook": codebook})
    got, got_cb = get_w2vbert_params(str(tmp_path))
    _assert_trees_bitwise_equal(got, params)
    np.testing.assert_array_equal(got_cb, codebook)


def test_w2vbert_bridge_layout():
    cfg = W2VBertConfig(hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                        intermediate_size=64)
    params = init_w2vbert_params(np.random.default_rng(6), cfg)
    m = W2VBertFeatures(cfg, 2).requires_grad_(False)
    m.load_state_dict(w2vbert_from_numpy(params, 2))  # strict: every parameter named and shaped
    layer = params["layers"][1]
    np.testing.assert_array_equal(m.layers[1].ffn1.inp.weight.numpy(),
                                  layer["ffn1"]["in"]["kernel"].T)
    np.testing.assert_array_equal(m.layers[1].attn.k.weight.numpy(), layer["attn"]["k"]["kernel"].T)
    np.testing.assert_array_equal(m.layers[1].conv.dw_weight.numpy(),
                                  layer["conv"]["dw_kernel"].transpose(2, 1, 0))
    assert m.layers[1].conv.pw1.bias is None
    np.testing.assert_array_equal(m.layers[1].attn.distance_embedding.numpy(),
                                  layer["attn"]["distance_embedding"])


def test_w2vbert_unavailable_sources_raise(tmp_path, monkeypatch):
    offline(monkeypatch, tmp_path)  # weights="artifacts" with nothing staged
    with pytest.raises(FileNotFoundError, match="AUDIOTOKEN_ARTIFACTS"):
        get_w2vbert_params("artifacts")
    with pytest.raises(FileNotFoundError, match="w2vbert_vq"):
        get_w2vbert_params(str(tmp_path))
