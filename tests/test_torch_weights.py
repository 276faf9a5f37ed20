"""Port weights against the JAX package's: random init, the npz store, and
the layout bridge to the port's SeanetEncoder."""

import jax
import numpy as np
import pytest
import torch

from audiotoken_tpu.convert.store import load_params as jax_load_params
from audiotoken_tpu.convert.store import save_params as jax_save_params
from audiotoken_tpu.weights import get_acoustic_params as jax_get_acoustic_params
from audiotoken_tpu_torch.convert.store import load_params
from audiotoken_tpu_torch.nn.seanet import SeanetEncoder
from audiotoken_tpu_torch.weights import acoustic_from_numpy, get_acoustic_params


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


def test_unavailable_sources_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="converters"):
        get_acoustic_params("artifacts")
    with pytest.raises(FileNotFoundError):
        get_acoustic_params(str(tmp_path))
