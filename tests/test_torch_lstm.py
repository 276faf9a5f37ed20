"""K2's plain version against the JAX package's LSTM kernel (Pallas,
interpret mode) and against ``nn/seanet.py:lstm_skip``."""

import jax
import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.seanet import lstm_skip as jax_lstm_skip
from audiotoken_tpu.ops.lstm_pallas import lstm_layer_pallas
from audiotoken_tpu_torch.nn.seanet import _lstm_init
from audiotoken_tpu_torch.ops.lstm import lstm_layer, lstm_layer_plain, lstm_skip

ATOL = 1e-5


def _layers(params):
    return [tuple(torch.from_numpy(l[n]) for n in ("wih", "whh", "bih", "bhh"))
            for l in params["layers"]]


@pytest.mark.parametrize("H", [64, 512])
def test_plain_layer_matches_pallas(H):
    rng = np.random.default_rng(H)
    xi = rng.standard_normal((3, 37, 4 * H)).astype(np.float32)
    s = 1.0 / np.sqrt(H)
    whh = rng.uniform(-s, s, (4 * H, H)).astype(np.float32)
    out = lstm_layer_plain(torch.from_numpy(xi), torch.from_numpy(whh)).numpy()
    ref = np.asarray(lstm_layer_pallas(xi, whh, interpret=True))
    assert out.shape == ref.shape == (3, 37, H)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("H,T", [(64, 75), (512, 20)])
def test_lstm_skip_matches_jax(H, T):
    params = _lstm_init(np.random.default_rng(0), H, 2)
    x = (np.random.default_rng(T).standard_normal((3, T, H)) * 0.5).astype(np.float32)
    out = lstm_skip(_layers(params), torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_lstm_skip(params, x, jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(5)
    xi = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    whh = torch.from_numpy(rng.uniform(-0.3, 0.3, (32, 8)).astype(np.float32))
    before = lstm_layer.launches
    torch.testing.assert_close(lstm_layer(xi, whh), lstm_layer_plain(xi, whh), rtol=0, atol=0)
    assert lstm_layer.launches == before
