"""K1's plain version against the JAX package's fused SEANet front (Pallas,
interpret mode) and against its XLA front (conv_in + first residual block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.seanet import SeanetConfig as JaxSeanetConfig
from audiotoken_tpu.nn.seanet import _resnet_block
from audiotoken_tpu.ops.conv import conv1d as jax_conv1d
from audiotoken_tpu.ops.seanet_pallas import seanet_front_fused
from audiotoken_tpu_torch.nn.seanet import SeanetConfig, SeanetEncoder, init_encoder_params
from audiotoken_tpu_torch.ops.seanet_front import seanet_front, seanet_front_plain
from audiotoken_tpu_torch.weights import acoustic_from_numpy

ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return init_encoder_params(np.random.default_rng(0), SeanetConfig())


@pytest.fixture(scope="module")
def front_weights(params):
    enc = SeanetEncoder()
    state, _ = acoustic_from_numpy({"encoder": params, "codebooks": np.zeros((1, 1, 128))})
    enc.load_state_dict(state)
    return enc.front_weights()


def _xla_front(params, x):
    h = jax_conv1d(jnp.asarray(x)[:, None, :], params["conv_in"]["kernel"],
                   params["conv_in"]["bias"], layout="NCH")
    return _resnet_block(params["stages"][0]["res"][0], h, JaxSeanetConfig(), 1,
                         jax.lax.Precision.HIGHEST, "NCH")


@pytest.mark.parametrize("T", [4096, 9000, 8315, 320])
def test_plain_front_matches_jax(params, front_weights, T):
    x = (np.random.default_rng(T).standard_normal((2, T)) * 0.3).astype(np.float32)
    out = seanet_front_plain(torch.from_numpy(x), *front_weights).numpy()
    fused = np.asarray(seanet_front_fused(params, jnp.asarray(x), interpret=True))
    xla = np.asarray(_xla_front(params, x))
    assert out.shape == fused.shape == xla.shape == (2, 32, T)
    np.testing.assert_allclose(out, fused, atol=ATOL)
    np.testing.assert_allclose(out, xla, atol=ATOL)


@pytest.mark.parametrize("T", [1, 2, 3, 6])
def test_plain_front_shorter_than_padding(params, front_weights, T):
    """Zero extension before the reflection (EncodecConv1d._pad1d)."""
    x = (np.random.default_rng(T).standard_normal((1, T)) * 0.3).astype(np.float32)
    out = seanet_front_plain(torch.from_numpy(x), *front_weights).numpy()
    np.testing.assert_allclose(out, np.asarray(_xla_front(params, x)), atol=ATOL)


def test_wrapper_dispatch(front_weights):
    """A CPU tensor runs the plain version without a launch; a tensor on a
    device without the kernel raises."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 500)).astype(np.float32))
    before = seanet_front.launches
    torch.testing.assert_close(seanet_front(x, *front_weights),
                               seanet_front_plain(x, *front_weights), rtol=0, atol=0)
    assert seanet_front.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        seanet_front(x.to("meta"), *front_weights)
