"""K3's plain version against the JAX package's fused RVQ kernel (Pallas,
interpret mode) and ``nn/rvq.py:rvq_encode``: codes must be equal."""

import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.rvq import RVQConfig as JaxRVQConfig
from audiotoken_tpu.nn.rvq import rvq_encode as jax_rvq_encode
from audiotoken_tpu.ops.rvq_pallas import rvq_encode_pallas
from audiotoken_tpu_torch.nn.rvq import RVQConfig, ResidualVQ, init_codebooks
from audiotoken_tpu_torch.ops.rvq import rvq_encode, rvq_encode_plain


@pytest.fixture(scope="module")
def codebooks():
    return init_codebooks(np.random.default_rng(0), RVQConfig())


@pytest.mark.parametrize("num_q", [2, 8, 16, 32])
def test_plain_matches_jax(codebooks, num_q):
    # N = 2 * 150 = 300 rows: not a multiple of the Pallas kernel's 256-row tile
    x = np.random.default_rng(num_q).standard_normal((2, 150, 128)).astype(np.float32)
    out = rvq_encode_plain(torch.from_numpy(codebooks), torch.from_numpy(x), num_q).numpy()
    ref_jnp = np.asarray(jax_rvq_encode(codebooks, x, num_q))
    ref_pallas = np.asarray(rvq_encode_pallas(codebooks, x, num_q, interpret=True))
    assert out.shape == ref_jnp.shape == (2, num_q, 150)
    np.testing.assert_array_equal(out, ref_jnp)
    np.testing.assert_array_equal(out, ref_pallas)


def test_exact_tie_takes_first_index():
    rng = np.random.default_rng(1)
    cb = rng.standard_normal((2, 1024, 128)).astype(np.float32)
    cb[0, 900] = cb[0, 17]
    x = (cb[0, [17, 900]] + 0.01 * rng.standard_normal((2, 128)))[None].astype(np.float32)
    out = rvq_encode_plain(torch.from_numpy(cb), torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(out[0, 0], [17, 17])
    np.testing.assert_array_equal(out, np.asarray(jax_rvq_encode(cb, x, 2)))


def test_residual_vq_module(codebooks):
    x = np.random.default_rng(4).standard_normal((3, 41, 128)).astype(np.float32)
    rvq = ResidualVQ(torch.from_numpy(codebooks), 8)
    before = rvq_encode.launches
    out = rvq(torch.from_numpy(x))
    assert out.dtype == torch.int32 and tuple(out.shape) == (3, 8, 41)
    assert rvq_encode.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_rvq_encode(codebooks, x, 8)))
    with pytest.raises(ValueError):
        ResidualVQ(torch.from_numpy(codebooks), 33)


@pytest.mark.parametrize("bandwidth", [1.5, 3.0, 6.0, 12.0, 24.0, None, 0])
def test_bandwidth_ladder(bandwidth):
    assert (RVQConfig().num_quantizers_for_bandwidth(bandwidth)
            == JaxRVQConfig().num_quantizers_for_bandwidth(bandwidth))
