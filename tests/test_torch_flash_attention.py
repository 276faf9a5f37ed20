"""K4's plain version against the JAX package's rel-key flash attention
(Pallas in interpret mode) and against its XLA reference, on the CPU.

atol 2e-5: f32 reassociation only, as the JAX package's own flash test
states. The CUDA kernel itself is held against this plain version on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.conformer import _skew_band
from audiotoken_tpu.ops.attention import padding_bias as jax_padding_bias
from audiotoken_tpu.ops.flash_attention import flash_attention_relkey as jax_flash
from audiotoken_tpu_torch.ops.attention import padding_bias
from audiotoken_tpu_torch.ops.flash_attention import (
    flash_attention_relkey,
    flash_attention_relkey_plain,
)

ATOL = 2e-5
LEFT, RIGHT, DH = 64, 8, 64
HIGHEST = jax.lax.Precision.HIGHEST


def xla_reference(q, k, v, E, frame_mask, left=LEFT, right=RIGHT):
    """tests/test_flash_attention.py's reference, with the rel term and the
    mask optional."""
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision=HIGHEST,
                        preferred_element_type=jnp.float32)
    if E is not None:
        pos = jnp.einsum("bhqd,pd->bhqp", q, E, precision=HIGHEST,
                         preferred_element_type=jnp.float32)
        scores = scores + _skew_band(pos, q.shape[2], left, right)
    scores = scores * (q.shape[-1] ** -0.5)
    if frame_mask is not None:
        scores = scores + jax_padding_bias(frame_mask)
    probs = jax.nn.softmax(scores, axis=-1)
    return np.asarray(jnp.einsum("bhqk,bhkd->bhqd", probs, v, precision=HIGHEST,
                                 preferred_element_type=jnp.float32))


def _inputs(seed, B, H, T):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, T, DH)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, H, T, DH)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, H, T, DH)).astype(np.float32)
    E = (rng.standard_normal((LEFT + RIGHT + 1, DH)) * 0.05).astype(np.float32)
    return q, k, v, E


def _plain(q, k, v, E, mask):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return flash_attention_relkey_plain(t(q), t(k), t(v), t(E), t(mask), LEFT, RIGHT).numpy()


@pytest.mark.parametrize("has_mask", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("has_rel", [True, False], ids=["rel", "norel"])
@pytest.mark.parametrize("T", [256, 600, 1500 - 7])
def test_plain_matches_jax(T, has_rel, has_mask):
    B, H = (2, 2) if T < 1000 else (1, 2)
    q, k, v, E = _inputs(T, B, H, T)
    E = E if has_rel else None
    mask = None
    if has_mask:
        mask = np.ones((B, T), np.float32)
        mask[-1, T - 40:] = 0.0  # a padded row
    out = _plain(q, k, v, E, mask)
    assert out.shape == (B, H, T, DH) and out.dtype == np.float32
    np.testing.assert_allclose(out, xla_reference(q, k, v, E, mask), rtol=0, atol=ATOL)
    if has_mask:  # without a mask the Pallas function runs the same kernel on a mask of ones
        kern = np.asarray(jax_flash(q, k, v, E, mask, left=LEFT, right=RIGHT, interpret=True))
        np.testing.assert_allclose(out, kern, rtol=0, atol=ATOL)


@pytest.mark.parametrize("T", [256, 600])
def test_all_masked_row(T):
    """A batch row whose keys are all masked gets finfo.min on every key,
    so a uniform average over its T keys: finite, and equal to the XLA
    reference. (The Pallas kernel pads T to a tile multiple and averages
    over the padding too, so it agrees only where T is tile-aligned.)"""
    q, k, v, E = _inputs(3 * T, 2, 2, T)
    mask = np.ones((2, T), np.float32)
    mask[1] = 0.0
    out = _plain(q, k, v, E, mask)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, xla_reference(q, k, v, E, mask), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True),
                                                       out[1].shape), rtol=0, atol=ATOL)
    if T % 256 == 0:
        kern = np.asarray(jax_flash(q, k, v, E, mask, left=LEFT, right=RIGHT, interpret=True))
        np.testing.assert_allclose(out, kern, rtol=0, atol=ATOL)


def test_padding_bias_equals_jax():
    mask = np.array([[1, 1, 0], [0, 1, 1]], np.float32)
    np.testing.assert_array_equal(padding_bias(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jax_padding_bias(mask)))


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    q, k, v, E = _inputs(9, 1, 2, 100)
    mask = np.ones((1, 100), np.float32)
    mask[0, 70:] = 0.0
    before = flash_attention_relkey.launches
    t = torch.from_numpy
    out = flash_attention_relkey(t(q), t(k), t(v), t(E), t(mask), left=LEFT, right=RIGHT)
    assert flash_attention_relkey.launches == before
    np.testing.assert_array_equal(out.numpy(), _plain(q, k, v, E, mask))


def test_plain_refuses_wrong_embedding_rows():
    q, k, v, E = _inputs(1, 1, 1, 20)
    with pytest.raises(ValueError, match="left \\+ right \\+ 1"):
        flash_attention_relkey_plain(*map(torch.from_numpy, (q, k, v, E[:10])), None, LEFT, RIGHT)
