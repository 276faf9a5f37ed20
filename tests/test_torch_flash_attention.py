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
    flash_attention_relkey_bf16,
    flash_attention_relkey_plain,
    noncausal_attention_plain,
)
from torch_tf32 import tf32

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


def _bf16_ulps(out, ref):
    """|out - ref| in units of the last place of bf16 at ref's magnitude
    (magnitudes below 2^-6 counted at 2^-6)."""
    mag = np.maximum(np.abs(ref), 2.0**-6)
    return np.abs(out - ref) / 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("T,has_rel,has_mask", [(200, True, True), (200, False, True),
                                                (256, False, False)],
                         ids=["rel-mask", "mask", "plain-k5"])
def test_bf16_matches_jax(T, has_rel, has_mask):
    """K4's bf16 form against the Pallas kernel in interpret mode on the same
    bf16 inputs: T not a tile multiple with both terms and with the mask
    alone, and the form with neither term at T = 256, which both packages
    hand to K5 with q pre-scaled in bf16. Within one bf16 unit in the last
    place: the kernel rounds p against its running maximum a key tile at a
    time, the plain version against the row's."""
    q, k, v, E = _inputs(T + 1, 1, 2, T)
    E = E if has_rel else None
    mask = None
    if has_mask:
        mask = np.ones((1, T), np.float32)
        mask[0, T - 40:] = 0.0
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_flash(qb, kb, vb, E, mask, left=LEFT, right=RIGHT,
                               interpret=True).astype(jnp.float32))
    bf = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = flash_attention_relkey(bf(qb), bf(kb), bf(vb), t(E), t(mask), left=LEFT, right=RIGHT)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, T, DH)
    assert _bf16_ulps(out.float().numpy(), ref).max() <= 1.0
    if not has_rel and not has_mask:  # the K5 route, bit for bit
        ref_k5 = noncausal_attention_plain(bf(qb) * DH**-0.5, bf(kb), bf(vb))
        assert torch.equal(out, ref_k5)
    else:
        assert torch.equal(out, flash_attention_relkey_plain(
            bf(qb), bf(kb), bf(vb), t(E), t(mask), LEFT, RIGHT))


def test_bf16_kernel_wrapper_runs_plain_on_the_cpu():
    """K4's bf16 wrapper on CPU tensors: the plain version, E rounded to
    bf16 and the mask taken in f32, no launch counted."""
    q, k, v, E = (torch.from_numpy(a) for a in _inputs(4, 1, 2, 70))
    mask = torch.ones((1, 70), dtype=torch.bfloat16)
    mask[0, 50:] = 0
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    before = flash_attention_relkey_bf16.launches
    out = flash_attention_relkey_bf16(q, k, v, E, mask, LEFT, RIGHT)
    assert flash_attention_relkey_bf16.launches == before
    assert torch.equal(out, flash_attention_relkey_plain(q, k, v, E.bfloat16(), mask.float(),
                                                         LEFT, RIGHT))


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


def _split_product(a, b, terms):
    """a @ b as K4's tensor cores take it: each operand split into hi =
    tf32(x) and lo = tf32(x - hi), the sum of the ``terms`` (3: lo hi + hi lo
    + hi hi; 1: hi hi alone) taken exactly (f64) and rounded to the f32
    accumulator."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    f = lambda x: x.astype(np.float64)  # noqa: E731
    out = f(a_hi) @ f(b_hi)
    if terms == 3:
        out += f(a_lo) @ f(b_hi) + f(a_hi) @ f(b_lo)
    return out.astype(np.float32)


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "tf32"])
def test_tf32_split_keeps_f32_accuracy(terms):
    """K4's products in 3xTF32 (csrc/flash_attention.cu) give K4's function
    with the rel term and a mask within 1e-5 of the output's scale of an f64
    reference; one TF32 pass does not, so the test can tell."""
    q, k, v, E = _inputs(11, 1, 2, 200)
    mask = np.ones((1, 200), np.float32)
    mask[0, 150:] = 0.0
    t = np.arange(200)
    idx = np.clip(t[None, :] - t[:, None] + LEFT, 0, LEFT + RIGHT)
    bias = (1.0 - mask) * np.finfo(np.float32).min

    def attention(prod, dtype):
        q_, k_, v_, E_ = (x.astype(dtype) for x in (q, k, v, E))
        s = prod(q_, np.swapaxes(k_, -1, -2))
        pos = q_ @ E_.T  # f32 FMAs in the kernel
        s = (s + pos[:, :, t[:, None], idx]) * dtype(0.125) + bias[:, None, None, :].astype(dtype)
        p = np.exp(s - s.max(-1, keepdims=True))
        return prod(p, v_) / p.sum(-1, keepdims=True)

    ref = attention(np.matmul, np.float64)
    out = attention(lambda a, b: _split_product(a, b, terms), np.float32)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    if terms == 3:
        assert err <= 1e-5, err
    else:
        assert err > 1e-5, err
