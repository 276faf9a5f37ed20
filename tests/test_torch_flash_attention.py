"""K4's plain version against the JAX package's rel-key flash attention
(Pallas in interpret mode) and against its XLA reference, on the CPU.

atol 2e-5: f32 reassociation only, as the JAX package's own flash test
states. The CUDA kernel itself is held against this plain version on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

The wrappers' ``precision`` against the JAX kernel's at ``HIGHEST``,
``HIGH`` and ``DEFAULT`` (interpret mode computes all three in f32, and the
port's CPU path does too), its refusals, and the one-pass kernel's twin
(``tf32=True``) against a numpy transcription of the kernel's loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.conformer import _skew_band
from audiotoken_tpu.ops.attention import padding_bias as jax_padding_bias
from audiotoken_tpu.ops.flash_attention import _flash_attention_plain as jax_flash_plain
from audiotoken_tpu.ops.flash_attention import flash_attention_relkey as jax_flash
from audiotoken_tpu_torch.ops.attention import padding_bias
from audiotoken_tpu_torch.ops.flash_attention import (
    ONEPASS_KEY_TILE,
    flash_attention_plain,
    flash_attention_relkey,
    flash_attention_relkey_bf16,
    flash_attention_relkey_plain,
    kernel_passes,
    noncausal_attention_plain,
    tf32_round,
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


# --- precision -----------------------------------------------------------------

JAX_PRECISION = {"highest": HIGHEST, "high": jax.lax.Precision.HIGH,
                 "default": jax.lax.Precision.DEFAULT}


@pytest.mark.parametrize("precision", list(JAX_PRECISION))
@pytest.mark.parametrize("form", ["rel_mask", "mask", "plain"])
def test_precision_matches_jax(form, precision):
    """Each wrapper at each precision against the JAX function at the same
    one (Pallas in interpret mode): on the CPU both compute in f32, so the
    port's CPU path is the plain version at every precision, and no kernel
    launch is counted. (The shapes and inputs of test_plain_matches_jax at
    T = 256, and HIGHEST as its default: JAX's trace there is reused.)"""
    T = 256
    q, k, v, E = _inputs(T, 2, 2, T)
    mask = np.ones((2, T), np.float32)
    mask[-1, T - 40:] = 0.0
    t = torch.from_numpy
    counts = (flash_attention_relkey.launches, flash_attention_relkey.launches_1pass,
              flash_attention_plain.launches, flash_attention_plain.launches_1pass)
    jax_kw = {} if precision == "highest" else {"precision": JAX_PRECISION[precision]}
    if form == "plain":
        out = flash_attention_plain(t(q * 0.125), t(k), t(v), precision=precision).numpy()
        ref = jax_flash_plain(q, k, v, interpret=True, **jax_kw)
        plain = noncausal_attention_plain(t(q * 0.125), t(k), t(v)).numpy()
    else:
        E_ = E if form == "rel_mask" else None
        out = flash_attention_relkey(t(q), t(k), t(v), None if E_ is None else t(E_), t(mask),
                                     left=LEFT, right=RIGHT, precision=precision).numpy()
        ref = jax_flash(q, k, v, E_, mask, left=LEFT, right=RIGHT, interpret=True, **jax_kw)
        plain = _plain(q, k, v, E_, mask)
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=ATOL)
    assert (flash_attention_relkey.launches, flash_attention_relkey.launches_1pass,
            flash_attention_plain.launches, flash_attention_plain.launches_1pass) == counts


def test_kernel_passes():
    """JAX's lowering: HIGH runs as DEFAULT, one pass; HIGHEST in three."""
    assert [kernel_passes(p) for p in ("highest", "high", "default")] == [3, 1, 1]


@pytest.mark.parametrize("precision", ["bfloat16", "HIGHEST", "fast", None])
def test_unknown_precision_raises(precision):
    q, k, v, E = map(torch.from_numpy, _inputs(2, 1, 1, 16))
    with pytest.raises(ValueError, match="unknown precision"):
        flash_attention_relkey(q, k, v, E, None, precision=precision)
    with pytest.raises(ValueError, match="unknown precision"):
        flash_attention_plain(q, k, v, precision=precision)
    with pytest.raises(ValueError, match="unknown precision"):  # bf16 ignores it, but checks it
        flash_attention_relkey(q.bfloat16(), k.bfloat16(), v.bfloat16(), None, None,
                               precision=precision)


@pytest.mark.parametrize("form", ["rel_mask", "plain"])
def test_bf16_ignores_precision(form):
    """The JAX body's bf16 dots are one pass at any precision: bf16 input
    gives the same bits at every precision."""
    q, k, v, E = (torch.from_numpy(a).bfloat16() for a in _inputs(5, 1, 2, 256))
    mask = torch.ones((1, 256))
    mask[0, 200:] = 0.0
    outs = [flash_attention_plain(q, k, v, precision=p) if form == "plain" else
            flash_attention_relkey(q, k, v, E.float(), mask, precision=p)
            for p in JAX_PRECISION]
    assert outs[0].dtype == torch.bfloat16
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_tf32_round_matches_the_bit_rule():
    """:func:`tf32_round` against the numpy bit computation of
    tests/torch_tf32.py, and against the values round-to-nearest with ties
    away from zero gives: ties, negatives, subnormals, values next to powers
    of two, zeros, the largest finite values that stay finite."""
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32's unit at 1
    x = np.array([
        1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2, 1 + ulp / 2 - 2**-23, 1 + ulp / 2 + 2**-23,
        2 - 2**-23, 2 - ulp / 4, np.nextafter(one, np.float32(0)), 0.5 + 2**-13, 0.0, -0.0,
        1e-40, -1e-40, 2.0**-149, 2.0**-126 - 2.0**-149, 3e-39, -3.3e-39, 65504.0, 3.3e38,
        -3.3e38, np.pi, -np.e,
    ], np.float32)
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), tf32(x).view(np.uint32))
    tiny = np.float32(2.0**-149)  # the least subnormal; TF32 keeps its 13 low bits at 0
    want = {0: 1 + ulp, 1: -(1 + ulp), 2: 1 + 2 * ulp, 3: 1.0, 4: 1 + ulp, 5: 2.0, 6: 2.0,
            7: 1.0, 9: 0.0, 11: 9 * 2**13 * tiny, 12: -9 * 2**13 * tiny, 13: 0.0}
    for i, w in want.items():
        assert got[i] == np.float32(w), (i, x[i], got[i], w)
    assert np.signbit(got[10])
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    bits = np.random.default_rng(0).integers(0, 0x7F7FE000, 100_000, dtype=np.uint32)
    bits[::2] |= np.uint32(0x80000000)
    r = bits.view(np.float32)
    np.testing.assert_array_equal(tf32_round(torch.from_numpy(r)).numpy().view(np.uint32),
                                  tf32(r).view(np.uint32))


def _onepass_loop(q, k, v, E, mask, scale, log2=False):
    """The one-pass kernel's loop, transcribed in numpy: each product one
    TF32 pass (:func:`_split_product` with one term; q E^T the same, as the
    kernel's products over rounded operands), the online softmax over tiles
    of ONEPASS_KEY_TILE keys, p rounded against the running maximum. With
    ``log2``, the softmax of csrc/flash_attention_tf32.cu: the scores scaled
    by ``scale`` log2 e in one f32 multiply-add with the padding bias, which
    is added unscaled, and p = 2^(x - m)."""
    T = q.shape[-2]
    s = _split_product(q, np.swapaxes(k, -1, -2), 1)
    if E is not None:
        t = np.arange(T)
        idx = np.clip(t[None, :] - t[:, None] + LEFT, 0, LEFT + RIGHT)
        s = s + _split_product(q, E.T, 1)[:, :, t[:, None], idx]
    bias = 0.0
    if mask is not None:
        bias = ((1.0 - mask) * np.finfo(np.float32).min)[:, None, None, :].astype(np.float32)
    if log2:  # one rounding: the f64 product and sum are exact before it
        c = np.float32(scale * np.log2(np.e))
        s = (s.astype(np.float64) * c + bias).astype(np.float32)
    else:
        s = s * np.float32(scale) + bias
    exp = np.exp2 if log2 else np.exp
    m = np.full(s.shape[:-1] + (1,), -np.inf, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros(s.shape[:-1] + (DH,), np.float32)
    for j in range(0, T, ONEPASS_KEY_TILE):
        tile = s[..., j:j + ONEPASS_KEY_TILE]
        m_new = np.maximum(m, tile.max(-1, keepdims=True))
        alpha, p = exp(m - m_new), exp(tile - m_new)
        l = l * alpha + p.sum(-1, keepdims=True)
        acc = acc * alpha + _split_product(p, v[:, :, j:j + ONEPASS_KEY_TILE], 1)
        m = m_new
    return acc / np.maximum(l, 1e-30)


@pytest.mark.parametrize("form", ["rel_mask", "plain"])
def test_onepass_twin(form, log2=False):
    """``tf32=True`` is the one-pass kernel's function: it agrees with the
    numpy transcription of the kernel's loop (products by
    :func:`_split_product` with one term) within 2^-13 of the output's
    scale, where a p that rounds the other way after an f32-level
    difference in its score moves an output by at most 2^-10 p |v| / l; it
    lies more than 1e-5 of that scale from the f64 reference, as one TF32
    pass must (:func:`test_tf32_split_keeps_f32_accuracy`); and off the
    twin flag the plain version is unchanged."""
    q, k, v, E = _inputs(11, 1, 2, 200)
    t = torch.from_numpy
    if form == "plain":
        E, mask = None, None
        q = (q * 0.125).astype(np.float32)
        twin = noncausal_attention_plain(t(q), t(k), t(v), tf32=True).numpy()
        f32 = noncausal_attention_plain(t(q), t(k), t(v)).numpy()
        ref64 = noncausal_attention_plain(*(t(a.astype(np.float64)) for a in (q, k, v))).numpy()
        loop = _onepass_loop(q, k, v, None, None, 1.0, log2)
    else:
        mask = np.ones((1, 200), np.float32)
        mask[0, 150:] = 0.0
        twin = flash_attention_relkey_plain(t(q), t(k), t(v), t(E), t(mask), LEFT, RIGHT,
                                            tf32=True).numpy()
        f32 = _plain(q, k, v, E, mask)
        ref64 = xla_reference(*(a.astype(np.float64) for a in (q, k, v, E)), mask)
        loop = _onepass_loop(q, k, v, E, mask, 0.125, log2)
    scale = np.abs(ref64).max()
    assert twin.dtype == np.float32 and twin.shape == f32.shape
    assert np.abs(twin - loop).max() <= 2**-13 * scale, np.abs(twin - loop).max() / scale
    assert np.abs(twin - ref64).max() > 1e-5 * scale
    assert np.abs(f32 - ref64).max() <= 1e-5 * scale


@pytest.mark.parametrize("form", ["rel_mask", "plain"])
def test_onepass_twin_log2_softmax(form):
    """The same with the loop's softmax in the log2 domain, as
    csrc/flash_attention_tf32.cu takes it: the scores scaled by log2 e in
    the multiply-add with the bias, p = 2^(x - m)."""
    test_onepass_twin(form, log2=True)


def test_twin_takes_f32_only():
    q, k, v, E = (torch.from_numpy(a).bfloat16() for a in _inputs(3, 1, 1, 16))
    with pytest.raises(ValueError, match="f32"):
        flash_attention_relkey_plain(q, k, v, None, None, tf32=True)
    with pytest.raises(ValueError, match="f32"):
        noncausal_attention_plain(q, k, v, tf32=True)
