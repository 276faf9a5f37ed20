"""K1's plain version against the JAX package's fused SEANet front (Pallas,
interpret mode) and against its XLA front (conv_in + first residual block).
K1's arithmetic on the card (3xTF32 products), transcribed in numpy,
against the same fronts and, patched into the port's encoder, against the
golden battery's codes under the acoustic contract."""

import os
import sys

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
from torch_tf32 import tf32

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import verify_tpu_parity as parity  # noqa: E402
from golden_cases import battery  # noqa: E402

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


# --- K1's arithmetic on the card, emulated --------------------------------
#
# csrc/seanet_front.cu runs conv_in as f32 FMAs, ELU by expm1f, and the k3
# conv, conv2 and the shortcut on the tensor cores in 3xTF32. The functions
# below transcribe that arithmetic in numpy.

F32 = np.float32


def _fma(a, b, c):
    """fmaf: the product of two f32 is exact in f64; one rounding to f32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(F32)


def _elu(v):
    """ELU in f32 by numpy's expm1 (the kernel takes CUDA's expm1f; both are
    within a few ulp of expm1)."""
    return np.where(v > 0, v, np.expm1(np.minimum(v, 0))).astype(F32)


def _mma(acc, a, b, terms):
    """acc += a @ b for one k-step of 8 as mma.sync takes it: in 3xTF32 the
    terms lo_a hi_b, hi_a lo_b and hi_a hi_b (``terms`` 3) or hi_a hi_b alone
    (1), each an mma whose 8 products are summed exactly and added to the f32
    accumulator with one rounding."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if terms == 3 else [(a_hi, b_hi)]
    for p, q in pairs:
        acc = (acc.astype(np.float64) + p.astype(np.float64) @ q.astype(np.float64)).astype(F32)
    return acc


def _slots(j):
    """The 8 input channels of k-step j over 32 channels: lane slot t holds
    channels 8t + 2j and 8t + 2j + 1."""
    return [c for t in range(4) for c in (8 * t + 2 * j, 8 * t + 2 * j + 1)]


def front_emulated(x, weights, terms=3):
    """x [B, T] f32 -> [B, 32, T] f32 with K1's arithmetic (module comment),
    its term and k-step order: conv_in; z1 = b1 + the k3 conv over the taps
    and k-steps; out = (bs + b2) + conv2 over ELU(z1) + the shortcut."""
    wc, bc, w1, b1, w2, b2, ws, bs = (w.numpy() for w in weights)
    B, T = x.shape

    def reflect(v, left):  # v [B, T, ...] with `left` samples v[|t|], 0 past T
        idx = np.abs(np.arange(-left, T))
        return np.where((idx < T)[None, :, None], v[:, np.minimum(idx, T - 1)], F32(0))

    xp = reflect(x[:, :, None], 6)[..., 0]
    a = np.broadcast_to(bc, (B, T, 32)).astype(F32)
    for k in range(7):
        a = _fma(xp[:, k:k + T, None], wc[None, None, :, 0, k], a)
    e = reflect(_elu(a), 2)
    z = np.broadcast_to(b1, (B, T, 16)).astype(F32)
    for k in range(3):
        for j in range(4):
            s = _slots(j)
            z = _mma(z, e[:, k:k + T][..., s], w1[:, s, k].T, terms)
    o = np.broadcast_to((bs + b2).astype(F32), (B, T, 32)).astype(F32)
    h = _elu(z)
    for j in range(2):
        s = list(range(8 * j, 8 * j + 8))
        o = _mma(o, h[..., s], w2[:, s, 0].T, terms)
    for j in range(4):
        s = _slots(j)
        o = _mma(o, a[..., s], ws[:, s, 0].T, terms)
    return np.ascontiguousarray(o.transpose(0, 2, 1))


@pytest.mark.parametrize("T", [1, 5, 4101])
def test_tf32x3_front_matches_jax(params, front_weights, T):
    """K1's arithmetic (3xTF32 products) against the JAX package's
    fused front (Pallas, interpret mode), within ATOL of an output whose
    scale is about 5: 3xTF32 keeps about 2^-21 of each product. Rows shorter
    than conv_in's pad against the XLA front, which the Pallas kernel does
    not take (it returns NaN there). One TF32 pass misses by about 2e-3."""
    x = (np.random.default_rng(T).standard_normal((2, T)) * 0.3).astype(np.float32)
    ref = (np.asarray(_xla_front(params, x)) if T < 7
           else np.asarray(seanet_front_fused(params, jnp.asarray(x), interpret=True)))
    np.testing.assert_allclose(front_emulated(x, front_weights), ref, atol=ATOL)
    if T > 7:
        assert np.abs(front_emulated(x, front_weights, terms=1) - ref).max() > 10 * ATOL


def test_tf32x3_codes_within_the_acoustic_contract(monkeypatch):
    """The port's encoder with K1's arithmetic patched in for its front, on
    the first second of each seed-0 case of tests/goldens/battery_acoustic.npz
    (the encoder is causal: a prefix's codes are the goldens' first 75
    frames), holds the acoustic contract on every case; one TF32 pass in
    its place agrees less."""
    import audiotoken_tpu_torch.nn.seanet as seanet_mod
    from audiotoken_tpu_torch import AcousticEncoder

    g = np.load(os.path.join(parity.GOLD, "battery_acoustic.npz"))
    audio, _lengths, names = battery(24_000)
    x = audio[:, :24_000]
    ref = g["ids_s0"][..., :75]
    enc = AcousticEncoder(weights="random", seed=0, device="cpu")
    agree = {}
    for terms in (3, 1):
        monkeypatch.setattr(seanet_mod, "seanet_front", lambda x, *w, terms=terms: torch.from_numpy(
            front_emulated(x.numpy(), w, terms)))
        agree[terms] = (enc(x) == ref).reshape(len(names), -1).mean(axis=1)
    bad = [f"{n}={a:.6f}" for n, a in zip(names, agree[3])
           if a < parity.case_thresh("acoustic", n)]
    assert not bad, bad
    assert agree[1].mean() < agree[3].mean(), (agree[1], agree[3])
