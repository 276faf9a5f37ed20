"""K3's plain version against the JAX package's fused RVQ kernel (Pallas,
interpret mode) and ``nn/rvq.py:rvq_encode``: codes must be equal. K3's
3xTF32 distances, emulated in numpy, against ``rvq_encode`` on the golden
battery's latents: within the acoustic contract."""

import os
import sys

import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.rvq import RVQConfig as JaxRVQConfig
from audiotoken_tpu.nn.rvq import rvq_encode as jax_rvq_encode
from audiotoken_tpu.ops.rvq_pallas import rvq_encode_pallas
from audiotoken_tpu_torch.nn.rvq import RVQConfig, ResidualVQ, init_codebooks
from audiotoken_tpu_torch.ops.rvq import rvq_encode, rvq_encode_plain, rvq_plan

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import verify_tpu_parity as parity  # noqa: E402
from golden_cases import battery  # noqa: E402
from torch_tf32 import tf32  # noqa: E402


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


# --- K3's precision: its 3xTF32 distances, emulated -------------------------


def _xe_tf32(r, e, terms):
    """r @ e.T as csrc/rvq.cu takes it on the tensor cores: both operands
    split into hi = tf32(x) and lo = tf32(x - hi); per k-step of 8 dims the
    terms lo_e hi_r, hi_e lo_r, hi_e hi_r (``terms`` 3) or hi_e hi_r alone
    (1), each one mma: its 8 products summed exactly and added to the f32
    accumulator with one rounding."""
    r_hi, e_hi = tf32(r), tf32(e)
    r_lo, e_lo = tf32(r - r_hi), tf32(e - e_hi)
    pairs = [(e_lo, r_hi), (e_hi, r_lo), (e_hi, r_hi)] if terms == 3 else [(e_hi, r_hi)]
    acc = np.zeros((r.shape[0], e.shape[0]), np.float32)
    for k0 in range(0, r.shape[1], 8):
        for a, b in pairs:
            term = b[:, k0:k0 + 8].astype(np.float64) @ a[:, k0:k0 + 8].T.astype(np.float64)
            acc = (acc.astype(np.float64) + term).astype(np.float32)
    return acc


def _rvq_emulated(codebooks, z, num_q, terms):
    """K3's cascade with :func:`_xe_tf32` distances: the f32 |r|^2 and |e|^2,
    nd = -(x2 - 2 xe + e2) in f32, the first index of the largest, and the
    exact f32 residual update."""
    r = z.reshape(-1, z.shape[-1]).astype(np.float32)
    codes = []
    for k in range(num_q):
        e = codebooks[k]
        x2 = (r * r).sum(-1, dtype=np.float32)[:, None]
        e2 = (e * e).sum(-1, dtype=np.float32)[None, :]
        nd = -((x2 - np.float32(2) * _xe_tf32(r, e, terms)) + e2)
        idx = np.argmax(nd, axis=-1)
        codes.append(idx)
        r = r - e[idx]
    return np.stack(codes).reshape(num_q, *z.shape[:-1]).transpose(1, 0, 2)


@pytest.fixture(scope="module")
def battery_latents():
    """The port's SEANet latents (CPU, full width) of the first second of
    each seed-0 case of tests/goldens/battery_acoustic.npz, its codebooks,
    and the JAX package's codes for them."""
    from audiotoken_tpu_torch import AcousticEncoder

    audio, _lengths, names = battery(24_000)
    enc = AcousticEncoder(weights="random", seed=0, device="cpu")
    with torch.inference_mode():
        z = enc.seanet(torch.from_numpy(audio[:, :24_000])).float().numpy()
    cb = enc.quantizer.codebooks.numpy()
    return names, cb, z, np.asarray(jax_rvq_encode(cb, z, 16))


def test_tf32x3_codes_within_the_acoustic_contract(battery_latents):
    """K3's 3xTF32 distances (emulated in numpy, term order and roundings as
    in csrc/rvq.cu) give codes that agree with the JAX package's
    ``rvq_encode`` within the acoustic contract on every seed-0 battery case;
    one TF32 pass alone agrees less."""
    names, cb, z, ref = battery_latents
    agree = {}
    for terms in (3, 1):
        codes = _rvq_emulated(cb, z, 16, terms)
        agree[terms] = (codes == ref).reshape(len(names), -1).mean(axis=1)
    bad = [f"{n}={a:.6f}" for n, a in zip(names, agree[3])
           if a < parity.case_thresh("acoustic", n)]
    assert not bad, bad
    assert agree[1].mean() < agree[3].mean(), (agree[1], agree[3])


@pytest.mark.parametrize("N", [1, 2250, 18000, 72000])
def test_plan_fills_the_card(N):
    """The codewords split over a cluster where the row tiles alone would
    leave SMs idle (one 30 s row: 36 tiles on 132 SMs), and not where the
    tiles fill the card several times (32 rows)."""
    split = rvq_plan(N, 132)
    assert split in (1, 2, 4)
    tiles = -(-N // 64)
    assert tiles * split >= min(tiles * 4, 132) or split == 4
    if N <= 2250:
        assert split == 4
    if N == 72000:
        assert split == 1
