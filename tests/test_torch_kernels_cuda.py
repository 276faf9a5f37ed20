"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. On a machine
with a card and without JAX, run them without the suite's conftest (which
imports JAX):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

``chip_smoke.py`` repeats these comparisons at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from audiotoken_tpu_torch.encoders import AcousticEncoder, Wav2VecBertEncoder
from audiotoken_tpu_torch.nn.rvq import RVQConfig, init_codebooks
from audiotoken_tpu_torch.nn.seanet import SeanetConfig, SeanetEncoder, init_encoder_params
from audiotoken_tpu_torch.ops import rvq as rvq_ops
from audiotoken_tpu_torch.ops.flash_attention import (
    flash_attention_relkey,
    flash_attention_relkey_plain,
)
from audiotoken_tpu_torch.ops.lstm import lstm_layer, lstm_layer_plain
from audiotoken_tpu_torch.ops.rvq import rvq_encode, rvq_encode_plain
from audiotoken_tpu_torch.ops.seanet_front import seanet_front, seanet_front_plain
from audiotoken_tpu_torch.runtime.precision import get_policy
from audiotoken_tpu_torch.weights import acoustic_from_numpy

pytestmark = pytest.mark.cuda

# Kernel and plain version sum in different orders, both in IEEE f32.
ATOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with get_policy("highest").numerics():
        yield torch.device("cuda")


def _front_weights(dev, seed=0):
    enc = SeanetEncoder()
    state, _ = acoustic_from_numpy(
        {"encoder": init_encoder_params(np.random.default_rng(seed), SeanetConfig()),
         "codebooks": np.zeros((1, 1, 128), np.float32)}
    )
    enc.load_state_dict(state)
    return [w.to(dev) for w in enc.front_weights()]


@pytest.mark.parametrize("T", [1, 5, 7, 255, 256, 257, 320, 4096 + 123, 30000, 30001])
@pytest.mark.parametrize("B", [1, 3, 33])
def test_seanet_front_matches_plain(dev, B, T):
    """Rows of every length class (one sample, shorter than the pads, around
    a 256-sample tile's edge, odd); the persistent kernel's work items are
    never a multiple of its grid here."""
    w = _front_weights(dev)
    x = torch.from_numpy(
        (np.random.default_rng(B * 100_003 + T).standard_normal((B, T)) * 0.3)
        .astype(np.float32)
    ).to(dev)
    before = seanet_front.launches
    out = seanet_front(x, *w)
    torch.cuda.synchronize()
    assert seanet_front.launches == before + 1
    ref = seanet_front_plain(x, *w)
    assert out.shape == ref.shape == (B, 32, T)
    assert torch.allclose(out, ref, atol=ATOL, rtol=0), (out - ref).abs().max().item()


def test_seanet_front_takes_unaligned_rows(dev):
    """A sub-batch of rows of odd length starts at any 4-byte offset."""
    w = _front_weights(dev)
    T = 30001
    flat = torch.from_numpy(
        (np.random.default_rng(2).standard_normal(3 * T) * 0.3).astype(np.float32)
    ).to(dev)
    x = flat.view(3, T)[1:]
    assert x.data_ptr() % 16 and x.is_contiguous()
    out = seanet_front(x, *w)
    torch.cuda.synchronize()
    ref = seanet_front_plain(x, *w)
    assert torch.allclose(out, ref, atol=ATOL, rtol=0), (out - ref).abs().max().item()


def test_seanet_front_elu_is_expm1f(dev):
    from audiotoken_tpu_torch.ops.seanet_front import elu_mismatches

    assert elu_mismatches(dev) == 0


def test_seanet_front_two_calls_bitwise_equal(dev):
    w = _front_weights(dev)
    x = torch.from_numpy(
        (np.random.default_rng(5).standard_normal((8, 240_001)) * 0.3).astype(np.float32)
    ).to(dev)
    assert torch.equal(seanet_front(x, *w), seanet_front(x, *w))


def _lstm_inputs(dev, B, T, H=512):
    rng = np.random.default_rng(B * 1000 + H)
    xi = torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(np.float32)).to(dev)
    s = 1.0 / np.sqrt(H)
    whh = torch.from_numpy(rng.uniform(-s, s, (4 * H, H)).astype(np.float32)).to(dev)
    return xi, whh


# 8 and 32 rows fill one launch's row groups; 33 takes a second launch; T=1
# is a single step with no grid barrier; T=2250 is a 30 s row
@pytest.mark.parametrize("B,T", [(1, 40), (3, 17), (9, 33), (8, 2250), (32, 300), (33, 50),
                                 (5, 1)])
def test_lstm_matches_plain(dev, B, T):
    xi, whh = _lstm_inputs(dev, B, T)
    before = lstm_layer.launches
    out = lstm_layer(xi, whh)
    torch.cuda.synchronize()
    assert lstm_layer.launches == before + -(-B // 32)  # one launch a group of 32 rows
    ref = lstm_layer_plain(xi, whh)
    assert torch.allclose(out, ref, atol=ATOL, rtol=0), (out - ref).abs().max().item()


def test_lstm_back_to_back_launches_agree(dev):
    """Two launches queued on one stream give the same bits: the ping-pong
    buffer and the grid barrier keep no state from one launch to the next."""
    xi, whh = _lstm_inputs(dev, 8, 400)
    a = lstm_layer(xi, whh)
    b = lstm_layer(xi, whh)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_lstm_refuses_other_sizes(dev):
    xi = torch.zeros((2, 5, 256), device=dev)
    with pytest.raises(ValueError, match="shape"):
        lstm_layer(xi, torch.zeros((256, 64), device=dev))


@pytest.mark.parametrize("num_q", [2, 16, 32])
def test_rvq_matches_plain(dev, num_q):
    cb = torch.from_numpy(init_codebooks(np.random.default_rng(0), RVQConfig())).to(dev)
    x = torch.from_numpy(
        np.random.default_rng(num_q).standard_normal((2, 301, 128)).astype(np.float32)
    ).to(dev)
    out = rvq_encode(cb, x, num_q)
    torch.cuda.synchronize()
    ref = rvq_encode_plain(cb, x, num_q)
    assert out.shape == ref.shape == (2, num_q, 301)
    assert (out == ref).float().mean().item() >= 0.999


def test_rvq_tie_takes_first_index(dev):
    rng = np.random.default_rng(3)
    cb = rng.standard_normal((2, 1024, 128)).astype(np.float32)
    cb[0, 700] = cb[0, 5]  # an exact tie; every row whose nearest is 5 ties with 700
    x = cb[0, [5, 700, 5]][None] + 0.01 * rng.standard_normal((1, 3, 128)).astype(np.float32)
    codes = rvq_encode(torch.from_numpy(cb).to(dev), torch.from_numpy(x).to(dev), 2)
    assert codes[0, 0].tolist() == [5, 5, 5]


# K3 against its plain version: chip_smoke.py's bound (late-codebook near-ties
# may flip: the kernel's products are 3xTF32, the plain version's IEEE f32)
RVQ_AGREEMENT = 0.999


@pytest.mark.parametrize("num_q", [2, 8, 16])
@pytest.mark.parametrize("N", [1, 2250, 18000, 72000])
def test_rvq_sizes_match_plain(dev, N, num_q):
    """From one 30 s row to 32: each size's plan (warps a block, a cluster
    split of the codewords where the row tiles are few). Codewords 600-699
    repeat 100-199 exactly: a later copy is never chosen."""
    rng = np.random.default_rng(N + num_q)
    cb = init_codebooks(rng, RVQConfig())
    cb[:, 600:700] = cb[:, 100:200]
    cb = torch.from_numpy(cb).to(dev)
    x = torch.from_numpy(rng.standard_normal((1, N, 128)).astype(np.float32) * 2).to(dev)
    before = rvq_encode.launches
    out = rvq_encode(cb, x, num_q)
    torch.cuda.synchronize()
    assert rvq_encode.launches == before + 1
    ref = rvq_encode_plain(cb, x, num_q)
    assert out.shape == ref.shape == (1, num_q, N)
    assert (out == ref).float().mean().item() >= RVQ_AGREEMENT
    assert not ((out >= 600) & (out < 700)).any()


def test_rvq_plans_agree(dev):
    """Every cluster split of the codewords computes each distance with the
    same products in the same order: the codes are the same bits whatever
    the split."""
    cb = torch.from_numpy(init_codebooks(np.random.default_rng(1), RVQConfig())).to(dev)
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((1, 2250, 128)).astype(np.float32)).to(dev)
    codes = [rvq_ops._launch(cb, x, 16, split) for split in rvq_ops.SPLITS]
    torch.cuda.synchronize()
    for c in codes[1:]:
        assert torch.equal(c, codes[0])


def test_encoder_runs_the_kernels(dev):
    counts = (seanet_front.launches, lstm_layer.launches, rvq_encode.launches)
    enc = AcousticEncoder(weights="random", seed=0, device=dev)
    x = (np.random.default_rng(1).standard_normal((2, 30000)) * 0.3).astype(np.float32)
    codes = enc(x)
    assert codes.shape == (2, 16, 94) and codes.dtype == np.int16
    assert seanet_front.launches > counts[0]
    assert lstm_layer.launches > counts[1]
    assert rvq_encode.launches > counts[2]
    ref = AcousticEncoder(weights="random", seed=0, device="cpu")(x)
    assert (codes == ref).mean() >= 0.99


def _attn_inputs(dev, B, H, T, seed=0):
    rng = np.random.default_rng(seed)

    def f(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    return f((B, H, T, 64), 0.3), f((B, H, T, 64), 0.3), f((B, H, T, 64), 1.0), f((73, 64), 0.05)


@pytest.mark.parametrize("has_mask", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("has_rel", [True, False], ids=["rel", "norel"])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 500, 600, 1499, 1500])
def test_flash_attention_matches_plain(dev, T, has_rel, has_mask):
    q, k, v, E = _attn_inputs(dev, 2, 3, T, seed=T)
    E = E if has_rel else None
    mask = None
    if has_mask:
        mask = torch.ones((2, T), device=dev)
        mask[1, T // 2 + 1:] = 0.0  # a padded row
    before = flash_attention_relkey.launches
    out = flash_attention_relkey(q, k, v, E, mask)
    torch.cuda.synchronize()
    assert flash_attention_relkey.launches == before + 1
    ref = flash_attention_relkey_plain(q, k, v, E, mask)
    assert out.shape == ref.shape == (2, 3, T, 64)
    assert torch.allclose(out, ref, atol=ATOL, rtol=0), (out - ref).abs().max().item()


def test_flash_attention_quantizer_training_shape(dev):
    """semantic_m's 10 s segments of quantizer training: T = 500, a tail
    query tile (500 is not a multiple of 128), rows cut short by the mask."""
    q, k, v, E = _attn_inputs(dev, 8, 16, 500, seed=500)
    mask = torch.ones((8, 500), device=dev)
    mask[3, 377:] = 0.0
    mask[6, 129:] = 0.0
    out = flash_attention_relkey(q, k, v, E, mask)
    torch.cuda.synchronize()
    ref = flash_attention_relkey_plain(q, k, v, E, mask)
    assert torch.allclose(out, ref, atol=ATOL, rtol=0), (out - ref).abs().max().item()


def test_semantic_m_features_run_the_kernel(dev):
    """``features`` (quantizer training's call) launches K4 once a block and
    gives the CPU path's features."""
    enc = Wav2VecBertEncoder(weights="random", seed=0, device=dev)
    x = (np.random.default_rng(3).standard_normal((2, 16_000)) * 0.2).astype(np.float32)
    before = flash_attention_relkey.launches
    feats, n = enc.features(x)
    assert flash_attention_relkey.launches - before == 19
    ref, n_ref = Wav2VecBertEncoder(weights="random", seed=0, device="cpu").features(x)
    assert n == n_ref and feats.shape == ref.shape
    assert torch.allclose(feats.cpu(), ref, atol=1e-3, rtol=1e-3)


def test_flash_attention_all_masked_row(dev):
    """A row whose keys are all masked: the same finite uniform average as
    the plain version."""
    q, k, v, E = _attn_inputs(dev, 2, 2, 200, seed=5)
    mask = torch.ones((2, 200), device=dev)
    mask[0] = 0.0
    out = flash_attention_relkey(q, k, v, E, mask)
    torch.cuda.synchronize()
    ref = flash_attention_relkey_plain(q, k, v, E, mask)
    assert torch.isfinite(out).all()
    assert torch.allclose(out, ref, atol=ATOL, rtol=0), (out - ref).abs().max().item()


@pytest.mark.parametrize("left,right", [(3, 0), (0, 5), (64, 8), (100, 100)])
def test_flash_attention_band_edges(dev, left, right):
    """Other band widths than the conformer's: key tiles wholly left and
    wholly right of a warp's band take the clamped ends of pos, the others
    gather; one batch row fully masked, the other cut short."""
    q, k, v, _ = _attn_inputs(dev, 2, 2, 300, seed=left + 7 * right)
    E = torch.from_numpy((np.random.default_rng(right).standard_normal(
        (left + right + 1, 64)) * 0.05).astype(np.float32)).to(dev)
    mask = torch.ones((2, 300), device=dev)
    mask[0] = 0.0
    mask[1, 211:] = 0.0
    out = flash_attention_relkey(q, k, v, E, mask, left=left, right=right)
    torch.cuda.synchronize()
    ref = flash_attention_relkey_plain(q, k, v, E, mask, left, right)
    assert torch.allclose(out, ref, atol=ATOL, rtol=0), (out - ref).abs().max().item()


def test_flash_attention_refuses(dev):
    q, k, v, E = _attn_inputs(dev, 1, 2, 16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_relkey(q.double(), k, v, E, None)
    with pytest.raises(ValueError, match="head size"):
        flash_attention_relkey(q[..., :32], k[..., :32], v[..., :32], None, None)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_relkey(q, k, v, E[:10], None)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_relkey(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), E, None)


def test_semantic_m_encoder_runs_the_kernel(dev):
    enc = Wav2VecBertEncoder(weights="random", seed=0, device=dev)
    x = (np.random.default_rng(2).standard_normal((2, 20_800)) * 0.2).astype(np.float32)
    before = flash_attention_relkey.launches
    ids = enc(x)
    assert flash_attention_relkey.launches - before == 19
    assert ids.shape == (2, 1, 64) and ids.dtype == np.int16
    ref = Wav2VecBertEncoder(weights="random", seed=0, device="cpu")(x)
    assert (ids == ref).mean() >= 0.99


# --- semantic decode: K5, K6, K7 --------------------------------------------

# bf16: kernel and plain version both compute in f32 and round at the same
# points (K5 and its plain version both round p to bf16 before the value
# product, the kernel against its running maximum; K6 rounds once; K7 at the
# same staging points), so they differ by a bf16 unit of the output's scale
# where a sum in another order crosses a rounding boundary.
BF16_SHARE = {"K5": 2**-7, "K6": 2**-7, "K7": 2**-6}
DECODE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _assert_kernel_close(out, ref, kernel, dt):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    diff = (out.float() - ref.float()).abs().max().item()
    bound = ATOL if dt == "f32" else BF16_SHARE[kernel] * ref.float().abs().max().item()
    assert diff <= bound, (kernel, dt, diff, bound)


def _randn(dev, shape, dtype, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dev).to(dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,T", [(1, 1024), (8, 1024), (32, 512), (2, 1), (2, 63), (2, 77),
                                 (2, 1000), (2, 1280), (2, 1500)])
def test_flash_attention_plain_matches_plain(dev, B, T, dt):
    """In f32 K5 is K4's 3xTF32 kernel with q pre-scaled: the launch counts
    as K5's, not K4's."""
    from audiotoken_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        noncausal_attention_plain,
    )

    dtype = DECODE_DTYPES[dt]
    q = _randn(dev, (B, 16, T, 64), dtype, 1, 0.125)
    k = _randn(dev, (B, 16, T, 64), dtype, 2)
    v = _randn(dev, (B, 16, T, 64), dtype, 3)
    before, before_k4 = flash_attention_plain.launches, flash_attention_relkey.launches
    out = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_plain.launches == before + 1
    assert flash_attention_relkey.launches == before_k4
    _assert_kernel_close(out, noncausal_attention_plain(q, k, v), "K5", dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_decode_attention_matches_plain(dev, B, dt):
    from audiotoken_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain

    dtype, nh, L, pos = DECODE_DTYPES[dt], 12, 1024, 1000
    rng = np.random.default_rng(B)
    kc = _randn(dev, (B, nh, L, 64), dtype, 5)
    vc = _randn(dev, (B, nh, L, 64), dtype, 6)
    qkv = _randn(dev, (B, 3 * nh * 64), dtype, 7)
    # q, k_new, v_new: strided rows of the qkv projection, q unscaled
    q, k_new, v_new = qkv[:, :nh * 64], qkv[:, nh * 64: 2 * nh * 64], qkv[:, 2 * nh * 64:]
    start = rng.integers(0, 600, B).astype(np.int32)
    start[0] = 0  # a prompt that fills its bucket
    if B > 1:
        start[1] = pos - 1  # one real token before pos
    if B > 2:
        start[2] = pos  # no valid slot: the self term alone
    start = torch.from_numpy(start).to(dev)
    k2, v2 = kc.clone(), vc.clone()
    before = decode_attention.launches
    out = decode_attention(q, k2, v2, start, pos, k_new, v_new)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q, kc, vc, start, pos, k_new, v_new)
    _assert_kernel_close(out, ref, "K6", dt)
    assert torch.equal(k2, kc) and torch.equal(v2, vc)  # both appended slot pos
    if B > 2:
        assert torch.equal(out[2], v_new[2])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 1, 63, 64, 65, 127, 1023, 2047])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_decode_attention_edges(dev, B, pos, dt):
    """K6's cluster split at the edges of its slot ranges (S = ceil(pos /
    64) blocks, at most 8), with L = 2048: rows that start at 0, at pos (no
    valid slot), past pos, and at random; in the chained launch of the
    decode step and alone. Two calls give the same bits, and the caches
    change at slot pos only."""
    from audiotoken_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain

    dtype, nh, L = DECODE_DTYPES[dt], 12, 2048
    kc = _randn(dev, (B, nh, L, 64), dtype, pos + 5)
    vc = _randn(dev, (B, nh, L, 64), dtype, pos + 6)
    qkv = _randn(dev, (B, 3 * nh * 64), dtype, pos + 7)
    q, k_new, v_new = qkv[:, :nh * 64], qkv[:, nh * 64: 2 * nh * 64], qkv[:, 2 * nh * 64:]
    start = np.random.default_rng(pos).integers(0, pos + 1, B).astype(np.int32)
    start[0] = 0
    if B > 1:
        start[1] = pos
    if B > 2:
        start[2] = pos + 5  # past pos: no valid slot either
    start = torch.from_numpy(start).to(dev)
    ref = decode_attention_plain(q, kc.clone(), vc.clone(), start, pos, k_new, v_new)
    outs = []
    for chained in (False, True, True):
        k2, v2 = kc.clone(), vc.clone()
        outs.append(decode_attention(q, k2, v2, start, pos, k_new, v_new, chained=chained))
        torch.cuda.synchronize()
        assert torch.equal(k2[:, :, pos], k_new.view(B, nh, 64))
        assert torch.equal(v2[:, :, pos], v_new.view(B, nh, 64))
        k2[:, :, pos], v2[:, :, pos] = kc[:, :, pos], vc[:, :, pos]
        assert torch.equal(k2, kc) and torch.equal(v2, vc)
    _assert_kernel_close(outs[0], ref, "K6", dt)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    assert torch.isfinite(outs[0].float()).all()
    if B > 1:
        assert torch.equal(outs[0][1], v_new[1])
    if B > 2:
        assert torch.equal(outs[0][2], v_new[2])


def test_decode_attention_chained_after_qkv(dev):
    """The decode step's chain, qkv -> K6 -> ffn, over consecutive slots:
    with programmatic dependent launch (K6 reading the cache while qkv
    runs, ffn streaming its weights during K6) the same bits as launched one
    after the other, caches included."""
    from audiotoken_tpu_torch.ops.decode_attention import decode_attention
    from audiotoken_tpu_torch.ops.decode_step import decode_ffn, decode_qkv

    dtype, B, C, nh, L = torch.bfloat16, 8, 768, 12, 256
    x = _randn(dev, (B, C), dtype, 1)
    lnw = 1 + _randn(dev, (C,), dtype, 2, 0.1)
    wq, wo = _randn(dev, (3 * C, C), dtype, 3, 0.02), _randn(dev, (C, C), dtype, 4, 0.02)
    wi, w2 = _randn(dev, (4 * C, C), dtype, 5, 0.02), _randn(dev, (C, 4 * C), dtype, 6, 0.02)
    kc, vc = _randn(dev, (B, nh, L, 64), dtype, 7), _randn(dev, (B, nh, L, 64), dtype, 8)
    start = torch.arange(B, dtype=torch.int32, device=dev) * 9
    runs = []
    for chained in (True, False):
        k2, v2, h = kc.clone(), vc.clone(), x
        for pos in range(100, 164):
            qkv = decode_qkv(h, lnw, None, wq)
            a = decode_attention(qkv[:, :C], k2, v2, start, pos, qkv[:, C:2 * C],
                                 qkv[:, 2 * C:], chained=chained)
            h = decode_ffn(h, a, wo, lnw, None, wi, w2)
        torch.cuda.synchronize()
        runs.append((h, k2, v2))
    assert torch.isfinite(runs[0][0].float()).all()
    for u, w in zip(*runs):
        assert torch.equal(u, w)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 31, 32, 33, 40, 64])
def test_decode_step_matches_plain(dev, B, dt, bias):
    from audiotoken_tpu_torch.ops.decode_step import (
        decode_ffn,
        decode_ffn_plain,
        decode_qkv,
        decode_qkv_plain,
    )

    dtype, C = DECODE_DTYPES[dt], 768

    def w(shape, seed, scale=0.02):
        return _randn(dev, shape, dtype, seed, scale)

    x, a = w((B, C), 10, 1.0), w((B, C), 11, 1.0)
    ln1w, ln2w = 1 + w((C,), 12, 0.1), 1 + w((C,), 13, 0.1)
    ln1b, ln2b = (w((C,), 14, 0.1), w((C,), 15, 0.1)) if bias else (None, None)
    wqkv, wo, wi, w2 = w((3 * C, C), 16), w((C, C), 17), w((4 * C, C), 18), w((C, 4 * C), 19)
    bq, bo, bi, b2 = ((w((3 * C,), 20), w((C,), 21), w((4 * C,), 22), w((C,), 23)) if bias
                      else (None,) * 4)
    before = (decode_qkv.launches, decode_ffn.launches)
    out = decode_qkv(x, ln1w, ln1b, wqkv, bq)
    y = decode_ffn(x, a, wo, ln2w, ln2b, wi, w2, bo, bi, b2)
    torch.cuda.synchronize()
    assert (decode_qkv.launches, decode_ffn.launches) == (before[0] + 1, before[1] + 1)
    _assert_kernel_close(out, decode_qkv_plain(x, ln1w, ln1b, wqkv, bq), "K7", dt)
    _assert_kernel_close(y, decode_ffn_plain(x, a, wo, ln2w, ln2b, wi, w2, bo, bi, b2), "K7", dt)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 33])
@pytest.mark.parametrize("tp", [2, 4])
def test_decode_ffn_tp_matches_plain(dev, tp, B, dt, bias):
    """K7's tp entry on rank 0's shard of a 768-wide layer, ``reduce``
    adding a fixed tensor for the other ranks' sums, against its plain
    version; it counts one launch a call."""
    from audiotoken_tpu_torch.ops.decode_step import decode_ffn_tp, decode_ffn_tp_plain

    dtype, C = DECODE_DTYPES[dt], 768
    K, H = C // tp, 4 * C // tp

    def w(shape, seed, scale=0.02):
        return _randn(dev, shape, dtype, seed, scale)

    x, a = w((B, C), 30, 1.0), w((B, K), 31, 1.0)
    lnw, lnb = 1 + w((C,), 32, 0.1), (w((C,), 33, 0.1) if bias else None)
    wo, wi, w2 = w((C, K), 34), w((H, C), 35), w((C, H), 36)
    bo, bi, b2 = (w((C,), 37), w((H,), 38), w((C,), 39)) if bias else (None,) * 3
    others = _randn(dev, (B, C), torch.float32, 40, 0.5)
    reduce = lambda s: s + others  # noqa: E731
    before = decode_ffn_tp.launches
    y = decode_ffn_tp(x, a, wo, lnw, lnb, wi, w2, reduce, bo, bi, b2)
    torch.cuda.synchronize()
    assert decode_ffn_tp.launches == before + 1
    _assert_kernel_close(y, decode_ffn_tp_plain(x, a, wo, lnw, lnb, wi, w2, reduce, bo, bi, b2),
                         "K7", dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B", [8, 40])
def test_decode_ffn_tp_on_one_rank_is_decode_ffn(dev, B, dt):
    """With whole weights and ``reduce`` the identity, K7's tp entry gives
    decode_ffn's bits: the same products, and the same roundings."""
    from audiotoken_tpu_torch.ops.decode_step import decode_ffn, decode_ffn_tp

    dtype, C = DECODE_DTYPES[dt], 768
    x, a = _randn(dev, (B, C), dtype, 1), _randn(dev, (B, C), dtype, 2)
    lnw, lnb = 1 + _randn(dev, (C,), dtype, 3, 0.1), _randn(dev, (C,), dtype, 4, 0.1)
    wo, wi, w2 = (_randn(dev, (C, C), dtype, 6, 0.02), _randn(dev, (4 * C, C), dtype, 7, 0.02),
                  _randn(dev, (C, 4 * C), dtype, 8, 0.02))
    bo, bi, b2 = (_randn(dev, (n,), dtype, 9 + i, 0.1) for i, n in enumerate((C, 4 * C, C)))
    assert torch.equal(decode_ffn_tp(x, a, wo, lnw, lnb, wi, w2, lambda s: s, bo, bi, b2),
                       decode_ffn(x, a, wo, lnw, lnb, wi, w2, bo, bi, b2))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("C,H,N", [(40, 40, 24), (776, 3080, 136), (1000, 8192, 7),
                                   (1024, 4096, 2312)])
def test_decode_step_odd_widths(dev, C, H, N, dt):
    """Widths that are not multiples of the k-splits or the column blocks,
    up to the bf16 kernel's limits (an LN width of 1024, 8192 otherwise)."""
    from audiotoken_tpu_torch.ops.decode_step import (
        decode_ffn,
        decode_ffn_plain,
        decode_qkv,
        decode_qkv_plain,
    )

    dtype = DECODE_DTYPES[dt]
    x, a = _randn(dev, (5, C), dtype, 1), _randn(dev, (5, C), dtype, 2)
    lnw, lnb = 1 + _randn(dev, (C,), dtype, 3, 0.1), _randn(dev, (C,), dtype, 4, 0.1)
    w = _randn(dev, (N, C), dtype, 5, 0.02)
    wo, wi, w2 = (_randn(dev, (C, C), dtype, 6, 0.02), _randn(dev, (H, C), dtype, 7, 0.02),
                  _randn(dev, (C, H), dtype, 8, 0.02))
    _assert_kernel_close(decode_qkv(x, lnw, lnb, w), decode_qkv_plain(x, lnw, lnb, w), "K7", dt)
    _assert_kernel_close(decode_ffn(x, a, wo, lnw, lnb, wi, w2),
                         decode_ffn_plain(x, a, wo, lnw, lnb, wi, w2), "K7", dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_step_back_to_back_launches_agree(dev, dt):
    """Two calls queued on one stream give the same bits: the k-splits are
    summed in a fixed order, so a sampled decode is deterministic per seed."""
    from audiotoken_tpu_torch.ops.decode_step import decode_ffn, decode_qkv

    dtype, C = DECODE_DTYPES[dt], 768
    x, a = _randn(dev, (8, C), dtype, 1), _randn(dev, (8, C), dtype, 2)
    lnw = 1 + _randn(dev, (C,), dtype, 3, 0.1)
    wq, wo = _randn(dev, (3 * C, C), dtype, 4, 0.02), _randn(dev, (C, C), dtype, 5, 0.02)
    wi, w2 = _randn(dev, (4 * C, C), dtype, 6, 0.02), _randn(dev, (C, 4 * C), dtype, 7, 0.02)
    runs = [(decode_qkv(x, lnw, None, wq), decode_ffn(x, a, wo, lnw, None, wi, w2))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_decode_kernels_refuse(dev):
    from audiotoken_tpu_torch.ops.decode_attention import decode_attention
    from audiotoken_tpu_torch.ops.decode_step import decode_qkv
    from audiotoken_tpu_torch.ops.flash_attention import flash_attention_plain

    q = torch.zeros((1, 2, 8, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_plain(q, q, q)
    cache = torch.zeros((1, 2, 4, 64), device=dev)
    row = torch.zeros((1, 128), device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="outside the cache"):
        decode_attention(row, cache, cache, start, 4, row, row)
    with pytest.raises(ValueError, match="share a stride"):
        decode_attention(torch.zeros((1, 256), device=dev)[:, :128], cache, cache, start, 2,
                         row, row)
    with pytest.raises(ValueError, match="not a multiple of 8"):
        x = torch.zeros((1, 12), device=dev)
        decode_qkv(x, x[0], None, torch.zeros((36, 12), device=dev))
    with pytest.raises(ValueError, match="the bf16 kernel takes"):
        x = torch.zeros((1, 1032), device=dev, dtype=torch.bfloat16)
        decode_qkv(x, x[0], None, torch.zeros((16, 1032), device=dev, dtype=torch.bfloat16))


def test_semantic_decode_runs_the_kernels(dev):
    """A tiny-depth GPT decode and Bark-fine window on the card launch K6,
    K7 and K5 and agree with the CPU path (greedy, f32)."""
    from audiotoken_tpu_torch.nn.bark_fine import BarkFine, BarkFineConfig, BarkFineGenerator
    from audiotoken_tpu_torch.nn.bark_fine import init_bark_fine_params
    from audiotoken_tpu_torch.nn.gpt import GPT, GPTConfig, GPTSampler, init_gpt_params
    from audiotoken_tpu_torch.ops.decode_attention import decode_attention
    from audiotoken_tpu_torch.ops.decode_step import decode_ffn, decode_qkv
    from audiotoken_tpu_torch.ops.flash_attention import flash_attention_plain
    from audiotoken_tpu_torch.weights import bark_fine_from_numpy, gpt_from_numpy

    gcfg = GPTConfig(n_layer=2, block_size=256, vocab_size=512)
    gstate = gpt_from_numpy(init_gpt_params(np.random.default_rng(0), gcfg))
    prompts = [np.arange(5, 40), np.arange(7, 9)]
    outs = []
    for d in (dev, torch.device("cpu")):
        m = GPT(gcfg)
        m.load_state_dict(gstate)
        before = (decode_attention.launches, decode_qkv.launches, decode_ffn.launches)
        outs.append(GPTSampler(m.to(d)).generate_batch(prompts, max_new_tokens=20, top_k=1))
        if d.type == "cuda":
            n = (decode_attention.launches - before[0], decode_qkv.launches - before[1],
                 decode_ffn.launches - before[2])
            assert n == (2 * 19,) * 3, n
    assert (outs[0] == outs[1]).mean() >= 0.9

    bcfg = BarkFineConfig(n_layer=2, block_size=128, max_history=64)
    bstate = bark_fine_from_numpy(init_bark_fine_params(np.random.default_rng(1), bcfg))
    coarse = np.random.default_rng(2).integers(0, 1024, (2, 2, 150))
    fines = []
    for d in (dev, torch.device("cpu")):
        m = BarkFine(bcfg)
        m.load_state_dict(bstate)
        before = flash_attention_plain.launches
        fines.append(BarkFineGenerator(m.to(d)).generate_fine_batch(coarse, temperature=None))
        if d.type == "cuda":
            assert flash_attention_plain.launches - before == 2 * 2 * 6  # layers x windows x cbs
    assert (fines[0] == fines[1]).mean() >= 0.99


# --- K8 (attention ablations) and semantic_s --------------------------------

# K8 against its twin, relative to the output's scale (noexp's outputs are
# about 1e30): f32 sums in another order; in bf16 a score summed in another
# order can round p to the neighbouring bf16 value.
K8_SHARE = {"f32": 2e-5, "bf16": 2**-6}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("T", [256, 1024])
@pytest.mark.parametrize("case", ["noexp64", "noexp128", "dotsonly64", "dotsonly128",
                                  "onepass16", "onepass32", "full64"])
def test_attn_ablation_matches_plain(dev, case, T, dt):
    from audiotoken_tpu_torch.ops.attn_ablation import attn_ablation, attn_ablation_plain

    mode = case.rstrip("0123456789")
    tile = int(case[len(mode):])
    dtype = DECODE_DTYPES[dt]
    q = _randn(dev, (2, 3, T, 64), dtype, 1, 0.3 * 0.125)
    k, v = _randn(dev, (2, 3, T, 64), dtype, 2, 0.3), _randn(dev, (2, 3, T, 64), dtype, 3, 0.3)
    before = attn_ablation.launches[case]
    out = attn_ablation(q, k, v, mode, tile)
    torch.cuda.synchronize()
    assert attn_ablation.launches[case] == before + 1
    ref = attn_ablation_plain(q, k, v, mode, tile)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    diff = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert diff <= K8_SHARE[dt] * scale, (case, dt, diff, scale)


def test_attn_ablation_refuses(dev):
    from audiotoken_tpu_torch.ops.attn_ablation import attn_ablation

    q = torch.zeros((1, 2, 192, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of the tile"):
        attn_ablation(q, q, q, "noexp", 128)
    q = torch.zeros((1, 2, 1088, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 1024"):
        attn_ablation(q, q, q, "onepass", 16)
    with pytest.raises(ValueError, match="dtype"):
        attn_ablation(q.half(), q.half(), q.half(), "noexp", 64)


def test_micro_profile_runs(dev):
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    from profile_attn_micro_torch import cases, micro_profile

    from audiotoken_tpu_torch.ops.attn_ablation import CASES, attn_ablation

    attn_ablation.launches.clear()
    times = micro_profile(batch=1, heads=2, seq=256, layers=3)
    assert list(times) == [name for name, _ in cases()]
    assert all(t > 0 for t in times.values())
    assert dict(attn_ablation.launches) == {c: 5 for c in CASES}  # 2 warm-up + 3


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_semantic_s_encoder_on_the_card(dev, attn_impl):
    from audiotoken_tpu_torch.encoders import HubertEncoder

    x = HubertEncoder.host_transform(
        (np.random.default_rng(4).standard_normal((2, 20_800)) * 0.2).astype(np.float32))
    lengths = np.array([20_800, 15_000], np.int32)
    enc = HubertEncoder(weights="random", seed=0, device=dev, attn_impl=attn_impl)
    before = flash_attention_relkey.launches
    ids = enc(x, lengths)
    assert flash_attention_relkey.launches - before == (11 if attn_impl == "flash" else 0)
    assert ids.shape == (2, 1, 64) and ids.dtype == np.int16
    ref = HubertEncoder(weights="random", seed=0, device="cpu", attn_impl=attn_impl)(x, lengths)
    assert (ids == ref).mean() >= 0.99


def test_corpus_on_the_card(dev, tmp_path):
    """encode_batch_files on the card: PCM16 and resampled stereo files of
    several 1 s segments, tokens equal to the same device's
    ``encode(path, chunk_size)``, and K1-K3 launched by the corpus run."""
    from audiotoken_tpu_torch import AudioToken, Tokenizers
    from audiotoken_tpu_torch.io.wavfile import write_wav

    rng = np.random.default_rng(6)
    for i, (sr, ch, seconds) in enumerate([(24_000, 1, 2.3), (24_000, 1, 0.9),
                                           (44_100, 2, 1.6), (24_000, 1, 3.4)]):
        x = (0.25 * rng.standard_normal((ch, int(sr * seconds)))).clip(-1, 1)
        write_wav(str(tmp_path / f"c{i}.wav"), (x * 32767).astype(np.int16), sr)
    at = AudioToken(Tokenizers.acoustic, weights="random", device=dev)
    kernels = (seanet_front, lstm_layer, rvq_encode)
    before = [k.launches for k in kernels]
    summary = at.encode_batch_files(batch_size=3, outdir=tmp_path / "out", chunk_size=1.0,
                                    num_workers=2, audio_dir=tmp_path)
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert summary["batches"] == 4 and summary["stages"]["d2h_fetch"]["clock"] == "device"
    for i in range(4):
        np.testing.assert_array_equal(np.load(tmp_path / "out" / f"c{i}.npy"),
                                      at.encode(str(tmp_path / f"c{i}.wav"), chunk_size=1.0)[0])
    assert at.encode_batch_files(batch_size=3, outdir=tmp_path / "out", chunk_size=1.0,
                                 audio_dir=tmp_path)["batches"] == 0


@pytest.mark.parametrize("check", ["check_train_step", "check_dp_encode",
                                   "check_attention_shard", "check_tp_sampler"])
def test_mesh_checks_on_the_cards(dev, check):
    """The four multi-device checks (``parallel/dryrun.py``) with a rank on
    every card over NCCL, or two ranks sharing a single card over gloo:
    K4 at heads 64 wide, K6 and K7 on the tp sampler's heads."""
    from audiotoken_tpu_torch.ops import _build
    from audiotoken_tpu_torch.parallel.launch import run_world

    _build.library()  # built before any rank starts
    cards = torch.cuda.device_count()
    world, backend = (cards, "nccl") if cards > 1 else (2, "gloo")
    outs = run_world(f"audiotoken_tpu_torch.parallel.dryrun:{check}", world, ("cuda",),
                     backend=backend, timeout=600)
    assert len(outs) == world


def test_mesh_train_step_at_every_shape_on_the_cards(dev):
    """Check 1 (``parallel/dryrun.py:check_train_step``) with every rank on
    "dp", and at dp x 2 where the world allows (``train_shapes``): the dp
    ranks' loss over the global count of valid targets and the gradient
    all-reduce, over NCCL with a rank on every card, or two ranks sharing
    a single card over gloo."""
    from audiotoken_tpu_torch.ops import _build
    from audiotoken_tpu_torch.parallel.dryrun import train_shapes
    from audiotoken_tpu_torch.parallel.launch import run_world

    _build.library()  # built before any rank starts
    cards = torch.cuda.device_count()
    world, backend = (cards, "nccl") if cards > 1 else (2, "gloo")
    for shape in train_shapes(world)[1:]:
        outs = run_world("audiotoken_tpu_torch.parallel.dryrun:check_train_step", world,
                         ("cuda", shape), backend=backend, timeout=600)
        assert [tuple(o["mesh"].values()) for o in outs] == [shape] * world
