"""The plain versions of K5, K6 and K7 against the JAX package's Pallas
kernels (interpret mode) on the CPU.

Tolerances: f32 differs only by the order of sums (2e-5 for K5 as in the
JAX flash test, 1e-5 for the small K6/K7 products). In bf16 K5's plain
version rounds the softmax weights to bf16 before the value product, as
both Pallas bodies do, so against the one-pass kernel (T <= 1024) only
the order of f32 sums differs and now and then flips an output to the
neighbouring bf16 value: measured 2^-11 of the largest output, bound
2^-10 (the version that kept p in f32 was 2^-8 away). Against the tiled
kernel (T > 1024) p is rounded relative to the running maximum of the key
tiles seen so far, so the roundings fall elsewhere: measured 2^-8, bound
2^-7. Elsewhere a bf16 result may differ by a few bf16 units of its own
scale where the Pallas kernels round p (K6) or use a rational erf (K7):
2^-6 of the largest output for K6, 2^-5 for K7, whose GELU input rounds
twice.
The CUDA kernels are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotoken_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from audiotoken_tpu.ops.decode_attention import decode_attention_fused as jax_decode_fused
from audiotoken_tpu.ops.decode_step_fused import decode_ffn as jax_decode_ffn
from audiotoken_tpu.ops.decode_step_fused import decode_qkv as jax_decode_qkv
from audiotoken_tpu.ops.flash_attention import _flash_attention_plain as jax_flash_plain
from audiotoken_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from audiotoken_tpu_torch.ops.decode_step import (
    decode_ffn,
    decode_ffn_plain,
    decode_ffn_tp,
    decode_ffn_tp_plain,
    decode_qkv,
    decode_qkv_plain,
)
from audiotoken_tpu_torch.ops.flash_attention import flash_attention_plain, noncausal_attention_plain

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _to_jax(t: torch.Tensor, jdt):
    return jnp.asarray(t.float().numpy()).astype(jdt)


def _close(out: torch.Tensor, ref, name: str, atol_f32: float, bf16_share: float):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    atol = atol_f32 if bf16_share is None else bf16_share * float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol, err_msg=name)


# --- K5 ---------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k5_plain_matches_pallas(dt):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 256, 64)).astype(np.float32)).to(tdt)
               for _ in range(3))
    out = noncausal_attention_plain((q * 0.125).to(tdt), k, v)  # the port takes q pre-scaled
    assert out.dtype == tdt and out.shape == (2, 4, 256, 64)
    ref = jax_flash_plain(_to_jax(q, jdt), _to_jax(k, jdt), _to_jax(v, jdt), interpret=True)
    _close(out, ref, "K5", 2e-5, None if dt == "f32" else 2**-10)


def test_k5_plain_matches_tiled_pallas_bf16():
    """T = 1280 > 1024: the JAX function takes its tiled online-softmax
    kernel (``_kernel_plain``, key tiles of 256)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 1280, 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    out = noncausal_attention_plain((q * 0.125).to(torch.bfloat16), k, v)
    ref = jax_flash_plain(*(_to_jax(t, jnp.bfloat16) for t in (q, k, v)), tile=256,
                          interpret=True)
    _close(out, ref, "K5 tiled", None, 2**-7)


def test_k5_cpu_wrapper_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 70, 64)).astype(np.float32))
               for _ in range(3))
    before = flash_attention_plain.launches
    out = flash_attention_plain(q, k, v)
    assert flash_attention_plain.launches == before
    assert torch.equal(out, noncausal_attention_plain(q, k, v))


# --- K6 ---------------------------------------------------------------------

B6, NH, DH, L6, POS = 4, 3, 64, 40, 33


def _k6_inputs(tdt):
    """q, k_new and v_new as column slices of one qkv row (q unscaled, as
    the decode step passes them), the caches and the rows' starts."""
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdt)

    qkv = t(B6, 3 * NH * DH)
    q, k_new, v_new = qkv[:, :NH * DH], qkv[:, NH * DH: 2 * NH * DH], qkv[:, 2 * NH * DH:]
    k_cache, v_cache = t(B6, NH, L6, DH), t(B6, NH, L6, DH)
    # a prompt that fills its bucket, a ragged start, one real token, none
    start = torch.tensor([0, 9, POS - 1, POS], dtype=torch.int32)
    return q, k_cache, v_cache, start, k_new, v_new


def _scaled(q):
    """The JAX package's q: [B, nh, dh], times dh^-0.5 before its kernel."""
    return (q * DH**-0.5).to(q.dtype).reshape(q.shape[0], NH, DH)


def _jax_layout(k_cache, v_cache, start, jdt):
    kj = _to_jax(k_cache.permute(0, 1, 3, 2).reshape(B6, NH * DH, L6), jdt)
    vj = _to_jax(v_cache.permute(0, 2, 1, 3).reshape(B6, L6, NH * DH), jdt)
    slots = np.arange(L6)[None, :]
    s = start.numpy()[:, None]
    valid = jnp.asarray(((slots >= s) & (slots < POS)).astype(np.float32))
    return kj, vj, valid


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k6_plain_matches_fused_pallas(dt):
    tdt, jdt = DTYPES[dt]
    q, k_cache, v_cache, start, k_new, v_new = _k6_inputs(tdt)
    kj, vj, valid = _jax_layout(k_cache, v_cache, start, jdt)
    ref = jax_decode_fused(_to_jax(_scaled(q), jdt), kj, vj, valid, _to_jax(k_new, jdt),
                           _to_jax(v_new, jdt), interpret=True)
    out = decode_attention_plain(q, k_cache, v_cache, start, POS, k_new, v_new)
    assert out.dtype == tdt
    _close(out, ref, "K6 fused", 1e-5, None if dt == "f32" else 2**-6)
    # the row with no valid slot attends to itself alone
    torch.testing.assert_close(out[3].float(), v_new[3].float(), rtol=0, atol=0)


def test_k6_plain_matches_partials_after_combine():
    """The partials form plus the caller's self-term combine
    (nn/gpt.py's "kernel" decode path) is the same function, in f32."""
    q, k_cache, v_cache, start, k_new, v_new = _k6_inputs(torch.float32)
    kj, vj, valid = _jax_layout(k_cache, v_cache, start, jnp.float32)
    qn = _scaled(q).numpy()
    acc, m, l = jax_decode_attention(jnp.asarray(qn), kj, vj, valid, interpret=True)
    kn, vn = k_new.numpy().reshape(B6, NH, DH), v_new.numpy().reshape(B6, NH, DH)
    s1 = (qn * kn).sum(-1, keepdims=True)
    mx = np.maximum(np.asarray(m), s1)
    alpha, w = np.exp(np.asarray(m) - mx), np.exp(s1 - mx)
    ref = (np.asarray(acc) * alpha + w * vn) / (np.asarray(l) * alpha + w)
    out = decode_attention_plain(q, k_cache, v_cache, start, POS, k_new, v_new)
    np.testing.assert_allclose(out.numpy(), ref.reshape(B6, NH * DH), rtol=0, atol=1e-5)


def test_k6_appends_the_token_and_reads_only_older_slots():
    q, k_cache, v_cache, start, k_new, v_new = _k6_inputs(torch.float32)
    k2, v2 = k_cache.clone(), v_cache.clone()
    k2[:, :, POS + 1:] = float("nan")  # slots past pos are never read
    out = decode_attention(q, k2, v2, start, POS, k_new, v_new)  # CPU: the plain version
    ref = decode_attention_plain(q, k_cache.clone(), v_cache.clone(), start, POS, k_new, v_new)
    assert torch.equal(out, ref)
    assert torch.equal(k2[:, :, POS], k_new.view(B6, NH, DH))
    assert torch.equal(v2[:, :, POS], v_new.view(B6, NH, DH))
    assert torch.equal(k2[:, :, :POS], k_cache[:, :, :POS])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k6_unscaled_q_gives_the_prescaled_bits(dt):
    """K6 takes q unscaled from the qkv row and scales it by 0.125 in f32
    after loading; the decode step used to scale it first, in the cache
    dtype. 0.125 is a power of two, so both give the same bits."""
    tdt, _ = DTYPES[dt]
    q, k_cache, v_cache, start, k_new, v_new = _k6_inputs(tdt)
    out = decode_attention_plain(q, k_cache.clone(), v_cache.clone(), start, POS, k_new, v_new)
    # the former function: q pre-scaled in the cache dtype, read as f32
    qf = _scaled(q).float()[:, :, None, :]
    kn, vn = k_new.reshape(B6, NH, 1, DH).float(), v_new.reshape(B6, NH, 1, DH).float()
    s = torch.matmul(qf, k_cache[:, :, :POS].float().transpose(-1, -2))
    valid = torch.arange(POS)[None, :] >= start.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(torch.cat([s, (qf * kn).sum(-1, keepdim=True)], dim=-1), dim=-1)
    ref = torch.matmul(p[..., :POS], v_cache[:, :, :POS].float()) + p[..., POS:] * vn
    assert torch.equal((q.float() * 0.125).reshape(B6, NH, DH), qf[:, :, 0])
    assert torch.equal(out, ref.reshape(B6, NH * DH).to(tdt))


# K6's combine, transcribed: csrc/decode_attention.cu splits one (b, h)'s
# slots [0, pos) over a cluster of S blocks, block r taking [r c, (r + 1) c)
# with c = ceil(pos / S), clipped to [start, pos); a block reads its range
# in tiles of 64 slots, warp w scoring slots w*16 .. w*16 + 15 of a tile
# with an online softmax; the warps' partials, then the blocks', are
# combined in order, a partial with no valid slot (m = -inf) weighing 0.
K6_TILE, K6_WARPS = 64, 4


def _weight(m, mx):
    return np.float32(0.0) if m == -np.inf else np.exp(np.float32(m - mx))


def _k6_transcribed(qs, kc, vc, st, pos, kn, vn, S):
    """One (b, h): qs [64] (scaled), kc, vc [L, 64], kn, vn [64], all f32."""
    chunk = -(-pos // S) if pos else 0
    st = min(max(st, 0), pos)
    parts = []
    for r in range(S):
        lo, hi = max(r * chunk, st), min((r + 1) * chunk, pos)
        n = max(hi - lo, 0)
        warps = [(-np.inf, np.float32(0), np.zeros(DH, np.float32)) for _ in range(K6_WARPS)]
        for t0 in range(0, n, K6_TILE):
            slots = min(K6_TILE, n - t0)
            for w in range(K6_WARPS):
                m, l, acc = warps[w]
                j = np.arange(w * 16, w * 16 + 16)
                j = j[j < slots]
                sc = kc[lo + t0 + j] @ qs
                mn = max(m, sc.max()) if j.size else m
                if mn == -np.inf:
                    continue
                alpha = np.exp(np.float32(m - mn)) if m != -np.inf else np.float32(0)
                p = np.exp(sc - mn)
                warps[w] = (mn, l * alpha + p.sum(), acc * alpha + p @ vc[lo + t0 + j])
        mx = max(m for m, _, _ in warps)
        cs = [_weight(m, mx) for m, _, _ in warps]
        parts.append((mx, sum(c * l for c, (_, l, _) in zip(cs, warps)),
                      sum(c * a for c, (_, _, a) in zip(cs, warps))))
    ss = np.float32(qs @ kn)
    mx = max([ss] + [m for m, _, _ in parts])
    cs = [_weight(m, mx) for m, _, _ in parts]
    w = np.exp(np.float32(ss - mx))
    num = sum(c * a for c, (_, _, a) in zip(cs, parts)) + w * vn
    den = sum(c * l for c, (_, l, _) in zip(cs, parts)) + w
    return num / den


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("pos", [0, 1, 63, 64, 65, 127, 1023])
def test_k6_cluster_combine_matches_plain(pos, S):
    """The transcription against decode_attention_plain (f32): rows that
    start at 0, at pos (no valid slot), past pos, one slot before pos (every
    block but the last empty) and in the middle (the first blocks empty)."""
    L, B, nh = 1024, 5, 2
    rng = np.random.default_rng(pos * 8 + S)
    kc = rng.standard_normal((B, nh, L, DH)).astype(np.float32)
    vc = rng.standard_normal((B, nh, L, DH)).astype(np.float32)
    qkv = rng.standard_normal((B, 3 * nh * DH)).astype(np.float32)
    start = np.array([0, pos, pos + 7, pos - 1, pos // 2], np.int32)
    t = torch.from_numpy
    q, kn, vn = (t(qkv[:, i * nh * DH:(i + 1) * nh * DH]) for i in range(3))
    ref = decode_attention_plain(q, t(kc.copy()), t(vc.copy()), t(start), pos, kn, vn).numpy()
    with np.errstate(invalid="raise", over="raise"):
        for b in range(B):
            for h in range(nh):
                cols = slice(h * DH, (h + 1) * DH)
                qs = q.numpy()[b, cols] * np.float32(0.125)
                out = _k6_transcribed(qs, kc[b, h], vc[b, h], int(start[b]), pos,
                                      kn.numpy()[b, cols], vn.numpy()[b, cols], S)
                assert np.isfinite(out).all()
                np.testing.assert_allclose(out, ref[b, cols], rtol=0, atol=2e-6)
    np.testing.assert_array_equal(ref[1], vn.numpy()[1])  # no valid slot: v_new
    np.testing.assert_array_equal(ref[2], vn.numpy()[2])


# --- K7 ---------------------------------------------------------------------

B7, C7 = 3, 64


def _k7_weights(tdt, bias: bool, seed=8):
    """(weights in torch layout, x, a) for a C7-wide decode step."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(tdt)

    def b(n):
        return t(n) if bias else None

    w = {"ln1_w": 1 + t(C7), "ln1_b": b(C7), "w_qkv": t(3 * C7, C7), "b_qkv": b(3 * C7),
         "w_out": t(C7, C7), "b_out": b(C7), "ln2_w": 1 + t(C7), "ln2_b": b(C7),
         "w_in": t(4 * C7, C7), "b_in": b(4 * C7), "w_out2": t(C7, 4 * C7), "b_out2": b(C7)}
    return w, t(B7, C7, scale=1.0), t(B7, C7, scale=1.0)


def _j(t, jdt, transpose=False):
    if t is None:
        return None
    return _to_jax(t.t() if transpose else t, jdt)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k7_qkv_plain_matches_pallas(dt, bias):
    tdt, jdt = DTYPES[dt]
    w, x, _ = _k7_weights(tdt, bias)
    out = decode_qkv_plain(x, w["ln1_w"], w["ln1_b"], w["w_qkv"], w["b_qkv"])
    ref = jax_decode_qkv(_j(x, jdt), _j(w["ln1_w"], jdt), _j(w["ln1_b"], jdt),
                         _j(w["w_qkv"], jdt, True), _j(w["b_qkv"], jdt), interpret=True)
    assert out.dtype == tdt
    _close(out, ref, "decode_qkv", 1e-5, None if dt == "f32" else 2**-5)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k7_ffn_plain_matches_pallas(dt, bias):
    tdt, jdt = DTYPES[dt]
    w, x, a = _k7_weights(tdt, bias)
    out = decode_ffn_plain(x, a, w["w_out"], w["ln2_w"], w["ln2_b"], w["w_in"], w["w_out2"],
                           w["b_out"], w["b_in"], w["b_out2"])
    ref = jax_decode_ffn(_j(x, jdt), _j(a, jdt), _j(w["w_out"], jdt, True), _j(w["ln2_w"], jdt),
                         _j(w["ln2_b"], jdt), _j(w["w_in"], jdt, True),
                         _j(w["w_out2"], jdt, True), _j(w["b_out"], jdt), _j(w["b_in"], jdt),
                         _j(w["b_out2"], jdt), interpret=True)
    assert out.dtype == tdt
    _close(out, ref, "decode_ffn", 1e-5, None if dt == "f32" else 2**-5)


def _ffn_args(w):
    return w["w_out"], w["ln2_w"], w["ln2_b"], w["w_in"], w["w_out2"]


def _ffn_biases(w):
    return w["b_out"], w["b_in"], w["b_out2"]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k7_ffn_tp_plain_on_one_rank_is_decode_ffn(dt, bias):
    """With whole weights and ``reduce`` the identity, the tp entry's plain
    version is decode_ffn's, bit for bit."""
    w, x, a = _k7_weights(DTYPES[dt][0], bias)
    out = decode_ffn_tp_plain(x, a, *_ffn_args(w), lambda s: s, *_ffn_biases(w))
    assert torch.equal(out, decode_ffn_plain(x, a, *_ffn_args(w), *_ffn_biases(w)))


def _ffn_shard(w, a, r, n):
    """Rank r of n's decode_ffn_tp operands: its columns of a and of w_out's
    input, its block of w_in (and b_in) and the matching columns of w_out2."""
    c, h = slice(r * C7 // n, (r + 1) * C7 // n), slice(r * 4 * C7 // n, (r + 1) * 4 * C7 // n)
    b_in = None if w["b_in"] is None else w["b_in"][h]
    return (a[:, c], w["w_out"][:, c], w["ln2_w"], w["ln2_b"], w["w_in"][h], w["w_out2"][:, h],
            w["b_out"], b_in, w["b_out2"])


def _ranks_in_threads(n, body):
    """``body(rank, reduce)`` on n threads, ``reduce`` summing the ranks'
    f32 tensors in rank order, as an all-reduce -> the n results."""
    parts, barrier, out = {}, threading.Barrier(n, timeout=60), [None] * n

    def run(r):
        calls = iter(range(1 << 30))

        def reduce(s):
            key = next(calls)
            parts[key, r] = s
            barrier.wait()
            total = parts[key, 0]
            for i in range(1, n):
                total = total + parts[key, i]
            barrier.wait()
            return total

        out[r] = body(r, reduce)

    threads = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return out


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k7_ffn_tp_plain_on_two_ranks_matches_pallas(dt, bias):
    """Each of two ranks' decode_ffn_tp on its shard, the sums all-reduced
    between, against JAX's whole decode_ffn (Pallas, interpret mode); the
    ranks agree bit for bit."""
    tdt, jdt = DTYPES[dt]
    w, x, a = _k7_weights(tdt, bias)

    def rank(r, reduce):
        shard = _ffn_shard(w, a, r, 2)
        return decode_ffn_tp(x, *shard[:6], reduce, *shard[6:])

    outs = _ranks_in_threads(2, rank)
    assert torch.equal(outs[0], outs[1]) and outs[0].dtype == tdt
    ref = jax_decode_ffn(_j(x, jdt), _j(a, jdt), _j(w["w_out"], jdt, True), _j(w["ln2_w"], jdt),
                         _j(w["ln2_b"], jdt), _j(w["w_in"], jdt, True),
                         _j(w["w_out2"], jdt, True), _j(w["b_out"], jdt), _j(w["b_in"], jdt),
                         _j(w["b_out2"], jdt), interpret=True)
    _close(outs[0], ref, "decode_ffn_tp", 1e-5, None if dt == "f32" else 2**-5)


def test_k7_cpu_wrappers_run_plain_and_count_no_launch():
    w, x, a = _k7_weights(torch.float32, True)
    before = (decode_qkv.launches, decode_ffn.launches, decode_ffn_tp.launches)
    qkv = decode_qkv(x, w["ln1_w"], w["ln1_b"], w["w_qkv"], w["b_qkv"])
    y = decode_ffn(x, a, w["w_out"], w["ln2_w"], w["ln2_b"], w["w_in"], w["w_out2"],
                   w["b_out"], w["b_in"], w["b_out2"])
    y_tp = decode_ffn_tp(x, a, *_ffn_args(w), lambda s: s, *_ffn_biases(w))
    assert (decode_qkv.launches, decode_ffn.launches, decode_ffn_tp.launches) == before
    assert torch.equal(y_tp, y)
    assert torch.equal(qkv, decode_qkv_plain(x, w["ln1_w"], w["ln1_b"], w["w_qkv"], w["b_qkv"]))
    assert y.shape == (B7, C7)


def test_wrappers_refuse_other_devices():
    """Neither a CPU fallback nor a kernel for a device that is not CUDA."""
    m = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_plain(m, m, m)
    cache = torch.empty((1, 2, 4, 64), device="meta")
    row = torch.empty((1, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(row, cache, cache, torch.empty(1, device="meta"), 1, row, row)
    x = torch.empty((1, 64), device="meta")
    w = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_qkv(x, x[0], None, w)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_ffn(x, x, w, x[0], None, w, w)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_ffn_tp(x, x, w, x[0], None, w, w, lambda s: s)
