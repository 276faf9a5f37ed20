"""K8's plain twins (``ops/attn_ablation.py``) on the CPU, in bf16 and f32.

The Pallas ablation kernels are nested inside
``scripts/profile_attn_micro.py:main`` and cannot be imported, so each
twin is held against a numpy transcription of its Pallas body (lines cited
below), rounding to bf16 where the body casts ``p`` and the output; the
``full`` mode against a transcription of the JAX package's
``_kernel_plain``. The ``onepass`` twin and the ``full`` tile loop are also
held against the JAX package's ``_flash_attention_plain`` in interpret
mode: its one-pass kernel (T <= 1024) and its tiled online-softmax kernel
(T > 1024).

Tolerances, relative to the largest output (``noexp`` divides by
max(l, 1e-30) = 1e-30, so its outputs are about 1e30 and only a relative
bound means anything): f32 2e-5, where only the order of sums differs. In
bf16 a score summed in another order can round p to the neighbouring bf16
value, so 2^-7 of the output's scale (the K5 bound of the card tests).
The CUDA kernel is held against these twins on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py 3d). In bf16 that kernel
is K5's (``csrc/flash_attention_bf16.cu``) with one part taken out; a numpy
transcription of its order of work is held against the twins here.
"""

import os
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from audiotoken_tpu.ops.flash_attention import _flash_attention_plain as jax_flash_plain
from audiotoken_tpu_torch.ops.attn_ablation import (
    CASES,
    KERNEL_TILES,
    attn_ablation,
    attn_ablation_plain,
)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SHARE = {"f32": 2e-5, "bf16": 2**-7}


def _inputs(shape, dt, seed):
    """q (pre-scaled by 1/8, exact in bf16), k, v from their own generator."""
    r = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((r.standard_normal(shape) * 0.3).astype(np.float32))
               .to(DTYPES[dt]) for _ in range(3))
    return q * 0.125, k, v


def _round(x, dt):
    return x.astype(ml_dtypes.bfloat16).astype(np.float32) if dt == "bf16" else x


def _pallas_ablation_np(q, k, v, mode, tile, dt):
    """scripts/profile_attn_micro.py:60-100 (``ablation_kernel``) over the
    key-tile grid axis of :108, per (batch*head, query tile), in numpy f32;
    ``full`` is audiotoken_tpu/ops/flash_attention.py:244-263
    (``_kernel_plain``) over the grid axis of :309."""
    q, k, v = (t.float().numpy() for t in (q, k, v))
    T = q.shape[-2]
    m = np.full(q.shape[:-1] + (1,), -np.inf, np.float32)  # :66-70
    l = np.zeros_like(m)
    acc = np.zeros_like(q)
    for k0 in range(0, T, tile):
        s = q @ np.swapaxes(k[..., k0:k0 + tile, :], -1, -2)  # :72-76
        if mode == "dotsonly":  # :77-79
            p = _round(s * np.float32(1e-6), dt)
            l = l + np.float32(1.0)
        else:  # :81-90, noexp; full: flash_attention.py:249-253
            m_new = np.maximum(m, s.max(axis=-1, keepdims=True))
            alpha = np.exp(m - m_new)
            p = np.exp(s - m_new) if mode == "full" else s - m_new
            l = l * alpha + p.sum(axis=-1, keepdims=True)
            p = _round(p, dt)
            m = m_new
            if mode == "full":  # flash_attention.py:254-257
                acc = acc * alpha
        acc = acc + p @ v[..., k0:k0 + tile, :]  # :91-95, noexp: no rescale by alpha
    return _round(acc / np.maximum(l, np.float32(1e-30)), dt)  # :97-100


def _pallas_onepass_np(q, k, v, dt):
    """scripts/profile_attn_micro.py:133-150 (``onepass_kernel``), numpy f32."""
    q, k, v = (t.float().numpy() for t in (q, k, v))
    s = q @ np.swapaxes(k, -1, -2)  # :137-141
    m = s.max(axis=-1, keepdims=True)  # :142
    p = np.exp(s - m)  # :143
    l = p.sum(axis=-1, keepdims=True)  # :144
    acc = _round(p, dt) @ v  # :145-149
    return _round(acc / np.maximum(l, np.float32(1e-30)), dt)  # :150


def _assert_close(out, ref, dt):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= SHARE[dt] * scale, (err, scale)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_twin_matches_pallas_body(case, dt):
    mode = case.rstrip("0123456789")
    tile = int(case[len(mode):])
    q, k, v = _inputs((2, 2, 256, 64), dt, seed=tile)
    out = attn_ablation_plain(q, k, v, mode, tile)
    assert out.dtype == DTYPES[dt]
    ref = (_pallas_onepass_np(q, k, v, dt) if mode == "onepass"
           else _pallas_ablation_np(q, k, v, mode, tile, dt))
    _assert_close(out.float().numpy(), ref, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_onepass_twin_matches_jax_flash_plain(dt):
    """T <= 1024: ``_flash_attention_plain`` takes its one-pass kernel."""
    q, k, v = _inputs((1, 2, 384, 64), dt, seed=5)
    out = attn_ablation_plain(q, k, v, "onepass", 16)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    ref = jax_flash_plain(*(jnp.asarray(t.float().numpy()).astype(jdt) for t in (q * 8, k, v)),
                          tile=128, interpret=True)
    _assert_close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_tile_loop_matches_jax_flash_plain(dt):
    """T > 1024: ``_flash_attention_plain`` takes its tiled online-softmax
    kernel (``_kernel_plain``), the recurrence that noexp and dotsonly
    ablate; the twin's ``full`` mode runs the same loop."""
    q, k, v = _inputs((1, 2, 1280, 64), dt, seed=6)
    out = attn_ablation_plain(q, k, v, "full", 256)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    ref = jax_flash_plain(*(jnp.asarray(t.float().numpy()).astype(jdt) for t in (q * 8, k, v)),
                          tile=256, interpret=True)
    _assert_close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_full_twin_matches_jax_flash_plain(dt):
    """``full64``, the kernel's tile, against the JAX function: its tiled
    kernel at T = 1280 (key tiles of 256, so p rounds against other running
    maxima in bf16) and its one-pass kernel at T = 512."""
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    for T, seed in ((1280, 10), (512, 11)):
        q, k, v = _inputs((1, 2, T, 64), dt, seed=seed)
        out = attn_ablation_plain(q, k, v, "full", 64)
        ref = jax_flash_plain(*(jnp.asarray(t.float().numpy()).astype(jdt)
                                for t in (q * 8, k, v)), tile=256, interpret=True)
        _assert_close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), dt)


def test_the_tile_changes_the_ablations():
    """The ablations are not attention: their result depends on the tile,
    which is why the tile is an argument of both kernel and twin."""
    q, k, v = _inputs((1, 2, 256, 64), "f32", seed=7)
    for mode in ("noexp", "dotsonly"):
        a, b = (attn_ablation_plain(q, k, v, mode, t) for t in KERNEL_TILES[mode])
        assert not torch.allclose(a, b)
    a, b = (attn_ablation_plain(q, k, v, "onepass", t) for t in KERNEL_TILES["onepass"])
    assert torch.equal(a, b)


def test_wrapper_on_cpu_runs_the_twin_and_counts_nothing():
    q, k, v = _inputs((1, 2, 128, 64), "bf16", seed=8)
    before = sum(attn_ablation.launches.values())
    torch.testing.assert_close(attn_ablation(q, k, v, "noexp", 64),
                               attn_ablation_plain(q, k, v, "noexp", 64), rtol=0, atol=0)
    assert sum(attn_ablation.launches.values()) == before


def test_refusals():
    q, k, v = _inputs((1, 1, 192, 64), "f32", seed=9)
    with pytest.raises(ValueError, match="not compiled"):
        attn_ablation(q, k, v, "noexp", 256)
    with pytest.raises(ValueError, match="not compiled"):
        attn_ablation(q, k, v, "plain", 64)
    with pytest.raises(ValueError, match="not compiled"):
        attn_ablation(q, k, v, "full", 128)
    with pytest.raises(ValueError, match="multiple of the tile"):
        attn_ablation(q, k, v, "dotsonly", 128)
    with pytest.raises(ValueError, match="unknown mode"):
        attn_ablation_plain(q, k, v, "exp", 64)


LOG2E = np.float32(1.4426950408889634)


def _fma_log2(s, m):
    """fmaf(s, log2e, -m log2e) in f32: the product exact, one rounding."""
    return (s.astype(np.float64) * np.float64(LOG2E)
            - (m * LOG2E).astype(np.float64)[..., None]).astype(np.float32)


def _quad_sum(l):
    """The quad's four partial sums combined as two shuffles do it."""
    return (l[..., 0] + l[..., 1]) + (l[..., 2] + l[..., 3])


def _k5_kernel_np(q, k, v, mode, tile):
    """K8's bf16 kernel in its order of work (csrc/flash_attention_bf16.cu),
    numpy f32. ``noexp``, ``dotsonly`` and ``full`` are K5's kernel: per
    recurrence step of ``tile`` keys (at 128 both 64-key halves are scored
    before m' is taken), each row's l kept as the four partial sums of a
    quad (thread t holds keys 8n + 2t and 8n + 2t + 1 of each 8-key n-tile)
    and combined at the end; ``full`` in the log2 domain, alpha = exp2((m -
    m') log2e) and p = exp2(fma(s, log2e, -m' log2e)); ``dotsonly``'s 1 a
    step added by one thread of the quad. ``onepass``: exact rows, p in the
    log2 domain, l summed by 8 threads a row (float4 chunks 32 floats apart)
    and a shuffle tree. Every mode writes bf16(acc * (1 / max(l, 1e-30)))."""
    q, k, v = (t.float().numpy() for t in (q, k, v))
    lead = q.shape[:-1]
    if mode == "onepass":
        s = q @ np.swapaxes(k, -1, -2)
        m = s.max(axis=-1)
        p = np.exp2(_fma_log2(s, m))
        chunks = p.reshape(lead + (-1, 8, 4))  # [.., i, u, 4]: thread u's i-th float4
        part = ((chunks[..., 0] + chunks[..., 1]) + (chunks[..., 2] + chunks[..., 3])).sum(
            axis=-2, dtype=np.float32)  # [.., u], in i order
        for off in (1, 2, 4):
            part = part + part[..., np.arange(8) ^ off]
        l, acc = part[..., 0], _round(p, "bf16") @ v
    else:
        m = np.full(lead, -np.inf, np.float32)
        lq = np.zeros(lead + (4,), np.float32)
        acc = np.zeros_like(q)
        for k0 in range(0, q.shape[-2], tile):
            s = q @ np.swapaxes(k[..., k0:k0 + tile, :], -1, -2)
            if mode == "dotsonly":
                p = s * np.float32(1e-6)
                lq[..., 0] += np.float32(1.0)
            else:
                mx = np.maximum(m, s.max(axis=-1))
                alpha = np.exp2((m - mx) * LOG2E)
                lq *= alpha[..., None]
                if mode == "full":
                    acc *= alpha[..., None]
                p = s - mx[..., None] if mode == "noexp" else np.exp2(_fma_log2(s, mx))
                pairs = p.reshape(lead + (tile // 8, 4, 2))  # [.., n, t, 2]
                for n in range(tile // 8):
                    lq += pairs[..., n, :, 0] + pairs[..., n, :, 1]
                m = mx
            acc += _round(p, "bf16") @ v[..., k0:k0 + tile, :]
        l = _quad_sum(lq)
    inv = np.float32(1.0) / np.maximum(l, np.float32(1e-30))
    return _round(acc * inv[..., None], "bf16")


@pytest.mark.parametrize("case", CASES)
def test_kernel_order_of_work_matches_twin(case):
    mode = case.rstrip("0123456789")
    tile = int(case[len(mode):])
    q, k, v = _inputs((2, 2, 256, 64), "bf16", seed=20 + tile)
    _assert_close(_k5_kernel_np(q, k, v, mode, tile),
                  attn_ablation_plain(q, k, v, mode, tile).float().numpy(), "bf16")


def test_dotsonly_order_of_work_counts_tiles():
    """dotsonly's l is the number of key tiles, one count a row (not one a
    thread of the quad): the output is bf16(acc / tiles)."""
    q, k, v = _inputs((1, 2, 256, 64), "bf16", seed=30)
    for tile in KERNEL_TILES["dotsonly"]:
        acc = _round(q.float().numpy() @ np.swapaxes(k.float().numpy(), -1, -2)
                     * np.float32(1e-6), "bf16") @ v.float().numpy()
        np.testing.assert_allclose(_k5_kernel_np(q, k, v, "dotsonly", tile),
                                   _round(acc / np.float32(256 // tile), "bf16"),
                                   rtol=2**-7, atol=2**-7 * np.abs(acc).max() / (256 // tile))


def test_k5_split_reads_plain():
    """The micro-profile splits K5's own time (``plain``); ``full64``, the
    same kernel through K8's entry, enters no term."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    from profile_attn_micro_torch import k5_split, split_lines

    times = {"plain": 0.30, "full64": 0.31, "dotsonly64": 0.20, "noexp64": 0.25, "sdpa": 0.16}
    split = k5_split(times)
    assert split == pytest.approx({"dots_ms": 0.20, "softmax_ms": 0.10,
                                   "exp_and_rescale_ms": 0.05})
    assert k5_split({**times, "full64": 9.0}) == split
    assert k5_split({**times, "plain": 0.40})["softmax_ms"] == pytest.approx(0.20)
    lines = split_lines(times)
    assert "K5 (plain) 0.3000 ms" in lines[0] and "softmax_ms 0.1000 (33.3 %)" in lines[1]
