"""The port's GPT and Bark-fine against the JAX package's, on the CPU, at
tiny widths (the GPT of tests/test_gpt.py, a Bark-fine of the size in
tests/test_decoders.py).

Weights: the same numpy draws on both sides (checked bit for bit). Logits
agree within 2e-5 (f32, sums in another order). Greedy generation
(``top_k=1``) and argmax fine filling must be token-equal; sampled
generation agrees only in distribution, so it is checked for support
(every token among the top k of its logits) and for determinism per seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.bark_fine import BarkFineConfig as JaxBarkFineConfig
from audiotoken_tpu.nn.bark_fine import BarkFineGenerator as JaxBarkFineGenerator
from audiotoken_tpu.nn.bark_fine import bark_fine_logits as jax_bark_fine_logits
from audiotoken_tpu.nn.bark_fine import init_bark_fine_params as jax_init_bark
from audiotoken_tpu.nn.gpt import GPTConfig as JaxGPTConfig
from audiotoken_tpu.nn.gpt import GPTSampler as JaxGPTSampler
from audiotoken_tpu.nn.gpt import gpt_logits as jax_gpt_logits
from audiotoken_tpu.nn.gpt import init_gpt_params as jax_init_gpt
from audiotoken_tpu_torch.nn.bark_fine import BarkFine, BarkFineConfig, BarkFineGenerator
from audiotoken_tpu_torch.nn.bark_fine import init_bark_fine_params
from audiotoken_tpu_torch.nn.gpt import GPT, GPTConfig, GPTSampler, init_gpt_params
from audiotoken_tpu_torch.weights import bark_fine_from_numpy, gpt_from_numpy

TINY = dict(n_layer=2, n_head=4, n_embd=64, block_size=96, vocab_size=128, bias=True)
TINY_BARK = dict(block_size=64, n_layer=2, n_head=2, n_embd=32, vocab_size=1056,
                 codebook_size=1024, max_history=32)
HIGHEST = jax.lax.Precision.HIGHEST
ATOL = 2e-5


def _leaves(tree):
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in paths}


@pytest.fixture(scope="module")
def gpt_pair():
    params = init_gpt_params(np.random.default_rng(0), GPTConfig(**TINY))
    model = GPT(GPTConfig(**TINY))
    model.load_state_dict(gpt_from_numpy(params))
    jax_sampler = JaxGPTSampler(JaxGPTConfig(**TINY), params, decode_attn="xla")
    return params, GPTSampler(model.eval()), jax_sampler


@pytest.fixture(scope="module")
def bark_pair():
    params = init_bark_fine_params(np.random.default_rng(1), BarkFineConfig(**TINY_BARK))
    model = BarkFine(BarkFineConfig(**TINY_BARK))
    model.load_state_dict(bark_fine_from_numpy(params))
    jax_gen = JaxBarkFineGenerator(JaxBarkFineConfig(**TINY_BARK), params, attn_impl="xla")
    return params, BarkFineGenerator(model.eval()), jax_gen


@pytest.mark.parametrize("bias", [True, False])
def test_init_draws_bitwise_equal(bias):
    cfg = dict(TINY, bias=bias)
    port = _leaves(init_gpt_params(np.random.default_rng(3), GPTConfig(**cfg)))
    ref = _leaves(jax_init_gpt(np.random.default_rng(3), JaxGPTConfig(**cfg)))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    port = _leaves(init_bark_fine_params(np.random.default_rng(4), BarkFineConfig(**TINY_BARK)))
    ref = _leaves(jax_init_bark(np.random.default_rng(4), JaxBarkFineConfig(**TINY_BARK)))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_gpt_logits_match_jax(gpt_pair):
    params, sampler, _ = gpt_pair
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"], size=(2, 48))
    with torch.inference_mode():
        out = sampler.model(torch.from_numpy(ids)).numpy()
    ref = np.asarray(jax_gpt_logits(params, jnp.asarray(ids), JaxGPTConfig(**TINY), HIGHEST))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], size=n).astype(np.int32) for n in lengths]


# 24 fills the prompt bucket (min(32, 96 // 4)); 1 is a row with one real token
@pytest.mark.parametrize("lengths,max_new", [((7, 19, 12), 15), ((24, 1, 30), 20),
                                             ((90,), 50), ((60, 3), 40)],
                         ids=["ragged", "bucket_edges", "slide", "slide_ragged"])
def test_greedy_generate_equals_jax(gpt_pair, lengths, max_new):
    """Token-equal to the JAX sampler's einsum path, including the slide
    to the trailing context when prompt + new tokens pass block_size."""
    _, sampler, jax_sampler = gpt_pair
    prompts = _prompts(sum(lengths), lengths)
    kw = dict(max_new_tokens=max_new, temperature=1.0, top_k=1)
    out = sampler.generate_batch(prompts, **kw)
    np.testing.assert_array_equal(out, jax_sampler.generate_batch(prompts, **kw))
    assert (out >= 0).all()


def test_per_row_stops_equal_jax(gpt_pair):
    """A stop token that row 0 meets at once and row 1 later (or never):
    -1 at and after each row's stop, the other rows untouched."""
    _, sampler, jax_sampler = gpt_pair
    prompts = _prompts(7, (9, 9, 14))
    kw = dict(max_new_tokens=24, temperature=1.0, top_k=1)
    free = jax_sampler.generate_batch(prompts, **kw)
    stop = int(free[0, 0])
    out = sampler.generate_batch(prompts, stop_token=stop, **kw)
    np.testing.assert_array_equal(out, jax_sampler.generate_batch(prompts, stop_token=stop, **kw))
    assert (out[0] == -1).all()
    for i in (1, 2):
        hits = np.flatnonzero(free[i] == stop)
        n = hits[0] if hits.size else 24
        np.testing.assert_array_equal(out[i, :n], free[i, :n])
        assert (out[i, n:] == -1).all()


def test_sampled_tokens_in_top_k_and_seeded(gpt_pair):
    _, sampler, _ = gpt_pair
    prompts = _prompts(11, (8, 13))
    kw = dict(max_new_tokens=20, temperature=0.9, top_k=5)
    a = sampler.generate_batch(prompts, seed=3, **kw)
    np.testing.assert_array_equal(a, sampler.generate_batch(prompts, seed=3, **kw))
    assert not np.array_equal(a, sampler.generate_batch(prompts, seed=4, **kw))
    for p, row in zip(prompts, a):
        seq = torch.from_numpy(np.concatenate([p, row]).astype(np.int64))[None]
        with torch.inference_mode():
            logits = sampler.model(seq)[0, len(p) - 1 : -1]  # the logits each token was drawn from
        top = torch.topk(logits, 5, dim=-1).indices.numpy()
        assert all(tok in cand for tok, cand in zip(row, top))


@pytest.mark.parametrize("cb", [1, 4, 7])
def test_bark_fine_logits_match_jax(bark_pair, cb):
    params, gen, _ = bark_pair
    codes = np.random.default_rng(cb).integers(0, 1025, size=(2, TINY_BARK["block_size"], 8))
    with torch.inference_mode():
        out = gen.model(torch.from_numpy(codes), cb).numpy()
    ref = np.asarray(jax_bark_fine_logits(params, jnp.asarray(codes), cb,
                                          JaxBarkFineConfig(**TINY_BARK), HIGHEST))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("T", [40, 150], ids=["short", "slides"])
def test_argmax_fine_equals_jax(bark_pair, T):
    """temperature=None: argmax filling, token-equal; T = 150 slides the
    64-frame window four times, T = 40 pads it with the filler id."""
    _, gen, jax_gen = bark_pair
    coarse = np.random.default_rng(T).integers(0, 1024, size=(2, 2, T))
    out = gen.generate_fine_batch(coarse, temperature=None)
    ref = jax_gen.generate_fine_batch(coarse, temperature=None)
    assert out.shape == (2, 8, T)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[:, :2], coarse)


def test_sampled_fine_is_seeded(bark_pair):
    _, gen, _ = bark_pair
    coarse = np.random.default_rng(9).integers(0, 1024, size=(1, 2, 50))
    a = gen.generate_fine_batch(coarse, temperature=0.5, seed=1)
    np.testing.assert_array_equal(a, gen.generate_fine_batch(coarse, temperature=0.5, seed=1))
    assert a.min() >= 0 and a.max() < 1024
