"""The port's w2v-BERT conformer against the JAX package's
``w2vbert_features``, with the same numpy-drawn parameters, on the CPU.

  * a tiny config (3 blocks), padded batch: atol 5e-5;
  * full width (1024 hidden, 16 heads, FFN 4096) with the depth cut to 2
    blocks, through fbank, the affine-free LayerNorm and the VQ, on 1 s of
    audio: features within 2e-4 (O(1) activations after 2 blocks of f32
    matmuls summed in another order), ids equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotoken_tpu.nn.conformer import W2VBertConfig as JaxW2VBertConfig
from audiotoken_tpu.nn.conformer import w2vbert_features
from audiotoken_tpu.nn.fbank import FbankConfig as JaxFbankConfig
from audiotoken_tpu.nn.fbank import fbank_features as jax_fbank_features
from audiotoken_tpu.ops.lookup import nearest_centroid as jax_nearest_centroid
from audiotoken_tpu_torch.nn.conformer import W2VBertConfig, W2VBertFeatures, init_w2vbert_params
from audiotoken_tpu_torch.nn.fbank import fbank_features
from audiotoken_tpu_torch.ops.lookup import nearest_centroid
from audiotoken_tpu_torch.weights import w2vbert_from_numpy

# tests/test_semantic_parity.py's tiny w2v-BERT
TINY_W2V = dict(
    hidden_size=64,
    num_hidden_layers=3,
    num_attention_heads=4,
    intermediate_size=128,
    feature_projection_input_dim=160,
    left_max_position_embeddings=8,
    right_max_position_embeddings=4,
    conv_depthwise_kernel_size=7,
)


def _module(params, cfg, layers):
    m = W2VBertFeatures(cfg, layers)
    m.load_state_dict(w2vbert_from_numpy(params, layers))
    return m.eval()


def _jax_ln_vq(feats, codebook):
    mu = jnp.mean(feats, axis=-1, keepdims=True)
    var = jnp.var(feats, axis=-1, keepdims=True)
    return np.asarray(jax_nearest_centroid((feats - mu) * (1.0 / jnp.sqrt(var + 1e-5)), codebook))


@pytest.mark.parametrize("layers", [1, 3])
def test_tiny_padded_batch(layers):
    cfg = W2VBertConfig(**TINY_W2V)
    params = init_w2vbert_params(np.random.default_rng(21), cfg)
    rng = np.random.default_rng(22)
    feats = rng.standard_normal((3, 40, 160)).astype(np.float32)
    mask = np.ones((3, 40), np.float32)
    mask[1, 25:] = 0.0
    mask[2, 9:] = 0.0
    ref = np.asarray(w2vbert_features(params, feats, mask, JaxW2VBertConfig(**TINY_W2V),
                                      output_layer=layers))
    with torch.inference_mode():
        out = _module(params, cfg, layers)(torch.from_numpy(feats), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=5e-5)


def test_tiny_without_mask():
    cfg = W2VBertConfig(**TINY_W2V)
    params = init_w2vbert_params(np.random.default_rng(23), cfg)
    feats = np.random.default_rng(24).standard_normal((2, 33, 160)).astype(np.float32)
    ref = np.asarray(w2vbert_features(params, feats, None, JaxW2VBertConfig(**TINY_W2V),
                                      output_layer=3))
    with torch.inference_mode():
        out = _module(params, cfg, 3)(torch.from_numpy(feats), None)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=5e-5)


def test_full_width_two_blocks():
    cfg = W2VBertConfig(num_hidden_layers=2)  # the first 2 blocks of the full draw
    rng = np.random.default_rng(0)
    params = init_w2vbert_params(rng, cfg)
    codebook = rng.standard_normal((2048, 1024)).astype(np.float32)
    arng = np.random.default_rng(25)
    n = 16_000
    audio = (0.2 * arng.standard_normal((2, n))).astype(np.float32)
    mask = np.ones((2, n), np.float32)
    mask[1, 11_000:] = 0.0
    audio *= mask

    proc = jax_fbank_features(audio, mask, JaxFbankConfig())
    ref = w2vbert_features(params, proc["input_features"], proc["attention_mask"],
                           JaxW2VBertConfig(), output_layer=2)
    ref_ids = _jax_ln_vq(ref, codebook)

    with torch.inference_mode():
        p = fbank_features(torch.from_numpy(audio), torch.from_numpy(mask))
        out = _module(params, cfg, 2)(p["input_features"], p["attention_mask"])
        ids = nearest_centroid(torch.nn.functional.layer_norm(out, (1024,), eps=1e-5),
                               torch.from_numpy(codebook))
    assert out.shape == (2, 50, 1024)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)


def test_output_layer_bounds():
    with pytest.raises(ValueError, match="output_layer"):
        W2VBertFeatures(W2VBertConfig(**TINY_W2V), 4)
