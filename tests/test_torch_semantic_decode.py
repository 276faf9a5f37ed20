"""The port's semantic decode (GPT -> Bark-fine -> EnCodec decoder) against
the JAX package's, on the CPU, with the tiny GPT and Bark-fine of
tests/test_decoders.py injected into both packages and the full-width
acoustic decoder.

With ``top_k=1`` and both fine stages switched to argmax (inside the test
only), the pipeline is deterministic: the waveforms must agree within
1e-5 of their scale (f32 sums in another order in the EnCodec decoder;
the tokens before it are equal). Sampled decoding agrees only in
distribution, so it is checked for determinism per seed.
"""

import functools

import numpy as np
import pytest

from audiotoken_tpu import weights as jax_weights
from audiotoken_tpu.configs import SemanticDecoderConfig as JaxSemanticDecoderConfig
from audiotoken_tpu.convert.store import save_params as jax_save_params
from audiotoken_tpu.decoders import Wav2VecBertDecoder as JaxWav2VecBertDecoder
from audiotoken_tpu.nn.bark_fine import BarkFineConfig as JaxBarkFineConfig
from audiotoken_tpu.nn.bark_fine import init_bark_fine_params as jax_init_bark
from audiotoken_tpu.nn.gpt import GPTConfig as JaxGPTConfig
from audiotoken_tpu.nn.gpt import init_gpt_params as jax_init_gpt
from audiotoken_tpu_torch import AudioToken, HubertDecoder, Tokenizers, Wav2VecBertDecoder
from audiotoken_tpu_torch import weights as port_weights
from audiotoken_tpu_torch.configs import COMMONS, SemanticDecoderConfig
from audiotoken_tpu_torch.decoders import _SemanticDecoderBase
from audiotoken_tpu_torch.io.wavfile import write_wav
from audiotoken_tpu_torch.nn.bark_fine import BarkFineConfig
from audiotoken_tpu_torch.nn.gpt import GPTConfig
from test_torch_offline import offline

VOCAB = SemanticDecoderConfig().vocab.vocab_size
GPT_TINY = dict(block_size=512, vocab_size=VOCAB, n_layer=1, n_head=2, n_embd=32)
BARK_TINY = dict(block_size=64, n_layer=1, n_head=2, n_embd=32, vocab_size=1056,
                 codebook_size=1024, max_history=32)
F32 = dict(ar_dtype="float32", ar_precision="highest", fine_dtype="float32",
           fine_precision="highest")
REL = 1e-5


def _leaves(tree):
    import jax

    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in paths}


@pytest.fixture
def tiny_weights(monkeypatch):
    """Both packages draw the tiny GPT from seed 0 and Bark-fine from 1."""
    monkeypatch.setattr(jax_weights, "get_semantic_gpt_params", lambda w, s, key, vs: (
        jax_init_gpt(np.random.default_rng(0), JaxGPTConfig(**GPT_TINY)),
        JaxGPTConfig(**GPT_TINY)))
    monkeypatch.setattr(jax_weights, "get_bark_fine_params", lambda w, s: (
        jax_init_bark(np.random.default_rng(1), JaxBarkFineConfig(**BARK_TINY)),
        JaxBarkFineConfig(**BARK_TINY)))
    real_gpt, real_bark = port_weights.get_semantic_gpt_params, port_weights.get_bark_fine_params
    monkeypatch.setattr(port_weights, "get_semantic_gpt_params", lambda w, s, key, vs: real_gpt(
        "random", 0, key, vs, config=GPTConfig(**GPT_TINY)))
    monkeypatch.setattr(port_weights, "get_bark_fine_params", lambda w, s: real_bark(
        "random", 1, config=BarkFineConfig(**BARK_TINY)))


def _argmax_fine(dec):
    dec.bark.generate_fine_batch = functools.partial(dec.bark.generate_fine_batch,
                                                     temperature=None)
    return dec


def _sources(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, size=n) for n in lengths]


def test_greedy_pipeline_matches_jax(tiny_weights):
    kw = dict(weights="random", max_new_tokens=24, top_k=1, **F32)
    port = _argmax_fine(Wav2VecBertDecoder(device="cpu", **kw))
    ref = _argmax_fine(JaxWav2VecBertDecoder(**kw))
    sources = _sources(1, (20, 11, 16))
    coarse = port._ar_stage(sources, 0)
    for a, b in zip(coarse, ref._ar_stage(sources, 0)):
        np.testing.assert_array_equal(a, b)
    wavs, refs = port.decode_batch(sources, seed=0), ref.decode_batch(sources, seed=0)
    assert len(wavs) == 3
    for w, r, c in zip(wavs, refs, coarse):
        assert w.shape == r.shape == (1, c.shape[1] * 320) and w.dtype == np.float32
        np.testing.assert_allclose(w, r, rtol=0, atol=REL * np.abs(r).max())


def test_sampled_decode_is_seeded(tiny_weights):
    """Defaults: bf16 AR and fine stages, temperature 0.8, top-k 100."""
    dec = Wav2VecBertDecoder(weights="random", device="cpu", max_new_tokens=16)
    sources = _sources(2, (14, 9))
    a = dec.decode_batch(sources, seed=5)
    for x, y in zip(a, dec.decode_batch(sources, seed=5)):
        np.testing.assert_array_equal(x, y)
    for w in a:
        assert w.ndim == 2 and w.shape[0] == 1 and w.shape[1] % 320 == 0 and w.shape[1] > 0
        assert np.isfinite(w).all()


def test_api_decode_int16_is_the_float_path(tiny_weights, tmp_path):
    kw = dict(max_new_tokens=16, top_k=1, **F32)
    src = _sources(3, (12,))[0]
    f = AudioToken(Tokenizers.semantic_m, weights="random", device="cpu").decode(src, **kw)
    i = AudioToken(Tokenizers.semantic_m, weights="random", device="cpu").decode_batch(
        [src], output_dtype="int16", **kw)[0]
    assert f.dtype == np.float32 and i.dtype == np.int16 and f.shape == i.shape
    write_wav(str(tmp_path / "f.wav"), np.clip(f, -0.99, 0.99), 24_000)
    write_wav(str(tmp_path / "i.wav"), i, 24_000)
    assert (tmp_path / "f.wav").read_bytes() == (tmp_path / "i.wav").read_bytes()


def test_refusals(tiny_weights):
    with pytest.raises(ValueError, match="mixed"):
        Wav2VecBertDecoder(weights="random", device="cpu", precision="mixed")
    with pytest.raises(AssertionError):
        HubertDecoder(language=COMMONS.HI, weights="random", device="cpu")
    dec = Wav2VecBertDecoder(weights="random", device="cpu", max_new_tokens=8, top_k=1)
    with pytest.raises(NotImplementedError, match="pipeline_batch"):
        dec.decode_batch(_sources(4, (5, 6, 7)), pipeline_batch=2)
    assert len(dec.decode_batch(_sources(4, (5, 6)), pipeline_batch=2)) == 2
    at = AudioToken(Tokenizers.semantic_s, weights="random", device="cpu")
    with pytest.raises(ValueError, match="audio_files or audio_dir"):
        at.encode_batch_files(batch_size=2, outdir="unused")
    with pytest.raises(ValueError, match="could not open"):
        at.encode(b"RIFF")


def test_api_semantic_s_decode_matches_jax(tiny_weights):
    """AudioToken(semantic_s).decode_batch goes through HubertDecoder (EN)
    and gives the JAX facade's greedy waveforms."""
    from audiotoken_tpu import AudioToken as JaxAudioToken
    from audiotoken_tpu import Tokenizers as JaxTokenizers

    kw = dict(max_new_tokens=24, top_k=1, **F32)
    port = AudioToken(Tokenizers.semantic_s, weights="random", device="cpu")
    ref = JaxAudioToken(JaxTokenizers.semantic_s, weights="random")
    port.load_decoder(**kw)
    ref.load_decoder(**kw)
    assert isinstance(port.decoder, HubertDecoder) and port.decoder.language == COMMONS.EN
    _argmax_fine(port.decoder)
    _argmax_fine(ref.decoder)
    sources = _sources(4, (18, 9))
    wavs, refs = port.decode_batch(sources), ref.decode_batch(sources)
    for w, r in zip(wavs, refs):
        assert w.shape == r.shape and w.dtype == np.float32
        np.testing.assert_allclose(w, r, rtol=0, atol=REL * np.abs(r).max())


def test_deinterleave_equals_jax():
    dec = object.__new__(_SemanticDecoderBase)
    dec.config = SemanticDecoderConfig()
    stream = np.array([5, 1024 + 7, 9, 1024 + 11, 13, 3000])
    from audiotoken_tpu.decoders import _SemanticDecoderBase as JaxBase

    ref = object.__new__(JaxBase)
    ref.config = JaxSemanticDecoderConfig()
    np.testing.assert_array_equal(dec._deserialize(stream), ref._deserialize(stream))
    np.testing.assert_array_equal(dec._deserialize(stream[:5]), [[5, 9], [7, 11]])


@pytest.mark.parametrize("seed", [0, 3])
def test_random_params_bitwise_equal(seed):
    port, _ = port_weights.get_semantic_gpt_params("random", seed, "gpt_semantic_m_hi", VOCAB,
                                                   config=GPTConfig(**GPT_TINY))
    ref = jax_init_gpt(np.random.default_rng(seed), JaxGPTConfig(**GPT_TINY))
    assert _leaves(port).keys() == _leaves(ref).keys()
    for k, v in _leaves(ref).items():
        np.testing.assert_array_equal(_leaves(port)[k], v, err_msg=k)
    port, _ = port_weights.get_bark_fine_params("random", seed, config=BarkFineConfig(**BARK_TINY))
    ref = jax_init_bark(np.random.default_rng(seed), JaxBarkFineConfig(**BARK_TINY))
    for k, v in _leaves(ref).items():
        np.testing.assert_array_equal(_leaves(port)[k], v, err_msg=k)


def test_converted_store_loads(tmp_path, monkeypatch):
    tree = jax_init_gpt(np.random.default_rng(1), JaxGPTConfig(**GPT_TINY))
    jax_save_params(str(tmp_path / "gpt_semantic_m_hi.npz"), tree)
    bark = jax_init_bark(np.random.default_rng(2), JaxBarkFineConfig(**BARK_TINY))
    jax_save_params(str(tmp_path / "bark_fine.npz"), bark)
    got, cfg = port_weights.get_semantic_gpt_params(str(tmp_path), 0, "gpt_semantic_m_hi", VOCAB)
    assert cfg.vocab_size == VOCAB
    for k, v in _leaves(tree).items():
        np.testing.assert_array_equal(_leaves(got)[k], v, err_msg=k)
    got, _ = port_weights.get_bark_fine_params(str(tmp_path), 0)
    for k, v in _leaves(bark).items():
        np.testing.assert_array_equal(_leaves(got)[k], v, err_msg=k)
    with pytest.raises(FileNotFoundError):
        port_weights.get_bark_fine_params(str(tmp_path / "none"), 0)
    offline(monkeypatch, tmp_path / "none")  # weights="artifacts" with nothing staged
    with pytest.raises(FileNotFoundError, match="AUDIOTOKEN_ARTIFACTS"):
        port_weights.get_semantic_gpt_params("artifacts", 0, "gpt_semantic_m_hi", VOCAB)
