"""The encoders' precision modes and ``buckets`` against the JAX package, on
the CPU.

  * the policies map to TF32 by one rule: JAX ``HIGHEST`` -> IEEE f32,
    ``HIGH`` and ``DEFAULT`` -> TF32, ``bfloat16``'s f32 products included;
  * the port's ``StagePrecision`` gives, for each of the 12 stages, the TF32
    setting of the JAX ``StagePrecision``'s ``Precision`` under every mode
    and an explicit override, read at each stage's call in a forward
    (module pre-hooks for the linears, a ``TorchFunctionMode`` for the mel
    product, the VQ product and the depthwise conv, which is IEEE under
    every mode);
  * ids equal to the JAX encoders' under ``high``, ``default`` and ``mixed``
    at a small width (the CPU computes both sides in f32);
  * ``bfloat16`` features against the JAX package's jitted bf16 forward at
    ``DEFAULT``: the port's error is at most a quarter of JAX's own
    bf16-vs-f32 gap on the same input, a bound that rounding the input alone
    does not meet;
  * the attention kernels' ``precision``, passed by each caller: the
    conformer's ``attn_kernel`` stage, HuBERT's policy, Bark-fine's fine
    policy, each the name of the JAX ``Precision`` the JAX caller passes;
  * ``buckets``: a custom grid pads as the JAX encoder's does, ids equal;
  * the refusals: ``mixed`` on acoustic and semantic_s, ``--precision
    mixed`` in the CLI before any weights load, an unknown stage.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

import audiotoken_tpu.nn.conformer as jax_conformer_nn
import audiotoken_tpu.nn.hubert as jax_hubert_nn
import audiotoken_tpu.weights as jax_weights
from audiotoken_tpu.configs import HubertEncoderConfig as JaxHubertEncoderConfig
from audiotoken_tpu.configs import Wav2VecBertConfig as JaxWav2VecBertConfig
from audiotoken_tpu.encoders import AcousticEncoder as JaxAcousticEncoder
from audiotoken_tpu.encoders import HubertEncoder as JaxHubertEncoder
from audiotoken_tpu.encoders import Wav2VecBertEncoder as JaxWav2VecBertEncoder
from audiotoken_tpu.runtime import precision as jax_precision
from audiotoken_tpu_torch import Wav2VecBertDecoder
from audiotoken_tpu_torch import api as port_api
from audiotoken_tpu_torch import cli
from audiotoken_tpu_torch import decoders as port_decoders
from audiotoken_tpu_torch import encoders as port_encoders
from audiotoken_tpu_torch import weights as port_weights
from audiotoken_tpu_torch.configs import HubertEncoderConfig, Wav2VecBertConfig
from audiotoken_tpu_torch.nn import bark_fine as port_bark_nn
from audiotoken_tpu_torch.nn import conformer as port_conformer_nn
from audiotoken_tpu_torch.nn import hubert as port_hubert_nn
from audiotoken_tpu_torch.nn.bark_fine import BarkFineConfig
from audiotoken_tpu_torch.encoders import AcousticEncoder, HubertEncoder, Wav2VecBertEncoder
from audiotoken_tpu_torch.nn.conformer import W2VBertConfig, W2VBertFeatures, init_w2vbert_params
from audiotoken_tpu_torch.nn.gpt import GPTConfig
from audiotoken_tpu_torch.nn.hubert import HubertConfig, HubertFeatures, init_hubert_params
from audiotoken_tpu_torch.runtime import precision as port_precision
from audiotoken_tpu_torch.weights import hubert_from_numpy, w2vbert_from_numpy

SR = 16_000
NARROW_W2V = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                  intermediate_size=128)
NARROW_HUBERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                     intermediate_size=128, conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                     num_conv_pos_embedding_groups=4)
HIGHEST = jax.lax.Precision.HIGHEST
# the JAX configs as imported: the module fixture below patches the names
JAX_W2V_CONFIG, JAX_HUBERT_CONFIG = jax_conformer_nn.W2VBertConfig, jax_hubert_nn.HubertConfig

#: (label, precision, stage_overrides)
MODES = [
    ("highest", "highest", None),
    ("high", "high", None),
    ("default", "default", None),
    ("bfloat16", "bfloat16", None),
    ("mixed", "mixed", None),
    ("override", "highest", {"conv": "high", "attn_qkv": "default", "vq": "bfloat16",
                             "attn_kernel": "high"}),
]


def _switches():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture(scope="module")
def narrow():
    """Both packages' semantic_m and semantic_s encoders at a narrow width
    (2 blocks / layers), with the same numpy weights."""
    w2v = init_w2vbert_params(np.random.default_rng(0), W2VBertConfig(**NARROW_W2V))
    codebook = np.random.default_rng(1).standard_normal((2048, 64)).astype(np.float32)
    hub = init_hubert_params(np.random.default_rng(2), HubertConfig(**NARROW_HUBERT))
    centroids = np.random.default_rng(3).standard_normal((1000, 64)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_conformer_nn, "W2VBertConfig",
                   lambda **kw: JAX_W2V_CONFIG(**NARROW_W2V, **kw))
        mp.setattr(jax_hubert_nn, "HubertConfig", lambda **kw: JAX_HUBERT_CONFIG(**NARROW_HUBERT, **kw))
        mp.setattr(jax_weights, "get_w2vbert_params", lambda w, s, c: (w2v, codebook))
        mp.setattr(jax_weights, "get_hubert_params", lambda w, s, c: (hub, centroids))
        mp.setattr(port_encoders, "W2VBertConfig", lambda **kw: W2VBertConfig(**NARROW_W2V, **kw))
        mp.setattr(port_encoders, "HubertConfig",
                   lambda **kw: HubertConfig(**NARROW_HUBERT, **kw))
        mp.setattr(port_encoders, "get_w2vbert_params", lambda w, s, c: (w2v, codebook))
        mp.setattr(port_encoders, "get_hubert_params", lambda w, s, c: (hub, centroids))
        yield {
            "semantic_m": (lambda **kw: Wav2VecBertEncoder(
                Wav2VecBertConfig(output_layer=2), weights="random", device="cpu", **kw),
                lambda **kw: JaxWav2VecBertEncoder(
                    JaxWav2VecBertConfig(output_layer=2), weights="random", **kw)),
            "semantic_s": (lambda **kw: HubertEncoder(
                HubertEncoderConfig(output_layer=2), weights="random", device="cpu", **kw),
                lambda **kw: JaxHubertEncoder(
                    JaxHubertEncoderConfig(output_layer=2), weights="random", **kw)),
        }


@pytest.fixture(scope="module")
def speech():
    """Two rows of 0.7 s, the second cut to 0.5 s, and their lengths."""
    x = (np.random.default_rng(4).standard_normal((2, 11_200)) * 0.2).astype(np.float32)
    x[1, 8000:] = 0.0
    return x, np.array([11_200, 8000])


# --- the policies and the stage map -------------------------------------------


@pytest.mark.parametrize("name", ["highest", "high", "default", "bfloat16"])
def test_policy_mapping_rule(name):
    jp, pp = jax_precision.get_policy(name), port_precision.get_policy(name)
    assert pp.allow_tf32 == (jp.matmul_precision != HIGHEST)
    assert pp.matmul_precision == jp.matmul_precision.name.lower()
    assert str(pp.compute_dtype).split(".")[-1] == jnp.dtype(jp.compute_dtype).name
    saved = _switches()
    with pp.numerics():
        assert _switches() == (pp.allow_tf32, pp.allow_tf32)
    assert _switches() == saved


class _Recorder(TorchFunctionMode):
    """The TF32 switches at the mel product, the VQ product and the
    depthwise conv."""

    def __init__(self, log, mel_rows, code_shape):
        super().__init__()
        self.log, self.mel_rows, self.code_shape = log, mel_rows, code_shape

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.matmul and args[1].dtype == torch.float32:
            if args[1].shape[0] == self.mel_rows:
                self.log.append(("fbank", _switches()))
            elif tuple(args[1].shape) == self.code_shape:
                self.log.append(("vq", _switches()))
        elif func is F.conv1d and kwargs.get("groups", 1) > 1:
            self.log.append(("depthwise", _switches()))
        return func(*args, **kwargs)


def _stage_log(enc, x):
    """(stage, (cuBLAS, cuDNN) TF32 switches) at each stage's call of one
    forward of ``enc``."""
    log = []
    hooks = []

    def hook(stage):
        return lambda mod, inp: log.append((stage, _switches()))

    m = enc.model
    names = {"projection": "proj", "ffn1.inp": "ffn_in", "ffn2.inp": "ffn_in",
             "ffn1.out": "ffn_out", "ffn2.out": "ffn_out", "attn.q": "attn_qkv",
             "attn.k": "attn_qkv", "attn.v": "attn_qkv", "attn.out": "attn_out",
             "conv.pw1": "conv", "conv.pw2": "conv"}
    for name, mod in m.named_modules():
        key = name if name == "projection" else name.split(".", 2)[-1]
        if isinstance(mod, torch.nn.Linear) and key in names:
            hooks.append(mod.register_forward_pre_hook(hook(names[key])))
    try:
        with _Recorder(log, 257, tuple(enc.codebook.t().shape)):
            enc(x)
    finally:
        for h in hooks:
            h.remove()
    return log


@pytest.mark.parametrize("label,precision,overrides", MODES, ids=[m[0] for m in MODES])
def test_stage_map_matches_jax(narrow, speech, label, precision, overrides):
    port_enc = narrow["semantic_m"][0](precision=precision, stage_overrides=overrides)
    # the JAX map built the JAX encoder's way, with the port's "mixed" stages
    base, ov = jax_precision.resolve_mixed(
        precision, overrides, port_precision.W2VBERT_MIXED_OVERRIDES)
    jax_map = jax_precision.StagePrecision(jax_precision.get_policy(base).matmul_precision, ov)
    want = {s: jax_map(s) != HIGHEST for s in jax_precision.StagePrecision.STAGES}
    P = port_enc.stage_prec
    assert port_precision.StagePrecision.STAGES == jax_precision.StagePrecision.STAGES
    assert {s: P.allow_tf32(s) for s in P.STAGES} == want
    log = _stage_log(port_enc, speech[0][:1])
    seen = {stage for stage, _ in log}
    assert seen == {"fbank", "proj", "ffn_in", "ffn_out", "attn_qkv", "attn_out", "conv", "vq",
                    "depthwise"}
    for stage, switches in log:
        expected = False if stage == "depthwise" else want[stage]
        assert switches == (expected, expected), (stage, switches)


@pytest.mark.parametrize("precision", ["high", "default", "bfloat16", "mixed"])
def test_depthwise_conv_is_ieee(narrow, speech, precision):
    """The JAX package's shift-sum has no precision to lower: the port's
    depthwise conv is IEEE f32 while the pointwise linears around it run
    under the conv stage's setting."""
    port_enc = narrow["semantic_m"][0](precision=precision, stage_overrides={"conv": "high"})
    log = _stage_log(port_enc, speech[0][:1])
    assert [s for stage, s in log if stage == "depthwise"] == [(False, False)] * 2
    assert {s for stage, s in log if stage == "conv"} == {(True, True)}


def test_stage_overrides_win(narrow):
    enc = narrow["semantic_m"][0](precision="mixed", stage_overrides={"fbank": "high",
                                                                      "vq": "highest"})
    assert enc.policy.name == "high"
    assert enc.stage_prec("fbank") == "high" and enc.stage_prec("vq") == "highest"
    for stage, value in port_precision.W2VBERT_MIXED_OVERRIDES.items():
        if stage not in ("fbank", "vq"):
            assert enc.stage_prec(stage) == value
    enc.set_precision("bfloat16")
    assert enc.policy.compute_dtype == torch.bfloat16
    assert all(enc.stage_prec.allow_tf32(s) for s in enc.stage_prec.STAGES)


# --- the attention kernels' precision, passed by their callers -----------------


def _record(monkeypatch, module, name):
    """``module.name`` (K4 or K5, as a caller imported it) replaced by a
    recorder of the ``precision`` each call passes, which must be a
    keyword; -> the list it fills."""
    seen, real = [], getattr(module, name)

    def record(*args, precision, **kw):
        seen.append(precision)
        return real(*args, precision=precision, **kw)

    monkeypatch.setattr(module, name, record)
    return seen


@pytest.mark.parametrize(
    "label,precision,overrides",
    MODES + [("attn_kernel_default", "highest", {"attn_kernel": "default"})],
    ids=[m[0] for m in MODES] + ["attn_kernel_default"])
def test_conformer_passes_attn_kernel(narrow, speech, monkeypatch, label, precision, overrides):
    """K4 gets the ``attn_kernel`` stage's member in every block, as the
    JAX conformer passes ``P("attn_kernel")``: "highest" under ``highest``
    and ``mixed``, "default" under ``bfloat16`` and as an override."""
    seen = _record(monkeypatch, port_conformer_nn, "flash_attention_relkey")
    port_enc = narrow["semantic_m"][0](precision=precision, stage_overrides=overrides)
    port_enc(speech[0][:1])
    base, ov = jax_precision.resolve_mixed(
        precision, overrides, port_precision.W2VBERT_MIXED_OVERRIDES)
    jax_map = jax_precision.StagePrecision(jax_precision.get_policy(base).matmul_precision, ov)
    assert seen == [jax_map("attn_kernel").name.lower()] * 2


@pytest.mark.parametrize("policy", ["highest", "high", "default", "bfloat16"])
def test_hubert_passes_its_policy(narrow, speech, monkeypatch, policy):
    """K4 gets the policy's ``matmul_precision`` in every layer, as the JAX
    HuBERT passes its policy's precision; the "xla" route does not reach
    K4."""
    seen = _record(monkeypatch, port_hubert_nn, "flash_attention_relkey")
    x = HubertEncoder.host_transform(speech[0][:1])
    narrow["semantic_s"][0](precision=policy)(x)
    assert seen == [jax_precision.get_policy(policy).matmul_precision.name.lower()] * 2
    narrow["semantic_s"][0](precision=policy, attn_impl="xla")(x)
    assert len(seen) == 2


@pytest.mark.parametrize("fine_precision", ["default", "highest"])
def test_bark_fine_passes_the_fine_precision(monkeypatch, fine_precision):
    """The decoder's ``fine_precision`` reaches K5 in every layer of every
    codebook pass, in f32, as the JAX decoder hands the fine policy's
    precision to its generator. Tiny GPT and Bark-fine, no acoustic
    decoder."""
    bark_cfg = BarkFineConfig(block_size=64, n_layer=2, n_head=2, n_embd=32, max_history=32)
    real_gpt, real_bark = port_weights.get_semantic_gpt_params, port_weights.get_bark_fine_params
    monkeypatch.setattr(port_weights, "get_semantic_gpt_params", lambda w, s, key, vs: real_gpt(
        "random", 0, key, vs, config=GPTConfig(block_size=64, vocab_size=vs, n_layer=1,
                                               n_head=2, n_embd=32)))
    monkeypatch.setattr(port_weights, "get_bark_fine_params",
                        lambda w, s: real_bark("random", 1, config=bark_cfg))
    monkeypatch.setattr(port_decoders, "AcousticDecoder", lambda **kw: None)
    seen = _record(monkeypatch, port_bark_nn, "flash_attention_plain")
    dec = Wav2VecBertDecoder(weights="random", device="cpu", fine_dtype="float32",
                             fine_precision=fine_precision)
    coarse = np.random.default_rng(0).integers(0, 1024, (1, 2, 40))
    fine = dec.bark.generate_fine_batch(coarse, temperature=None)
    assert fine.shape == (1, 8, 40)
    want = jax_precision.get_policy(fine_precision).matmul_precision.name.lower()
    assert seen == [want] * (bark_cfg.n_layer * (bark_cfg.n_codes_total - 2))


# --- the encoders against the JAX package -------------------------------------


@pytest.mark.parametrize("tok,precision", [
    ("semantic_m", "high"), ("semantic_m", "default"), ("semantic_m", "mixed"),
    ("semantic_s", "high"), ("semantic_s", "default"),
])
def test_ids_equal_jax(narrow, speech, tok, precision):
    x, lengths = speech
    if tok == "semantic_s":
        x = HubertEncoder.host_transform(x)
    make_port, make_jax = narrow[tok]
    ids = make_port(precision=precision)(x, attention_mask=lengths)
    ref = make_jax(precision=precision)(x, attention_mask=lengths)
    assert ids.shape == ref.shape and ids.dtype == np.int16
    np.testing.assert_array_equal(ids, ref)


def _bf16_gap_check(port_bf16, port_rounded_input, jax_bf16, jax_f32):
    gap = np.abs(jax_bf16 - jax_f32).max()
    err = np.abs(port_bf16 - jax_bf16).max()
    assert gap > 1e-3  # the bf16 steps matter at this size
    assert err <= gap / 4, (err, gap)
    # rounding only the input misses most of the bf16 effect
    assert np.abs(port_rounded_input - jax_bf16).max() > gap / 4


def test_bf16_conformer_features():
    """The width of the JAX probe: 128 wide, 2 blocks, 2 heads, [2, 200, 160]."""
    kw = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=512)
    params = init_w2vbert_params(np.random.default_rng(0), W2VBertConfig(**kw))
    x = np.random.default_rng(1).standard_normal((2, 200, 160)).astype(np.float32)
    mask = np.ones((2, 200), np.float32)
    mask[1, 150:] = 0.0
    f = jax.jit(lambda a: jax_conformer_nn.w2vbert_features(
        params, a, mask, JAX_W2V_CONFIG(**kw), output_layer=2,
        precision=jax.lax.Precision.DEFAULT))
    jax_bf16 = np.asarray(f(jnp.asarray(x, jnp.bfloat16)), np.float32)
    jax_f32 = np.asarray(f(jnp.asarray(x)))
    m = W2VBertFeatures(W2VBertConfig(**kw), 2)
    m.load_state_dict(w2vbert_from_numpy(params, 2))
    xb, tm = torch.from_numpy(x).bfloat16(), torch.from_numpy(mask)
    with torch.inference_mode():
        port = m.eval()(xb, tm, "bfloat16")
        rounded = m(xb.float(), tm, "bfloat16")
    assert port.dtype == torch.float32
    _bf16_gap_check(port.numpy(), rounded.numpy(), jax_bf16, jax_f32)


def test_bf16_hubert_features():
    """The width of the JAX probe: 128 wide, 2 layers, 2 heads, 32-channel
    convs, [2, 16000]."""
    kw = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
              conv_dim=(32,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    params = init_hubert_params(np.random.default_rng(0), HubertConfig(**kw))
    a = (np.random.default_rng(2).standard_normal((2, 16000)) * 0.5).astype(np.float32)
    mask = np.ones((2, 16000), np.float32)
    mask[1, 12000:] = 0.0
    a = a * mask
    f = jax.jit(lambda x: jax_hubert_nn.hubert_features(
        params, x, mask, JAX_HUBERT_CONFIG(**kw), output_layer=2,
        precision=jax.lax.Precision.DEFAULT))
    jax_bf16 = np.asarray(f(jnp.asarray(a, jnp.bfloat16)), np.float32)
    jax_f32 = np.asarray(f(jnp.asarray(a)))
    m = HubertFeatures(HubertConfig(**kw), 2)
    m.load_state_dict(hubert_from_numpy(params, 2))
    ab, tm = torch.from_numpy(a).bfloat16(), torch.from_numpy(mask)
    with torch.inference_mode():
        port = m.eval()(ab, tm)
        rounded = m(ab.float(), tm)
    assert port.dtype == torch.float32
    _bf16_gap_check(port.numpy(), rounded.numpy(), jax_bf16, jax_f32)


@pytest.mark.parametrize("tok", ["semantic_m", "semantic_s"])
def test_bf16_encoder_features(narrow, speech, tok):
    """The encoders cast where the JAX encoders do: the fbank output
    (semantic_m) or the normalised waveform (semantic_s)."""
    x, lengths = speech
    if tok == "semantic_s":
        x = HubertEncoder.host_transform(x)
    make_port, make_jax = narrow[tok]
    port = make_port(precision="bfloat16", quantize=False)(x, attention_mask=lengths)
    jax_bf16 = make_jax(precision="bfloat16", quantize=False)(x, attention_mask=lengths)
    jax_f32 = make_jax(precision="highest", quantize=False)(x, attention_mask=lengths)
    gap = np.abs(np.asarray(jax_bf16, np.float32) - jax_f32).max()
    assert port.dtype == np.float32 and port.shape == jax_bf16.shape
    assert gap > 1e-3
    assert np.abs(port - np.asarray(jax_bf16, np.float32)).max() <= gap / 4


def test_bf16_ids_on_the_cpu(narrow, speech):
    """semantic_m and semantic_s give ids under "bfloat16" (and AudioToken
    takes "mixed" for semantic_m)."""
    x, lengths = speech
    ids = narrow["semantic_m"][0](precision="bfloat16")(x, attention_mask=lengths)
    assert ids.shape == (2, 1, 34) and ids.dtype == np.int16
    ids = narrow["semantic_s"][0](precision="bfloat16")(HubertEncoder.host_transform(x),
                                                         attention_mask=lengths)
    assert ids.shape == (2, 1, 34) and ids.dtype == np.int16
    at = port_api.AudioToken(port_api.Tokenizers.semantic_m, weights="random", device="cpu",
                             precision="mixed")
    at.model_config = Wav2VecBertConfig(output_layer=2)
    assert at.encode(x[:1]).shape == (1, 1, 34)
    assert at.encoder.policy.name == "high"


# --- buckets -------------------------------------------------------------------


@pytest.mark.parametrize("tok", ["semantic_m", "semantic_s"])
def test_buckets_semantic(narrow, speech, tok):
    x, lengths = speech
    if tok == "semantic_s":
        x = HubertEncoder.host_transform(x)
    grid = (12_800, 19_200)
    make_port, make_jax = narrow[tok]
    port, ref = make_port(buckets=grid), make_jax(buckets=grid)
    assert port.buckets == grid
    dev_ids, n = port.dispatch(x, attention_mask=lengths)
    jax_ids, jax_n = ref.dispatch(x, attention_mask=lengths)
    assert n == jax_n and tuple(dev_ids.shape) == np.asarray(jax_ids).shape
    # padded to 12,800 samples, not to the default grid's 16,000
    assert dev_ids.shape[-1] == (40 if tok == "semantic_m" else 39)
    np.testing.assert_array_equal(dev_ids.numpy(), np.asarray(jax_ids))
    assert make_port().buckets == port_encoders.default_buckets(SR, 320)


def test_buckets_acoustic():
    x = (np.random.default_rng(5).standard_normal((1, 5000)) * 0.2).astype(np.float32)
    grid = (6400, 9600)
    port = AcousticEncoder(weights="random", device="cpu", buckets=grid)
    codes, n = port.dispatch(x)
    assert n == 16 and codes.shape[-1] == 6400 // 320
    ref = JaxAcousticEncoder(weights="random", buckets=grid)
    jax_codes, jax_n = ref.dispatch(x)
    assert jax_n == n and np.asarray(jax_codes).shape == tuple(codes.shape)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jax_codes))


# --- refusals ------------------------------------------------------------------


@pytest.mark.parametrize("cls", [AcousticEncoder, HubertEncoder])
def test_mixed_is_semantic_m_only(cls):
    with pytest.raises(ValueError, match="unknown precision policy 'mixed'") as port_err:
        cls(weights="random", device="cpu", precision="mixed")
    with pytest.raises(ValueError) as jax_err:
        jax_precision.get_policy("mixed")
    assert str(port_err.value).split(";")[0] == str(jax_err.value).split(";")[0]


def test_unknown_stage():
    with pytest.raises(ValueError, match="unknown precision stage 'attn'"):
        port_precision.StagePrecision("high", {"attn": "highest"})
    # refused before the weights are drawn
    with pytest.raises(ValueError, match="unknown precision stage"):
        Wav2VecBertEncoder(weights="random", device="cpu", precision="mixed",
                           stage_overrides={"ffn": "high"})
    with pytest.raises(ValueError, match="unknown precision policy"):
        port_precision.StagePrecision("high", {"vq": "fast"})


class _Reached(Exception):
    pass


@pytest.mark.parametrize("tok,cmd", [("acoustic", "tokenize"), ("semantic_s", "tokenize"),
                                     ("semantic_s", "bench"), ("semantic_m", "detokenize")])
def test_cli_refuses_mixed(monkeypatch, tmp_path, tok, cmd):
    """Refused by the argument parser, before an AudioToken is made."""
    def reached(*a, **kw):
        raise _Reached

    monkeypatch.setattr(port_api.AudioToken, "__init__", reached)
    argv = [cmd, "--tokenizer", tok, "--precision", "mixed", "--device", "cpu"]
    if cmd != "bench":
        argv += ["--indir", str(tmp_path), "--outdir", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    # semantic_m encode takes it
    monkeypatch.setattr(port_api.AudioToken, "__init__", reached)
    with pytest.raises(_Reached):
        cli.main(["tokenize", "--tokenizer", "semantic_m", "--precision", "mixed",
                  "--device", "cpu", "--indir", str(tmp_path), "--outdir", str(tmp_path)])
