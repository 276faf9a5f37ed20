"""The port's checkpoint converters, weight store, safetensors reader,
manifests, ``weights="artifacts"``, ``cli.py convert`` and
``scripts/convert_real_torch.py`` against the JAX package's, on the CPU.

State dicts are built here from ``transformers`` models at small widths
(full depth where a getter converts at the default configuration) or drawn
with ``np.random.default_rng``; the tests that build a ``transformers``
model skip where that package is missing, the others run. Every converted tree must equal the JAX
converter's bit for bit. The hub route is patched to raise in every test
that resolves ``"artifacts"``, so that none reaches the network.
"""

import os
import sys

import numpy as np
import pytest
import torch

from audiotoken_tpu import cli as jax_cli  # noqa: E402
from audiotoken_tpu.convert import bark as jax_bark  # noqa: E402
from audiotoken_tpu.convert import encodec as jax_encodec  # noqa: E402
from audiotoken_tpu.convert import gpt as jax_gpt  # noqa: E402
from audiotoken_tpu.convert import hubert as jax_hubert  # noqa: E402
from audiotoken_tpu.convert import quantizers as jax_quantizers  # noqa: E402
from audiotoken_tpu.convert import w2vbert as jax_w2vbert  # noqa: E402
from audiotoken_tpu.convert.manifest import load_manifests as jax_load_manifests  # noqa: E402
from audiotoken_tpu.convert.store import load_params as jax_load_params  # noqa: E402
from audiotoken_tpu.convert.store import save_params as jax_save_params  # noqa: E402
from audiotoken_tpu.nn.bark_fine import BarkFineConfig as JaxBarkFineConfig  # noqa: E402
from audiotoken_tpu.nn.conformer import W2VBertConfig as JaxW2VBertConfig  # noqa: E402
from audiotoken_tpu.nn.gpt import GPTConfig as JaxGPTConfig  # noqa: E402
from audiotoken_tpu.nn.hubert import HubertConfig as JaxHubertConfig  # noqa: E402
from audiotoken_tpu.weights import _load_torch_sd as jax_load_torch_sd  # noqa: E402
from audiotoken_tpu_torch import cli  # noqa: E402
from audiotoken_tpu_torch import weights  # noqa: E402
from audiotoken_tpu_torch.convert import bark, encodec, gpt, hubert, quantizers, w2vbert  # noqa: E402
from audiotoken_tpu_torch.convert.checkpoints import STORE, load_torch_sd, source  # noqa: E402
from audiotoken_tpu_torch.convert.manifest import (  # noqa: E402
    MANIFESTS_PATH,
    generate_manifests,
    load_manifests,
    validate_tree,
)
from audiotoken_tpu_torch.convert.safetensors import load_file  # noqa: E402
from audiotoken_tpu_torch.convert.store import (  # noqa: E402
    load_params,
    save_params,
    state_dict_to_numpy,
)
from audiotoken_tpu_torch.nn.bark_fine import BarkFineConfig  # noqa: E402
from audiotoken_tpu_torch.nn.conformer import W2VBertConfig  # noqa: E402
from audiotoken_tpu_torch.nn.gpt import GPTConfig  # noqa: E402
from audiotoken_tpu_torch.nn.hubert import HubertConfig  # noqa: E402
from test_torch_offline import offline as go_offline  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TINY_HUBERT = dict(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                   conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                   conv_stride=(5, 2, 2, 2, 2, 2, 2), num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)
TINY_W2V = dict(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                feature_projection_input_dim=160, left_max_position_embeddings=8,
                right_max_position_embeddings=4, conv_depthwise_kernel_size=7)
TINY_GPT = dict(block_size=16, vocab_size=48, n_embd=16, n_head=2)
TINY_BARK = dict(block_size=16, vocab_size=40, n_head=2, n_embd=16, n_codes_total=8,
                 n_codes_given=1)


def assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


# --- state dicts in every naming --------------------------------------------


def _encodec_hf():
    pytest.importorskip("transformers")
    from transformers import EncodecConfig, EncodecModel

    torch.manual_seed(0)
    m = EncodecModel(EncodecConfig())
    with torch.no_grad():
        for layer in m.quantizer.layers:
            layer.codebook.embed.normal_(0.0, 1.0)
    return m.state_dict()


def _encodec_package_naming(hf_sd):
    """facebookresearch/encodec keys for the HF ones (the walk of
    tests/test_convert_namings.py)."""
    from audiotoken_tpu_torch.nn.seanet import SeanetConfig

    cfg = SeanetConfig()
    up_idx, idx = set(), 2
    for _ratio in cfg.ratios:
        idx += 1
        up_idx.add(idx)
        idx += 1 + cfg.num_residual_layers

    def key(k):
        k = k.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        if k.startswith("quantizer.layers."):
            return k.replace("quantizer.layers.", "quantizer.vq.layers.").replace(
                ".codebook.", "._codebook.")
        for stack in ("encoder", "decoder"):
            pre = f"{stack}.layers."
            if k.startswith(pre):
                rest = k[len(pre):]
                k = f"{stack}.model.{rest}"
                if stack == "decoder" and int(rest.split(".")[0]) in up_idx:
                    return k.replace(".conv.", ".convtr.convtr.", 1)
                return k.replace(".conv.", ".conv.conv.", 1)
        return k

    return {key(k): v for k, v in hf_sd.items()}


def _hubert_hf(n_layers):
    pytest.importorskip("transformers")
    from transformers import HubertConfig as HFConfig
    from transformers import HubertModel

    torch.manual_seed(1)
    cfg = HFConfig(**{k: list(v) if isinstance(v, tuple) else v for k, v in TINY_HUBERT.items()},
                   num_hidden_layers=n_layers, conv_bias=False, feat_extract_norm="group",
                   do_stable_layer_norm=False)
    return HubertModel(cfg).state_dict()


def _w2vbert_hf(n_layers):
    pytest.importorskip("transformers")
    from transformers import Wav2Vec2BertConfig as HFConfig
    from transformers import Wav2Vec2BertModel

    torch.manual_seed(2)
    cfg = HFConfig(**TINY_W2V, num_hidden_layers=n_layers,
                   position_embeddings_type="relative_key", add_adapter=False)
    return Wav2Vec2BertModel(cfg).state_dict()


def _gpt_namings(n_layer):
    """(nanoGPT state dict with the _orig_mod. prefix, HF GPT-2 state dict)."""
    pytest.importorskip("transformers")
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(3)
    hf = GPT2LMHeadModel(GPT2Config(n_layer=n_layer, n_head=TINY_GPT["n_head"],
                                    n_embd=TINY_GPT["n_embd"],
                                    n_positions=TINY_GPT["block_size"],
                                    vocab_size=TINY_GPT["vocab_size"]))
    hf_sd = state_dict_to_numpy(hf.state_dict())
    nano = {}
    for k, v in hf_sd.items():
        if k.startswith("lm_head.") or k.endswith((".attn.bias", ".attn.masked_bias")):
            continue  # nanoGPT ties lm_head and keeps no mask buffers
        if any(s in k for s in ("c_attn.weight", "c_proj.weight", "c_fc.weight")):
            v = np.ascontiguousarray(v.T)  # Conv1D [in, out] -> Linear [out, in]
        nano["_orig_mod." + k] = v
    return nano, hf_sd


def _bark_namings(n_layer):
    """(suno FineGPT state dict with the _orig_mod. prefix, HF BarkFineModel's)."""
    pytest.importorskip("transformers")
    from transformers import BarkFineConfig as HFCfg
    from transformers.models.bark.modeling_bark import BarkFineModel

    torch.manual_seed(4)
    hf = BarkFineModel(HFCfg(
        block_size=TINY_BARK["block_size"], input_vocab_size=TINY_BARK["vocab_size"],
        output_vocab_size=TINY_BARK["vocab_size"], num_layers=n_layer,
        num_heads=TINY_BARK["n_head"], hidden_size=TINY_BARK["n_embd"],
        n_codes_total=8, n_codes_given=1, dropout=0.0, bias=False))
    hf_sd = state_dict_to_numpy(hf.state_dict())
    rename = [("input_embeds_layers.", "transformer.wtes."),
              ("position_embeds_layer.", "transformer.wpe."),
              ("layernorm_final.", "transformer.ln_f."), (".layernorm_1.", ".ln_1."),
              (".layernorm_2.", ".ln_2."), (".attn.att_proj.", ".attn.c_attn."),
              (".attn.out_proj.", ".attn.c_proj."), (".mlp.in_proj.", ".mlp.c_fc."),
              (".mlp.out_proj.", ".mlp.c_proj.")]

    def key(k):
        for old, new in rename:
            k = k.replace(old, new)
        return "transformer.h." + k[len("layers."):] if k.startswith("layers.") else k

    return {"_orig_mod." + key(k): v for k, v in hf_sd.items()}, hf_sd


# --- each converter against the JAX converter --------------------------------


@pytest.fixture(scope="module")
def encodec_sd():
    return state_dict_to_numpy(_encodec_hf())


@pytest.mark.parametrize("naming", ["hf", "package"])
def test_encodec_converter_matches_jax(encodec_sd, naming):
    sd = encodec_sd if naming == "hf" else _encodec_package_naming(encodec_sd)
    if naming == "package":
        assert any(".convtr.convtr." in k for k in sd) and any("._codebook." in k for k in sd)
    tree = encodec.convert_encodec(sd)
    assert_tree_equal(tree, jax_encodec.convert_encodec(sd))
    validate_tree(tree, "acoustic")


def test_encodec_namings_convert_identically(encodec_sd):
    assert_tree_equal(encodec.convert_encodec(_encodec_package_naming(encodec_sd)),
                      encodec.convert_encodec(encodec_sd))


def test_fold_weight_norm_matches_jax():
    from audiotoken_tpu.ops.conv import fold_weight_norm as jax_fold

    rng = np.random.default_rng(5)
    g, v = rng.standard_normal((8, 1, 1)), rng.standard_normal((8, 4, 7)).astype(np.float32)
    out = encodec.fold_weight_norm(g, v)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jax_fold(g, v))


def test_hubert_converter_matches_jax():
    sd = state_dict_to_numpy(_hubert_hf(2))
    tree = hubert.convert_hubert(sd, HubertConfig(**TINY_HUBERT, num_hidden_layers=2))
    assert_tree_equal(tree, jax_hubert.convert_hubert(
        sd, JaxHubertConfig(**TINY_HUBERT, num_hidden_layers=2)))


def test_w2vbert_converter_matches_jax():
    sd = state_dict_to_numpy(_w2vbert_hf(2))
    tree = w2vbert.convert_w2vbert(sd, W2VBertConfig(**TINY_W2V, num_hidden_layers=2))
    assert_tree_equal(tree, jax_w2vbert.convert_w2vbert(
        sd, JaxW2VBertConfig(**TINY_W2V, num_hidden_layers=2)))


@pytest.mark.parametrize("bias", [True, False])
def test_gpt_converter_matches_jax(bias):
    nano, hf_sd = _gpt_namings(2)
    if not bias:  # nanoGPT's bias=False: no linear or LayerNorm biases
        nano = {k: v for k, v in nano.items() if not k.endswith(".bias")}
    cfg, jcfg = GPTConfig(**TINY_GPT, n_layer=2), JaxGPTConfig(**TINY_GPT, n_layer=2)
    tree = gpt.convert_gpt(nano, cfg)
    assert_tree_equal(tree, jax_gpt.convert_gpt(nano, jcfg))
    assert "_orig_mod." not in str(tree.keys())
    if bias:
        assert_tree_equal(gpt.convert_gpt(hf_sd, cfg, hf_conv1d=True), tree)
        assert_tree_equal(gpt.convert_gpt(hf_sd, cfg, hf_conv1d=True),
                          jax_gpt.convert_gpt(hf_sd, jcfg, hf_conv1d=True))
    else:
        assert tree["layers"][0]["attn"]["qkv"]["bias"] is None
        assert tree["ln_f"]["bias"] is None


def test_bark_converters_match_jax():
    suno, hf_sd = _bark_namings(2)
    cfg, jcfg = BarkFineConfig(**TINY_BARK, n_layer=2), JaxBarkFineConfig(**TINY_BARK, n_layer=2)
    tree = bark.convert_bark_fine(suno, cfg)
    assert_tree_equal(tree, jax_bark.convert_bark_fine(suno, jcfg))
    assert_tree_equal(bark.convert_bark_fine_hf(hf_sd, cfg),
                      jax_bark.convert_bark_fine_hf(hf_sd, jcfg))
    assert_tree_equal(bark.convert_bark_fine_hf(hf_sd, cfg), tree)
    # convert_bark_fine takes the HF naming too (the hub route's)
    assert_tree_equal(bark.convert_bark_fine(hf_sd, cfg), tree)
    # without the compile prefix too
    plain = {k[len("_orig_mod."):]: v for k, v in suno.items()}
    assert_tree_equal(bark.convert_bark_fine(plain, cfg), tree)


class _Centers:
    def __init__(self, c):
        self.cluster_centers_ = c


def test_convert_kmeans_object_and_joblib_path(tmp_path):
    joblib = pytest.importorskip("joblib")
    centers = np.random.default_rng(6).standard_normal((10, 4))
    out = quantizers.convert_kmeans(_Centers(centers))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jax_quantizers.convert_kmeans(_Centers(centers)))
    sklearn_cluster = pytest.importorskip("sklearn.cluster")
    km = sklearn_cluster.KMeans(n_clusters=3, n_init=1, random_state=0).fit(centers)
    path = str(tmp_path / "km.bin")
    joblib.dump(km, path)
    np.testing.assert_array_equal(quantizers.convert_kmeans(path),
                                  jax_quantizers.convert_kmeans(path))


def test_convert_kmeans_path_without_joblib_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "joblib", None)
    with pytest.raises(ImportError, match="joblib"):
        quantizers.convert_kmeans(str(tmp_path / "km.bin"))


@pytest.mark.parametrize("key", ["_codebook.embed", "codebook.embed", "embed"])
@pytest.mark.parametrize("heads", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_convert_vq_matches_jax(key, heads, as_tensor):
    embed = np.random.default_rng(7).standard_normal((1, 16, 8) if heads else (16, 8))
    sd = {key: torch.from_numpy(embed) if as_tensor else embed, "other": np.zeros(3)}
    out = quantizers.convert_vq(sd)
    assert out.shape == (16, 8) and out.dtype == np.float32
    np.testing.assert_array_equal(out, jax_quantizers.convert_vq(sd))


def test_convert_vq_without_codebook_raises():
    with pytest.raises(KeyError, match="no codebook key"):
        quantizers.convert_vq({"weight": np.zeros(3)})


# --- the store and the safetensors reader ------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32), "bias": None},
            "layers": [{"w": rng.standard_normal(5).astype(np.float32), "b": None},
                       {"w": np.arange(4, dtype=np.int32), "b": np.float32(2.5)}],
            "codebooks": rng.standard_normal((2, 3, 2)).astype(np.float32)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_round_trip_between_packages(tmp_path, writer):
    tree = _tree(8)
    path = str(tmp_path / "t.npz")
    (save_params if writer == "port" else jax_save_params)(path, tree)
    other = jax_load_params if writer == "port" else load_params
    got = other(path)
    assert_tree_equal(got, load_params(path))
    assert_tree_equal(got["a"], tree["a"])
    assert got["layers"][0]["b"] is None and isinstance(got["layers"], list)
    np.testing.assert_array_equal(got["codebooks"], tree["codebooks"])


def test_store_writes_what_jax_writes(tmp_path):
    tree = _tree(9)
    save_params(str(tmp_path / "port.npz"), tree)
    jax_save_params(str(tmp_path / "jax.npz"), tree)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def test_store_takes_cpu_tensors(tmp_path):
    save_params(str(tmp_path / "t.npz"), {"w": torch.arange(6.0).reshape(2, 3)})
    np.testing.assert_array_equal(load_params(str(tmp_path / "t.npz"))["w"],
                                  np.arange(6.0, dtype=np.float32).reshape(2, 3))


def test_state_dict_to_numpy_widens_bf16():
    w = torch.randn(4, 3).to(torch.bfloat16)
    out = state_dict_to_numpy({"w": w, "n": np.ones(2)})
    assert out["w"].dtype == np.float32
    np.testing.assert_array_equal(out["w"], w.float().numpy())


def test_safetensors_reader_matches_package(tmp_path):
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(10)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((7,)).astype(np.float16),
              "i64": rng.integers(-9, 9, (2, 2)).astype(np.int64),
              "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
              "scalar": np.asarray(1.5, np.float32)}
    path = str(tmp_path / "a.safetensors")
    st_numpy.save_file(arrays, path, metadata={"format": "np"})
    got, ref = load_file(path), st_numpy.load_file(path)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k])
    bf = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)).to(torch.bfloat16)
    path = str(tmp_path / "b.safetensors")
    st_torch.save_file({"bf16": bf, "f32": torch.ones(2)}, path)
    got = load_file(path)
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["bf16"], bf.float().numpy())
    np.testing.assert_array_equal(got["f32"], np.ones(2, np.float32))


def test_safetensors_reader_refuses_bad_files(tmp_path):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(b"\x01")
    with pytest.raises(ValueError, match="not a safetensors file"):
        load_file(str(path))
    header = b'{"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}'
    path.write_bytes(len(header).to_bytes(8, "little") + header + b"\x00" * 8)
    with pytest.raises(ValueError, match="outside"):
        load_file(str(path))


# --- manifests ---------------------------------------------------------------


def test_manifests_equal_jax_and_generated():
    committed = load_manifests()
    assert committed == jax_load_manifests()
    assert set(committed) == {"acoustic", "hubert", "hubert_kmeans", "w2vbert", "w2vbert_vq",
                              "gpt_semantic_s_en", "gpt_semantic_m_hi", "bark_fine"}
    generated = generate_manifests()  # the full-width random trees, one at a time
    for name in committed:
        assert generated[name] == committed[name], f"{MANIFESTS_PATH} is stale for {name}"


@pytest.mark.parametrize("fault,match", [
    ("shape", "mismatch at codebooks"), ("missing", "missing key: codebooks"),
    ("extra", "unexpected key: surprise"), ("dtype", "mismatch at codebooks")])
def test_validate_tree_reports(fault, match):
    tree = weights.get_acoustic_params("random", 0)
    validate_tree(tree, "acoustic")
    if fault == "shape":
        tree["codebooks"] = np.zeros((3, 4), np.float32)
    elif fault == "missing":
        del tree["codebooks"]
    elif fault == "extra":
        tree["surprise"] = np.zeros(1, np.float32)
    else:
        tree["codebooks"] = tree["codebooks"].astype(np.float64)
    with pytest.raises(ValueError, match=match):
        validate_tree(tree, "acoustic")


# --- weights="artifacts" and the CLI from a staged directory ----------------


def _torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Every upstream checkpoint under the names the lookup knows, at small
    widths and full depth (the getters convert at the default configs),
    with EnCodec at full size. -> (root, {store entry: source path})."""
    pytest.importorskip("transformers")
    save_file = pytest.importorskip("safetensors.torch").save_file

    root = tmp_path_factory.mktemp("staged")
    cm = root / "cmeraki__audiotoken"
    src = {}
    src["acoustic"] = str(root / "encodec_24khz.pt")
    torch.save(_encodec_hf(), src["acoustic"])
    src["hubert"] = str(root / "mhubert_base.safetensors")
    save_file({k: v.contiguous() for k, v in _hubert_hf(12).items()}, src["hubert"])
    joblib = pytest.importorskip("joblib")
    sklearn_cluster = pytest.importorskip("sklearn.cluster")
    km = sklearn_cluster.KMeans(n_clusters=4, n_init=1, random_state=0).fit(
        np.random.default_rng(11).standard_normal((40, 32)))
    src["hubert_kmeans"] = str(root / "mhubert_base_vp_en_es_fr_it3_L11_km1000.bin")
    joblib.dump(km, src["hubert_kmeans"])
    src["w2vbert"] = str(cm / "w2vbert2_l21" / "model.safetensors")
    os.makedirs(os.path.dirname(src["w2vbert"]))
    save_file({k: v.contiguous() for k, v in _w2vbert_hf(21).items()}, src["w2vbert"])
    src["w2vbert_vq"] = str(root / "run4__quantizer__L19_C2048_ckpt8000.pkl")
    torch.save({"_codebook.embed": torch.randn(1, 16, 32),
                "_codebook.cluster_size": torch.ones(1, 16)}, src["w2vbert_vq"])
    nano, _ = _gpt_namings(12)
    src["gpt_semantic_s_en"] = str(root / "hubert_semantic_acoustic_gpt_en.pt")
    torch.save({"model": _torch_sd(nano), "iter_num": 7}, src["gpt_semantic_s_en"])
    src["gpt_semantic_m_hi"] = str(cm / "semantic_detokenizer" / "semantic_m"
                                   / "w2vbert2_semantic_acoustic_gpt_hi.pt")
    os.makedirs(os.path.dirname(src["gpt_semantic_m_hi"]))
    torch.save(_torch_sd(nano), src["gpt_semantic_m_hi"])
    suno, _ = _bark_namings(24)
    src["bark_fine"] = str(root / "bark_fine.pt")
    torch.save({"model": _torch_sd(suno), "model_args": {"n_layer": 24}}, src["bark_fine"])
    return str(root), src


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """An empty $AUDIOTOKEN_ARTIFACTS and no hub route."""
    go_offline(monkeypatch, tmp_path / "nothing_staged")


@pytest.fixture
def artifacts(staged, monkeypatch):
    go_offline(monkeypatch, staged[0])
    return staged[1]


def test_artifacts_acoustic(artifacts):
    tree = weights.get_acoustic_params("artifacts")
    assert_tree_equal(tree, jax_encodec.convert_encodec(jax_load_torch_sd(artifacts["acoustic"])))
    validate_tree(tree, "acoustic")


def test_artifacts_acoustic_safetensors_first(artifacts, monkeypatch, tmp_path):
    """encodec_24khz.safetensors is looked up before the .pt, and read by
    the port's own reader."""
    save_file = pytest.importorskip("safetensors.torch").save_file

    sd = _encodec_hf()
    with torch.no_grad():
        sd["quantizer.layers.0.codebook.embed"].add_(1.0)
    save_file({k: v.contiguous() for k, v in sd.items()}, str(tmp_path / "encodec_24khz.safetensors"))
    monkeypatch.setenv("AUDIOTOKEN_ARTIFACTS", str(tmp_path))
    tree = weights.get_acoustic_params("artifacts")
    assert_tree_equal(tree, jax_encodec.convert_encodec(state_dict_to_numpy(sd)))


def test_artifacts_hubert(artifacts):
    params, centroids = weights.get_hubert_params("artifacts")
    assert_tree_equal(params, jax_hubert.convert_hubert(jax_load_torch_sd(artifacts["hubert"])))
    np.testing.assert_array_equal(centroids, jax_quantizers.convert_kmeans(artifacts["hubert_kmeans"]))
    assert len(params["layers"]) == 12


def test_artifacts_w2vbert(artifacts):
    params, codebook = weights.get_w2vbert_params("artifacts")
    assert_tree_equal(params, jax_w2vbert.convert_w2vbert(jax_load_torch_sd(artifacts["w2vbert"])))
    np.testing.assert_array_equal(
        codebook, jax_quantizers.convert_vq(torch.load(artifacts["w2vbert_vq"])))
    assert codebook.shape == (16, 32)


@pytest.mark.parametrize("key", ["gpt_semantic_s_en", "gpt_semantic_m_hi"])
def test_artifacts_gpt(artifacts, key):
    params, cfg = weights.get_semantic_gpt_params("artifacts", 0, key, 48)
    assert cfg.vocab_size == 48
    assert_tree_equal(params, jax_gpt.convert_gpt(jax_load_torch_sd(artifacts[key])))


def test_artifacts_bark_fine(artifacts):
    params, _cfg = weights.get_bark_fine_params("artifacts", 0)
    assert_tree_equal(params, jax_bark.convert_bark_fine(jax_load_torch_sd(artifacts["bark_fine"])))


@pytest.mark.parametrize("getter", ["acoustic", "hubert", "bark_fine", "w2vbert", "gpt"])
def test_artifacts_unstaged_raise_without_network(offline, getter):
    with pytest.raises(FileNotFoundError) as e:
        if getter == "acoustic":
            weights.get_acoustic_params("artifacts")
        elif getter == "hubert":
            weights.get_hubert_params("artifacts")
        elif getter == "bark_fine":
            weights.get_bark_fine_params("artifacts", 0)
        elif getter == "w2vbert":
            weights.get_w2vbert_params("artifacts")
        else:
            weights.get_semantic_gpt_params("artifacts", 0, "gpt_semantic_s_en", 53_376)
    assert "AUDIOTOKEN_ARTIFACTS" in str(e.value)
    assert "JAX" not in str(e.value)


def test_load_torch_sd_unwraps_model(tmp_path):
    sd = {"w": torch.ones(2, 2), "b": torch.zeros(2)}
    torch.save({"model": sd, "iter_num": 3}, tmp_path / "a.pt")
    torch.save(sd, tmp_path / "b.th")
    for name in ("a.pt", "b.th"):
        out = load_torch_sd(str(tmp_path / name))
        assert set(out) == {"w", "b"}
        np.testing.assert_array_equal(out["w"], np.ones((2, 2), np.float32))


@pytest.mark.parametrize("name", STORE)
def test_source_finds_every_staged_entry(artifacts, name):
    assert source(name) == artifacts[name]


@pytest.mark.parametrize("model", STORE)
def test_cli_convert_matches_jax_cli(staged, tmp_path, model):
    src = staged[1][model]
    cli.main(["convert", "--model", model, "--src", src, "--out", str(tmp_path / "port")])
    jax_cli.main(["convert", "--model", model, "--src", src, "--out", str(tmp_path / "jax")])
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == [f"{model}.npz"]
    assert_tree_equal(load_params(str(tmp_path / "port" / f"{model}.npz")),
                      jax_load_params(str(tmp_path / "jax" / f"{model}.npz")))


# --- scripts/convert_real_torch.py ------------------------------------------


def test_convert_real_staged_acoustic_converts_others_fail(offline, staged, tmp_path):
    """The full-size EnCodec converts, validates and runs through AudioToken;
    every other entry (not staged) fails with its reason."""
    from scripts.convert_real_torch import convert_all, smoke

    root = tmp_path / "staged"
    root.mkdir()
    os.symlink(staged[1]["acoustic"], root / "encodec_24khz.pt")
    out = tmp_path / "weights"
    results = convert_all(str(root), str(out))
    assert results["acoustic"] == "OK"
    assert sorted(os.listdir(out)) == ["acoustic.npz"]
    assert all(v.startswith("FAILED") for k, v in results.items() if k != "acoustic")
    validate_tree(weights.get_acoustic_params(str(out)), "acoustic")
    assert smoke(str(out), results, device="cpu") == {"acoustic_roundtrip": "OK"}


def test_convert_real_corrupt_file_fails_validation(offline, tmp_path):
    pytest.importorskip("transformers")
    from transformers import EncodecConfig, EncodecModel

    from scripts.convert_real_torch import convert_all

    root = tmp_path / "staged"
    root.mkdir()
    torch.save(EncodecModel(EncodecConfig(codebook_size=512)).state_dict(),
               root / "encodec_24khz.pt")
    results = convert_all(str(root), str(tmp_path / "weights"))
    assert results["acoustic"].startswith("FAILED") and "mismatch at codebooks" in results["acoustic"]
    assert not (tmp_path / "weights" / "acoustic.npz").exists()


def test_convert_real_small_widths_fail_their_manifests(artifacts, tmp_path):
    """The staged small-width trees all resolve and convert, and each fails
    its manifest, not a forward pass."""
    from scripts.convert_real_torch import convert_all

    results = convert_all(os.environ["AUDIOTOKEN_ARTIFACTS"], str(tmp_path / "w"))
    assert results["acoustic"] == "OK"
    for name, status in results.items():
        if name != "acoustic":
            assert "does not match its manifest" in status, (name, status)


# --- chip_smoke.py's EnCodec state-dict builder ------------------------------


def test_chip_smoke_encodec_builder_is_hf_layout_and_inverts_the_converter():
    import chip_smoke

    tree = weights.get_acoustic_params("random", 0)
    sd = chip_smoke.encodec_state_dict(tree)
    ref = _encodec_hf()
    assert sd.keys() == ref.keys()
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    back = encodec.convert_encodec(state_dict_to_numpy(sd))
    assert_tree_equal(back["codebooks"], tree["codebooks"])
    # the refold g * v / ||v|| with g = ||v|| rounded once to f32 moves a
    # weight by at most one ulp
    for path, (a, b) in _pairs(back, tree):
        ulp = np.spacing(np.abs(b).astype(np.float32))
        assert (np.abs(a - b) <= ulp).all(), path


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    elif a is not None:
        yield path, (np.asarray(a), np.asarray(b))


def test_chip_smoke_nanogpt_builder_inverts_the_converter():
    import chip_smoke

    for bias in (False, True):
        cfg = GPTConfig(**TINY_GPT, n_layer=2, bias=bias)
        from audiotoken_tpu_torch.nn.gpt import init_gpt_params

        tree = init_gpt_params(np.random.default_rng(12), cfg)
        sd = chip_smoke.nanogpt_state_dict(tree)
        assert all(k.startswith("_orig_mod.transformer.") for k in sd)
        assert any(k.endswith(".bias") for k in sd) == bias
        assert_tree_equal(gpt.convert_gpt(sd, cfg), tree)
        assert_tree_equal(jax_gpt.convert_gpt(sd, JaxGPTConfig(**TINY_GPT, n_layer=2, bias=bias)),
                          tree)
