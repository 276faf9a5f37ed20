"""The mesh layer of the port (``audiotoken_tpu_torch/parallel/``, the
encoders' ``mesh=``, the tensor-parallel GPT, sampler, trainer and
conformer) against the JAX package, on the CPU over gloo.

The port runs in spawned worlds of 4 ranks (``parallel/launch.py``, the
rank side in ``torch_parallel_workers.py``): one of dp 4 for the encoders
and one of dp 2 x tp 2 for the rest, each started once per module. Every
sharded result is held against the port's world-1 result and against the
JAX package run here, on the 8 virtual CPU devices of ``conftest.py``:

  * make_mesh: JAX's factoring for 1 to 8 devices, its ValueError, the
    refusal without a process group;
  * the shard rules against JAX's PartitionSpecs, ``shard_tree`` and its
    inverse, q, k and v split head-wise and the GLU's halves pair-wise;
  * dp encode for all three tokenizers (acoustic at full width, the
    semantic ones narrow), bit for bit: a batch within ``max_device_batch
    * dp``, one beyond it, and JAX's ValueError on a batch that does not
    split over dp; on the 2-D mesh too, where dp is 2;
  * K4 on a dp x tp shard, bit for bit, rel and no-rel;
  * the tp sampler's greedy rollout equal to JAX's ``GPTSampler``, and
    sampled rollouts the tp ranks agree on;
  * two dp x tp train steps with uneven padding and the clip engaged: the
    loss within 1e-6 relative and the parameters within 1e-5 of JAX
    ``make_train_step(mesh=None)`` (and of the port on one rank, inside the
    world);
  * the tp conformer's features within JAX's own 2e-5;
  * a world whose rank fails while the others wait is killed and reported.
"""

from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import audiotoken_tpu.nn.conformer as jax_conformer_nn
import audiotoken_tpu.nn.hubert as jax_hubert_nn
import audiotoken_tpu.weights as jax_weights
from audiotoken_tpu import encoders as jax_encoders
from audiotoken_tpu.configs import AcousticEncoderConfig as JaxAcousticEncoderConfig
from audiotoken_tpu.configs import HubertEncoderConfig as JaxHubertEncoderConfig
from audiotoken_tpu.configs import Wav2VecBertConfig as JaxWav2VecBertConfig
from audiotoken_tpu.nn.gpt import GPTConfig as JaxGPTConfig
from audiotoken_tpu.nn.gpt import GPTSampler as JaxGPTSampler
from audiotoken_tpu.parallel import shard as jax_shard
from audiotoken_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audiotoken_tpu.runtime import executor as jax_executor
from audiotoken_tpu.train import gpt_train as jax_gpt_train
import torch_parallel_workers as workers
from audiotoken_tpu_torch.api import AudioToken
from audiotoken_tpu_torch.encoders import HubertEncoder
from audiotoken_tpu_torch.io.wavfile import write_wav
from audiotoken_tpu_torch.nn.conformer import W2VBertConfig, W2VBertFeatures, init_w2vbert_params
from audiotoken_tpu_torch.nn.gpt import GPTConfig, init_gpt_params
from audiotoken_tpu_torch.ops.flash_attention import flash_attention_relkey_plain
from audiotoken_tpu_torch.parallel import dryrun, shard
from audiotoken_tpu_torch.parallel.launch import WorldError, run_world
from audiotoken_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from audiotoken_tpu_torch.train.gpt_train import TrainConfig, TrainStep
from audiotoken_tpu_torch.weights import w2vbert_from_numpy

JAX_W2V_CONFIG, JAX_HUBERT_CONFIG = jax_conformer_nn.W2VBertConfig, jax_hubert_nn.HubertConfig
WORLD_TIMEOUT = 240.0  # seconds a world of 4 ranks may take; alone it needs about 20


def _batches():
    """Per tokenizer, (name, audio, lengths): 4 rows (within the bound of
    dp 4 x 1 row), 6 rows (beyond it: a sub-batch of 4, then 2 padded to
    4) and 3 rows (within the bound, not a multiple of dp)."""
    rng = np.random.default_rng(7)
    out = {}
    for tok, n in (("acoustic", 6_000), ("semantic_s", 8_000), ("semantic_m", 8_000)):
        rows = []
        for name, B in (("b4", 4), ("b6", 6), ("b3", 3)):
            audio = (rng.standard_normal((B, n)) * 0.2).astype(np.float32)
            lengths = np.array([n - 700 * (i % 3) for i in range(B)], np.int32)
            for i, m in enumerate(lengths):
                audio[i, m:] = 0.0
            if tok == "semantic_s":
                audio = HubertEncoder.host_transform(audio)
            rows.append((name, audio, None if tok == "acoustic" else lengths))
        out[tok] = rows
    return out


def _conformer_input():
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, 24, 160)).astype(np.float32)
    mask = np.ones((2, 24), np.float32)
    mask[1, 18:] = 0.0
    return feats, mask


@pytest.fixture(scope="module")
def batches():
    return _batches()


@pytest.fixture(scope="module")
def corpus_files(tmp_path_factory):
    """Three short 24 kHz WAVs, for the corpus executor on the dp 4 mesh."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(9)
    files = []
    for i, seconds in enumerate((1.0, 2.5, 0.7)):
        x = (0.25 * rng.standard_normal(int(24_000 * seconds))).clip(-1, 1)
        files.append(str(d / f"c{i}.wav"))
        write_wav(files[-1], (x * 32767).astype(np.int16), 24_000)
    return files


@pytest.fixture(scope="module")
def dp4(batches, corpus_files):
    """Every rank's results of the dp 4 world."""
    return run_world("torch_parallel_workers:dp4_world", 4, (batches, 1, corpus_files),
                     timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def dp2tp2(batches):
    """Every rank's results of the dp 2 x tp 2 world."""
    return run_world("torch_parallel_workers:dp2tp2_world", 4,
                     (*_conformer_input(), batches["acoustic"]), timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def narrow():
    """Both packages' semantic encoders narrow, with the workers' weights;
    -> make(tok, package, mesh) building an encoder."""
    w2v, codebook, hub, centroids = workers.narrow_weights()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_conformer_nn, "W2VBertConfig",
                   lambda **kw: JAX_W2V_CONFIG(**workers.NARROW_W2V, **kw))
        mp.setattr(jax_hubert_nn, "HubertConfig",
                   lambda **kw: JAX_HUBERT_CONFIG(**workers.NARROW_HUBERT, **kw))
        mp.setattr(jax_weights, "get_w2vbert_params", lambda w, s, c: (w2v, codebook))
        mp.setattr(jax_weights, "get_hubert_params", lambda w, s, c: (hub, centroids))
        workers.patch_narrow(mp.setattr)

        def make(tok, package, mesh=None):
            if package == "port":
                return workers.make_encoder(tok, "cpu")
            if tok == "acoustic":
                return jax_encoders.AcousticEncoder(JaxAcousticEncoderConfig(bandwidth=1.5),
                                                    weights="random", mesh=mesh)
            if tok == "semantic_s":
                return jax_encoders.HubertEncoder(JaxHubertEncoderConfig(output_layer=2),
                                                  weights="random", mesh=mesh)
            return jax_encoders.Wav2VecBertEncoder(JaxWav2VecBertConfig(output_layer=2),
                                                   weights="random", mesh=mesh)

        yield make


# --- make_mesh -----------------------------------------------------------------


@pytest.mark.parametrize("axes", [("dp",), ("dp", "tp"), ("dp", "tp", "sp")])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_default_factoring_is_jax(n, axes):
    ref = jax_make_mesh(axes, devices=jax.devices()[:n])
    assert dict(zip(axes, mesh_shape(n, axes))) == dict(ref.shape)


def test_shape_that_does_not_fit_is_a_value_error():
    with pytest.raises(ValueError, match="devices"):
        jax_make_mesh(("dp", "tp"), shape=(3, 2), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="devices"):
        mesh_shape(4, ("dp", "tp"), (3, 2))


def test_make_mesh_refuses_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group.*torchrun"):
        make_mesh(("dp", "tp"), device="cpu")


def test_make_mesh_in_a_world(dp2tp2):
    for r, out in enumerate(dp2tp2):
        facts = out["mesh"]
        assert facts["default"] == {"dp": 1, "tp": 4}  # JAX's factoring of 4
        assert facts["explicit"] == {"dp": 2, "tp": 2}
        assert "(3, 2) != 4 devices" in facts["bad"]
        assert facts["axes"] == {"dp": (2, r // 2), "tp": (2, r % 2)}


def test_a_failed_rank_ends_its_world():
    """A rank that raises while the others wait in a collective: the world
    is killed (the waiting rank may see its peer go first), and the error
    carries the failed rank's traceback."""
    with pytest.raises(WorldError, match="rank [01] failed; killed the rest") as e:
        run_world("torch_parallel_workers:fail_while_others_wait", 2, timeout=60)
    assert "this rank fails on purpose" in str(e.value)


# --- the shard rules -----------------------------------------------------------

GPT_SMALL = dict(block_size=32, vocab_size=128, n_layer=2, n_head=4, n_embd=64, bias=True)


def _gpt_tree():
    return init_gpt_params(np.random.default_rng(3), GPTConfig(**GPT_SMALL))


def _conformer_tree():
    return init_w2vbert_params(np.random.default_rng(0), W2VBertConfig(**workers.TP_W2V))


def _leaves(tree):
    return jax.tree_util.tree_flatten(tree, is_leaf=lambda x: x is None
                                      or isinstance(x, (shard.P, jax.sharding.PartitionSpec)))[0]


@pytest.mark.parametrize("family", ["gpt", "gpt_sampler", "conformer"])
def test_specs_are_jax_rules(family):
    """Each leaf's spec names JAX's axes; ``groups`` is the port's own."""
    if family == "gpt_sampler":  # the JAX sampler's stacked tree
        tree = jax.tree_util.tree_map(np.asarray, JaxGPTSampler(
            JaxGPTConfig(**GPT_SMALL), _gpt_tree()).params)
        ours, ref = shard.gpt_sampler_param_spec(tree), jax_shard.gpt_sampler_param_spec(tree)
    elif family == "gpt":
        tree = _gpt_tree()
        ours, ref = shard.gpt_param_spec(tree), jax_shard.gpt_param_spec(tree)
    else:
        tree = _conformer_tree()
        ours, ref = shard.conformer_param_spec(tree), jax_shard.conformer_param_spec(tree)
    a, b = _leaves(ours), _leaves(ref)
    assert len(a) == len(b) > 10
    assert [x if x is None else tuple(x) for x in a] == [x if x is None else tuple(x) for x in b]
    assert {x.groups for x in a if x is not None} == ({1, 2} if family == "conformer"
                                                     else {1, 3})


@pytest.mark.parametrize("family", ["gpt", "conformer"])
@pytest.mark.parametrize("sizes", [{"dp": 2, "tp": 2}, {"dp": 2, "tp": 4}, {"tp": 4}])
def test_shard_tree_joins_back(family, sizes):
    tree = _gpt_tree() if family == "gpt" else _conformer_tree()
    spec = (shard.gpt_param_spec if family == "gpt" else shard.conformer_param_spec)(tree)
    n = int(np.prod(list(sizes.values())))
    shards = [shard.shard_tree(tree, spec, sizes, r) for r in range(n)]
    back = shard.join_shards(shards, spec, sizes)
    for a, b in zip(_leaves(tree), _leaves(back)):
        np.testing.assert_array_equal(a, b)
    # a dp rank holds what its tp peer at the same index holds
    for a, b in zip(_leaves(shards[0]), _leaves(shards[n // sizes.get("dp", 1)]
                                               if "dp" in sizes else shards[0])):
        np.testing.assert_array_equal(a, b)


def test_qkv_split_head_wise():
    """Rank r's fused qkv holds heads r*H/tp ... of q, of k and of v."""
    tree = _gpt_tree()
    C, nh, tp = 64, 4, 2
    dh = C // nh
    for r in range(tp):
        local = shard.shard_tree(tree, shard.gpt_param_spec(tree), {"tp": tp}, r)
        for key in ("kernel", "bias"):
            full = tree["layers"][1]["attn"]["qkv"][key]
            got = local["layers"][1]["attn"]["qkv"][key]
            assert got.shape[-1] == 3 * C // tp
            heads = slice(r * nh // tp * dh, (r + 1) * nh // tp * dh)
            for j in range(3):  # q, k, v
                np.testing.assert_array_equal(got[..., j * C // tp:(j + 1) * C // tp],
                                              full[..., j * C:(j + 1) * C][..., heads])
        # the row-parallel out-projection holds the same heads' rows
        np.testing.assert_array_equal(local["layers"][1]["attn"]["out"]["kernel"],
                                      tree["layers"][1]["attn"]["out"]["kernel"][heads])
        assert local["wte"].shape == (128 // tp, C)


def test_glu_pairs_split_together():
    """Rank r's pw1 holds channels i and i + H for its own channels i, the
    channels of its depthwise kernel and of its rows of pw2."""
    tree = _conformer_tree()
    H, tp = 64, 4
    for r in range(tp):
        local = shard.shard_tree(tree, shard.conformer_param_spec(tree), {"tp": tp}, r)
        mine = np.arange(r * H // tp, (r + 1) * H // tp)
        conv, lconv = tree["layers"][0]["conv"], local["layers"][0]["conv"]
        np.testing.assert_array_equal(lconv["pw1"]["kernel"],
                                      conv["pw1"]["kernel"][:, np.concatenate([mine, mine + H])])
        np.testing.assert_array_equal(lconv["dw_kernel"], conv["dw_kernel"][..., mine])
        np.testing.assert_array_equal(lconv["pw2"]["kernel"], conv["pw2"]["kernel"][mine])
        np.testing.assert_array_equal(lconv["dw_layer_norm"]["scale"],
                                      conv["dw_layer_norm"]["scale"])


# --- data-parallel encode ------------------------------------------------------


@pytest.mark.parametrize("tok", ["acoustic", "semantic_s", "semantic_m"])
def test_dp_encode_equals_one_rank_and_jax(dp4, batches, narrow, tok):
    jax_enc = narrow(tok, "jax", jax_make_mesh(("dp",), devices=jax.devices()[:4]))
    jax_enc.max_device_batch = 1
    port1 = narrow(tok, "port")
    for name, audio, lengths in batches[tok]:
        got = [out[tok][name] for out in dp4]
        if name == "b3":  # 3 rows within the bound of 4, not a multiple of dp
            assert got == ["ValueError"] * 4
            with pytest.raises(ValueError, match="divisible by 4"):
                jax_enc(audio, attention_mask=lengths)
            continue
        one = port1(audio, attention_mask=lengths)
        ref = np.asarray(jax_enc(audio, attention_mask=lengths))
        assert one.shape == ref.shape == (len(audio),) + one.shape[1:]
        for g in got:  # every rank returns the whole batch
            np.testing.assert_array_equal(g, one)
        np.testing.assert_array_equal(one, ref)
    assert dp4[0][tok]["mesh"] == {"dp": 4}


def _npys(out):
    return {p.name: p.read_bytes() for p in sorted(Path(out).rglob("*.npy"))}


def test_audiotoken_hands_its_mesh_to_the_encoder(dp4, batches, narrow, corpus_files,
                                                   tmp_path):
    """The facade's mesh reaches the encoder, and through it the corpus
    executor: four ranks tokenize the files as one host driving a dp 4
    mesh, rank 0 alone writing, with the tokens of world 1 and of the JAX
    package's executor on its dp 4 mesh; every rank returns the summary."""
    one = narrow("acoustic", "port")(batches["acoustic"][0][1])
    corpus = Path(corpus_files[0]).parent
    for out in dp4:
        assert out["api"]["same_mesh"]
        np.testing.assert_array_equal(out["api"]["b4"], one)
        # a batch size that does not split over dp raises before a file is read
        assert "multiple of 4" in out["api"]["odd_batch"]
        assert out["api"]["corpus"] == dp4[0]["api"]["corpus"]
    assert dp4[0]["api"]["rank0_fails"][0] != "RuntimeError"  # rank 0's own error
    for out in dp4[1:]:
        assert out["api"]["rank0_fails"] == (
            "RuntimeError", "encode_batch_files failed on rank 0 of the mesh")
    summary = dp4[0]["api"]["corpus"]
    assert summary["batches"] == 2 and summary["audio_seconds"] == pytest.approx(4.2)
    assert "mesh_send" in summary["stages"] and "failed_files" not in summary
    for r in (1, 2, 3):  # the other ranks write nothing
        assert not (corpus / f"out_r{r}").exists()
    ours = _npys(corpus / "out_r0")
    assert sorted(ours) == ["c0.npy", "c1.npy", "c2.npy"]
    kw = dict(chunk_size=workers.CORPUS_CHUNK, num_workers=2, audio_files=corpus_files)
    world1 = AudioToken("acoustic", device="cpu", num_codebooks=2, weights="random")
    world1.encode_batch_files(workers.CORPUS_BATCH, tmp_path / "world1", **kw)
    assert _npys(tmp_path / "world1") == ours
    jax_enc = narrow("acoustic", "jax", jax_make_mesh(("dp",), devices=jax.devices()[:4]))
    jax_enc.max_device_batch = 1
    jax_executor.encode_batch_files(jax_enc, JaxAcousticEncoderConfig(bandwidth=1.5),
                                    workers.CORPUS_BATCH, tmp_path / "jax", **kw)
    assert _npys(tmp_path / "jax") == ours
    with pytest.raises(AttributeError, match="Mesh"):
        AudioToken("acoustic", device="cpu", weights="random", mesh=object())


def test_dp_encode_on_a_2d_mesh(dp2tp2, batches, narrow):
    """dp 2 x tp 2: the bound is 1 row x dp 2, so 3 rows run as a
    sub-batch of 2 and one of 1 padded to 2, as in JAX."""
    jax_enc = narrow("acoustic", "jax", jax_make_mesh(("dp",), devices=jax.devices()[:2]))
    jax_enc.max_device_batch = 1
    port1 = narrow("acoustic", "port")
    for name, audio, _ in batches["acoustic"]:
        one = port1(audio)
        np.testing.assert_array_equal(one, np.asarray(jax_enc(audio)))
        for out in dp2tp2:
            np.testing.assert_array_equal(out["encode"][name], one)


# --- K4 on a shard ---------------------------------------------------------------


@pytest.mark.parametrize("form", ["rel", "no-rel"])
def test_k4_on_a_dp_tp_shard(dp2tp2, form):
    """Each rank's block equals that slice of the unsharded plain K4 (the
    ranks checked it against their own unsharded call too)."""
    rng = np.random.default_rng(0)
    B, H, T, dh = 2, 4, 64, 16
    q, k = ((rng.standard_normal((B, H, T, dh)) * 0.3).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    E = (rng.standard_normal((13, dh)) * 0.05).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, T - T // 4:] = 0.0
    ref = flash_attention_relkey_plain(*map(torch.from_numpy, (q, k, v)),
                                       torch.from_numpy(E) if form == "rel" else None,
                                       torch.from_numpy(mask), left=8, right=4).numpy()
    for r, out in enumerate(dp2tp2):
        a = out["attention"]
        assert a["shard"] == [1, 2, T, dh]
        d, t = r // 2, r % 2
        np.testing.assert_array_equal(a[form], ref[d:d + 1, 2 * t:2 * t + 2])


# --- the tp sampler --------------------------------------------------------------


def test_tp_sampler_greedy_equals_jax(dp2tp2):
    cfg = JaxGPTConfig(**workers.SAMPLER_GPT)
    params = init_gpt_params(np.random.default_rng(1), GPTConfig(**workers.SAMPLER_GPT))
    prompts = dp2tp2[0]["sampler"]["prompts"]
    ref = JaxGPTSampler(cfg, params).generate_batch(prompts, max_new_tokens=16, top_k=1, seed=3)
    jmesh = jax_make_mesh(("dp", "tp"), shape=(2, 2), devices=jax.devices()[:4])
    ref_tp = JaxGPTSampler(cfg, params, mesh=jmesh).generate_batch(
        prompts, max_new_tokens=16, top_k=1, seed=3)
    np.testing.assert_array_equal(ref, ref_tp)
    for out in dp2tp2:  # equal to world 1 inside the world, and to JAX here
        np.testing.assert_array_equal(out["sampler"]["greedy"], ref)
        assert out["sampler"]["mesh"] == {"dp": 2, "tp": 2}


def test_tp_sampler_ranks_draw_alike(dp2tp2):
    drawn = [out["sampler"]["drawn"] for out in dp2tp2]
    assert (drawn[0] >= 0).all() and len(np.unique(drawn[0])) > 4
    for d in drawn[1:]:
        np.testing.assert_array_equal(d, drawn[0])


# --- the dp x tp train step ----------------------------------------------------


def test_train_step_dp_tp_equals_jax(dp2tp2):
    """Two steps at lr 1e-4 with grad_clip 0.05: every step's loss within
    1e-6 relative of JAX's and of the port on one rank, the parameters
    joined from the four shards within 1e-5 of JAX's."""
    outs = [o["train"] for o in dp2tp2]
    idx, tgt = outs[0]["batch"]
    params = outs[0]["init"]
    # the dp ranks' rows hold different numbers of valid targets
    counts = [(tgt[2 * d:2 * d + 2] >= 0).sum() for d in range(2)]
    assert counts[0] != counts[1]
    cfg = dryrun.tiny_gpt_config(2, "cpu")
    jcfg = JaxGPTConfig(**{k: getattr(cfg, k) for k in
                           ("block_size", "vocab_size", "n_layer", "n_head", "n_embd", "bias")})
    step = jax_gpt_train.make_train_step(jcfg, jax_gpt_train.TrainConfig(
        learning_rate=dryrun.TRAIN_LR, grad_clip=dryrun.TRAIN_CLIP))
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    opt_state = step.optimizer.init(jparams)
    tc = TrainConfig(learning_rate=dryrun.TRAIN_LR, grad_clip=dryrun.TRAIN_CLIP)
    port1 = TrainStep(cfg, tc, params=params, device="cpu", precision="highest")
    for i in range(dryrun.TRAIN_STEPS):
        grads = jax.grad(jax_gpt_train._loss_fn)(jparams, idx, tgt, jcfg, None)
        assert float(optax.global_norm(grads)) > dryrun.TRAIN_CLIP  # the clip engages
        jparams, opt_state, loss = step(jparams, opt_state, idx, tgt)
        one = float(port1.step(idx, tgt))
        for o in outs:
            assert o["losses"][i] == pytest.approx(float(loss), rel=1e-6)
            assert o["losses"][i] == pytest.approx(one, rel=1e-6)
    spec = shard.gpt_param_spec(params)
    joined = shard.join_shards([o["params"] for o in outs], spec, {"dp": 2, "tp": 2})
    for a, b in zip(_leaves(joined), _leaves(jax.tree_util.tree_map(np.asarray, jparams))):
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert max(o["param_err"] for o in outs) <= 1e-5


def test_tp_gpt_adds_row_parallel_biases_once(dp2tp2):
    """A GPT with random biases: the tp forward's and decode step's logits,
    the greedy rollout and the loss equal the whole model's on each rank."""
    for out in dp2tp2:
        b = out["biases"]
        assert b["logit_err"] <= 1e-5 and b["step_err"] <= 1e-5
        np.testing.assert_array_equal(b["greedy"][1], b["greedy"][0])
        assert b["losses"][1] == pytest.approx(b["losses"][0], rel=1e-6)


def test_train_step_refuses_what_is_not_a_mesh():
    with pytest.raises(AttributeError, match="Mesh"):
        TrainStep(GPTConfig(**GPT_SMALL), mesh="dp", device="cpu")


# --- the tp conformer --------------------------------------------------------------


def test_tp_conformer_features(dp2tp2):
    """The biases are random, so a row-parallel bias added once a rank
    would show."""
    feats, mask = _conformer_input()
    jcfg = JAX_W2V_CONFIG(**workers.TP_W2V)
    params = workers.with_biases(
        jax_conformer_nn.init_w2vbert_params(np.random.default_rng(0), jcfg), 1)
    ref = np.asarray(jax_conformer_nn.w2vbert_features(params, feats, mask, jcfg,
                                                       output_layer=2))
    cfg = W2VBertConfig(**workers.TP_W2V)
    with torch.device("meta"):
        model = W2VBertFeatures(cfg, 2)
    model.load_state_dict(w2vbert_from_numpy(workers.with_biases(
        init_w2vbert_params(np.random.default_rng(0), cfg), 1), 2), assign=True)
    with torch.inference_mode():
        one = model.eval()(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(one, ref, atol=2e-5)
    got = np.zeros_like(ref)
    for out in dp2tp2:
        c = out["conformer"]
        assert c["pw1_shape"] == (2 * 64 // 2, 64)  # both GLU halves of 32 channels
        lo, hi = c["rows"]
        if c["tp_index"]:
            np.testing.assert_array_equal(c["features"], got[lo:hi])  # tp ranks agree
        got[lo:hi] = c["features"]
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, one, atol=2e-5)
