"""The port's training tools against the JAX package's, on the CPU:
``EMAVQTrainer``, ``minibatch_kmeans_step``, ``train_quantizer`` (with the
HuBERT encoder of both packages cut to a small width), ``cluster_diagnostics``,
``gpt_loss``, ``expand_vocab`` and the GPT's ``TrainStep``.

Inputs come from ``np.random.default_rng`` with fixed seeds. Both packages
compute in IEEE f32 on the CPU, summing in other orders, so states agree
to about 1e-6 of their scale; each test states its tolerance.
"""

import inspect
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from audiotoken_tpu import configs as jax_configs
from audiotoken_tpu import weights as jax_weights
from audiotoken_tpu.nn import hubert as jax_hubert_nn
from audiotoken_tpu.nn.gpt import GPTConfig as JaxGPTConfig
from audiotoken_tpu.nn.gpt import expand_vocab as jax_expand_vocab
from audiotoken_tpu.nn.gpt import gpt_loss as jax_gpt_loss
from audiotoken_tpu.train import cluster_diagnostics as jax_diag
from audiotoken_tpu.train import gpt_train as jax_gpt_train
from audiotoken_tpu.train import vq_train as jax_vq
from audiotoken_tpu_torch import encoders as port_encoders
from audiotoken_tpu_torch.io.dataset import AudioSegmentStream, batched_segments
from audiotoken_tpu_torch.io.wavfile import write_wav
from audiotoken_tpu_torch.nn.gpt import GPT, GPTConfig, expand_vocab, gpt_loss, init_gpt_params
from audiotoken_tpu_torch.nn.hubert import HubertConfig, init_hubert_params
from audiotoken_tpu_torch.train import cluster_diagnostics as diag
from audiotoken_tpu_torch.train.gpt_train import (
    TrainConfig,
    TrainStep,
    clip_by_global_norm,
    make_optimizer,
)
from audiotoken_tpu_torch.train.vq_train import (
    EMAVQTrainer,
    VQTrainConfig,
    minibatch_kmeans_step,
    train_quantizer,
)
from audiotoken_tpu_torch.weights import gpt_from_numpy, gpt_to_numpy

# f32 states of the two packages: the same operations, sums in other orders
REL = 1e-5


def _assert_close(a, b, rel=REL, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} x {scale}"


def _clusters(seed, n, dim, k=8, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)).astype(np.float32) * 10
    idx = rng.integers(0, k, size=n)
    return centers[idx] + spread * rng.standard_normal((n, dim)).astype(np.float32)


# --- EMA VQ ------------------------------------------------------------------


def _pair(cfg, seed=0):
    return EMAVQTrainer(cfg, seed=seed, device="cpu"), jax_vq.EMAVQTrainer(cfg, seed=seed)


def _assert_states_close(port, ref):
    for name, a, b in zip(("codebook", "cluster_size", "embed_avg"), port.state, ref.state):
        _assert_close(a.numpy(), b, what=name)
    assert port.steps == ref.steps


def test_ema_trainer_random_init_matches_jax():
    port, ref = _pair(VQTrainConfig(codebook_size=16, dim=6), seed=3)
    np.testing.assert_array_equal(port.codebook, np.asarray(ref.codebook))


@pytest.mark.parametrize("n", [40, 512])  # fewer and more vectors than codes
def test_ema_update_matches_jax(n):
    cfg = VQTrainConfig(codebook_size=64, dim=8)
    port, ref = _pair(cfg)
    for step in range(4):
        x = _clusters(10 + step, n, 8)
        m_port, m_ref = port.update(x), ref.update(x)
        _assert_states_close(port, ref)
        assert m_port["active_frac"] == pytest.approx(m_ref["active_frac"], abs=0)
        assert m_port["commit_loss"] == pytest.approx(m_ref["commit_loss"], rel=1e-4, abs=1e-6)


def test_ema_init_from_batch_takes_the_same_rows():
    cfg = VQTrainConfig(codebook_size=32, dim=4)
    port, ref = _pair(cfg)
    x = _clusters(20, 100, 4)
    port.init_from_batch(x)
    ref.init_from_batch(x)
    np.testing.assert_array_equal(port.codebook, np.asarray(ref.codebook))
    np.testing.assert_array_equal(port.state[2].numpy(), np.asarray(ref.state[2]))


def test_ema_dead_code_replacement_matches_jax():
    """8 clusters, 32 codes: most codes die, and each replacement draws the
    same batch rows in both packages."""
    cfg = VQTrainConfig(codebook_size=32, dim=4, decay=0.8, threshold_ema_dead_code=0.5)
    port, ref = _pair(cfg)
    for step in range(6):
        x = _clusters(30 + step, 256, 4)
        port.update(x)
        ref.update(x)
        _assert_states_close(port, ref)
    assert (port.state[1].numpy() >= 0.5 * 0.8 - 1e-6).sum() > 8  # codes were replaced


def test_ema_converges_to_clusters():
    """8 well-separated gaussians, the draw of the JAX package's own test:
    every centre ends within 1 of a code, in both packages."""
    rng = np.random.default_rng(1234)
    cfg = VQTrainConfig(codebook_size=8, dim=4, threshold_ema_dead_code=0.5)
    port, ref = _pair(cfg)
    centers = rng.standard_normal((8, 4)).astype(np.float32) * 10
    for _ in range(60):
        idx = rng.integers(0, 8, size=512)
        x = centers[idx] + 0.05 * rng.standard_normal((512, 4)).astype(np.float32)
        metrics = port.update(x)
        ref.update(x)
    assert metrics["commit_loss"] < 0.5 and metrics["active_frac"] >= 0.9
    d = np.linalg.norm(centers[:, None] - port.codebook[None], axis=-1)
    assert (d.min(axis=1) < 1.0).all()
    _assert_states_close(port, ref)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ema_save_load_resume_between_packages(tmp_path, writer):
    cfg = VQTrainConfig(codebook_size=16, dim=4)
    port, ref = _pair(cfg)
    x1, x2 = _clusters(50, 128, 4), _clusters(51, 128, 4)
    port.update(x1)
    ref.update(x1)
    path = str(tmp_path / "state.npz")
    (port if writer == "port" else ref).save(path)
    with np.load(path) as z:
        assert sorted(z.files) == ["cluster_size", "codebook", "embed_avg", "steps"]
    port2, ref2 = _pair(cfg, seed=9)
    port2.load(path)
    ref2.load(path)
    assert port2.steps == ref2.steps == 1
    np.testing.assert_array_equal(port2.codebook, np.asarray(ref2.codebook))
    port2.update(x2)
    ref2.update(x2)
    _assert_states_close(port2, ref2)


def test_minibatch_kmeans_step_matches_jax():
    k, d = 6, 3
    rng = np.random.default_rng(60)
    c0 = rng.standard_normal((k, d)).astype(np.float32) * 5
    c_port, n_port = torch.from_numpy(c0), torch.zeros(k)
    c_ref, n_ref = jax.numpy.asarray(c0), jax.numpy.zeros((k,))
    for step in range(5):
        x = _clusters(61 + step, 200, d, k=4)
        c_port, n_port, i_port = minibatch_kmeans_step(c_port, n_port, torch.from_numpy(x), k)
        c_ref, n_ref, i_ref = jax_vq.minibatch_kmeans_step(c_ref, n_ref, x, k)
        np.testing.assert_array_equal(n_port.numpy(), np.asarray(n_ref))
        _assert_close(c_port.numpy(), c_ref, what="centroids")
        assert float(i_port) == pytest.approx(float(i_ref), rel=1e-4)


# --- train_quantizer over a tiny corpus in both packages --------------------

# HuBERT at its real width (768: train_quantizer's codebook dimension) with a
# narrow front and FFN, so a CPU run takes seconds
SMALL_HUBERT = dict(intermediate_size=256, conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                    num_conv_pos_embedding_groups=4)
CORPUS_SECONDS = (1.5, 3.2, 2.7, 5.1, 0.9, 4.4)
# 2 s segments two a batch: updates after the 2nd and 5th batches; the 6th
# (the last file's last two segments) is the final partial buffer
BATCH_VECTORS = 300
N_SEGMENTS = 12  # 1 + 2 + 2 + 3 + 1 + 3


@pytest.fixture
def small_hubert(monkeypatch):
    """Both packages' HubertEncoder at SMALL_HUBERT, with the same seed-0
    weights and seed-1 centroids."""
    params = init_hubert_params(np.random.default_rng(0), HubertConfig(**SMALL_HUBERT))
    centroids = np.random.default_rng(1).standard_normal((1000, 768)).astype(np.float32)
    real_jax_cfg = jax_hubert_nn.HubertConfig
    monkeypatch.setattr(jax_hubert_nn, "HubertConfig",
                        lambda **kw: real_jax_cfg(**SMALL_HUBERT, **kw))
    monkeypatch.setattr(jax_weights, "get_hubert_params", lambda w, s, c: (params, centroids))
    monkeypatch.setattr(port_encoders, "HubertConfig",
                        lambda **kw: HubertConfig(**SMALL_HUBERT, **kw))
    monkeypatch.setattr(port_encoders, "get_hubert_params",
                        lambda w, s, c: (params, centroids))


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(70)
    d = tmp_path / "corpus"
    d.mkdir()
    for i, sec in enumerate(CORPUS_SECONDS):
        pcm = (rng.standard_normal(int(sec * 16_000)) * 3000).astype(np.int16)
        write_wav(str(d / f"f{i}.wav"), pcm[None], 16_000)
    return str(d)


def _processed(outdir):
    with open(os.path.join(outdir, "processed_files.json")) as f:
        return json.load(f)["files"]


def _partial(outdir):
    with open(os.path.join(outdir, "processed_files.json")) as f:
        return json.load(f)["partial"]


def test_train_quantizer_matches_jax_and_records_only_trained_files(small_hubert, corpus,
                                                                    tmp_path):
    kw = dict(batch_vectors=BATCH_VECTORS, chunk_size=2.0, encode_batch=2, num_workers=1,
              weights="random")
    out_port, out_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    port = train_quantizer("semantic_s", corpus, out_port, device="cpu", **kw)
    ref = jax_vq.train_quantizer("semantic_s", corpus, out_jax, **kw)
    assert port.steps == ref.steps == 2
    # the features differ by about 1e-6 of their scale (HuBERT's attention:
    # K4's plain version against XLA's); no assignment flips on this corpus
    for name, a, b in zip(("codebook", "cluster_size", "embed_avg"), port.state, ref.state):
        _assert_close(a.numpy(), b, rel=1e-4, what=name)
    np.testing.assert_array_equal(
        np.load(os.path.join(out_port, "semantic_s_codebook.npz"))["codebook"], port.codebook)
    assert port.stats["vectors"] >= 2 * BATCH_VECTORS
    assert port.stats["files_read"] == len(CORPUS_SECONDS)

    # the JAX package records every file read, the port only the files whose
    # every vector went through an update: the final partial buffer is never
    # trained, so its files stay unrecorded and are read again on resume
    files = sorted(os.path.join(corpus, f) for f in os.listdir(corpus))
    assert _processed(out_jax) == files
    done = _processed(out_port)
    assert done == files[:-1]  # one producer: the tail is the last file's
    # ... from its first untrained segment: the last file's first one was
    # trained, its last two were not
    assert _partial(out_port) == {files[-1]: 1}
    assert port.stats["segments"] == N_SEGMENTS
    assert port.stats["segments_trained"] == N_SEGMENTS - 2

    again = train_quantizer("semantic_s", corpus, out_port, device="cpu", **kw)
    assert again.steps == port.steps  # resumed; the tail alone fills no update
    assert again.stats["files_read"] == len(files) - len(done)
    assert again.stats["segments"] == 2  # the tail alone: no segment trained twice
    assert _processed(out_port) == done
    assert _partial(out_port) == {files[-1]: 1}
    np.testing.assert_array_equal(again.codebook, port.codebook)
    ref_again = jax_vq.train_quantizer("semantic_s", corpus, out_jax, **kw)
    assert ref_again.steps == ref.steps  # and it read no file

    # two more files: the tail goes through an update with them and its file
    # is recorded; the new files' untrained segments wait in `partial`
    rng = np.random.default_rng(71)
    for i, sec in ((6, 5.0), (7, 4.0)):  # 3 and 2 segments
        pcm = (rng.standard_normal(int(sec * 16_000)) * 3000).astype(np.int16)
        write_wav(os.path.join(corpus, f"f{i}.wav"), pcm[None], 16_000)
    third = train_quantizer("semantic_s", corpus, out_port, device="cpu", **kw)
    assert third.steps == port.steps + 1
    assert third.stats["segments"] == 2 + 3 + 2
    assert third.stats["segments_trained"] == 2 + 2
    new = sorted(os.path.join(corpus, f"f{i}.wav") for i in (6, 7))
    # batches [f5 b, f5 c] [f6 a, f6 b] -> an update; [f6 c, f7 a] [f7 b] wait
    assert _processed(out_port) == files
    assert _partial(out_port) == {new[0]: 2}


def test_train_quantizer_refuses_acoustic(tmp_path):
    with pytest.raises(ValueError, match="semantic"):
        train_quantizer("acoustic", str(tmp_path), str(tmp_path / "o"), device="cpu")


# --- cluster diagnostics -----------------------------------------------------


def test_cluster_diagnostics_match_jax(tmp_path):
    rng = np.random.default_rng(80)
    centroids = rng.standard_normal((32, 16)).astype(np.float32)
    x = (centroids[rng.integers(0, 32, 300)]
         + 0.1 * rng.standard_normal((300, 16))).astype(np.float32)
    port = diag.nearest_distance_stats(x, centroids, device="cpu")
    ref = jax_diag.nearest_distance_stats(x, centroids)
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=1e-6), k
    plot = str(tmp_path / "hist.png")
    port = diag.compare_real_vs_random(x, centroids, seed=3, plot_path=plot, device="cpu")
    ref = jax_diag.compare_real_vs_random(x, centroids, seed=3)
    assert port["separation"] == pytest.approx(ref["separation"], rel=1e-6)
    assert port["separation"] > 3  # the data sits on the centroids, the noise does not
    for side in ("real", "random"):
        for k in ref[side]:
            assert port[side][k] == pytest.approx(ref[side][k], rel=1e-6), (side, k)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert os.path.getsize(plot) > 0


def test_cluster_diagnostics_without_matplotlib(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(81)
    c = rng.standard_normal((4, 3)).astype(np.float32)
    out = diag.compare_real_vs_random(c[[0, 1, 2, 3, 0]], c, plot_path=str(tmp_path / "p.png"),
                                      device="cpu")
    assert out["real"]["p50"] == 0.0 and not os.path.exists(tmp_path / "p.png")


# --- the GPT: loss, vocabulary expansion, training step ---------------------

TINY = dict(block_size=16, vocab_size=64, n_layer=2, n_head=2, n_embd=32)


def _gpt(params, cfg):
    with torch.device("meta"):
        model = GPT(cfg)
    model.load_state_dict(gpt_from_numpy(params), assign=True)
    return model


@pytest.mark.parametrize("bias", [False, True])
def test_gpt_loss_matches_jax(bias):
    cfg, jcfg = GPTConfig(**TINY, bias=bias), JaxGPTConfig(**TINY, bias=bias)
    params = init_gpt_params(np.random.default_rng(90), cfg)
    rng = np.random.default_rng(91)
    idx = rng.integers(0, 64, (3, 16))
    targets = np.roll(idx, -1, axis=1)
    targets[:, -1] = -1
    targets[1, :5] = -1
    ref = float(jax_gpt_loss(params, idx, targets, jcfg, precision=jax.lax.Precision.HIGHEST))
    got = float(gpt_loss(_gpt(params, cfg), torch.from_numpy(idx), torch.from_numpy(targets)))
    assert got == pytest.approx(ref, rel=1e-6)
    none = np.full_like(targets, -1)
    assert float(gpt_loss(_gpt(params, cfg), torch.from_numpy(idx), torch.from_numpy(none))) == 0.0
    assert float(jax_gpt_loss(params, idx, none, jcfg)) == 0.0


def test_expand_vocab_matches_jax_bitwise():
    params = init_gpt_params(np.random.default_rng(92), GPTConfig(**TINY))
    got = expand_vocab(params, 80, seed=4)
    ref = jax_expand_vocab(params, 80, seed=4)
    assert got["wte"].shape == (80, 32) and got["wte"].dtype == np.float32
    np.testing.assert_array_equal(got["wte"], np.asarray(ref["wte"]))
    np.testing.assert_array_equal(got["wte"][:64], params["wte"])
    assert got["layers"] is params["layers"]
    with pytest.raises(ValueError):
        expand_vocab(params, 64)


def test_gpt_to_numpy_inverts_gpt_from_numpy():
    for bias in (False, True):
        params = init_gpt_params(np.random.default_rng(93), GPTConfig(**TINY, bias=bias))
        back = gpt_to_numpy(_gpt(params, GPTConfig(**TINY, bias=bias)))
        flat_a, flat_b = jax.tree_util.tree_flatten(params, is_leaf=lambda v: v is None), \
            jax.tree_util.tree_flatten(back, is_leaf=lambda v: v is None)
        assert flat_a[1] == flat_b[1]
        for a, b in zip(flat_a[0], flat_b[0]):
            assert (a is None and b is None) or np.array_equal(a, b)


def _state_grads(model):
    return {name: p.grad.numpy().copy() for name, p in model.named_parameters()}


def test_train_step_matches_jax_for_three_steps():
    """Loss, clipped gradients and parameters against ``make_train_step``
    (f32 on both sides). Adam's early steps move a parameter by about lr
    times the sign of its gradient, so an element whose gradient is near
    zero may move by up to 2 lr more on one side: parameters must agree
    within 1e-5 for 99.9 % of the elements and within 2 lr x steps for all."""
    cfg, jcfg = GPTConfig(**TINY), JaxGPTConfig(**TINY)
    tc = TrainConfig(learning_rate=1e-2, grad_clip=0.5)
    params = init_gpt_params(np.random.default_rng(94), cfg)
    rng = np.random.default_rng(95)
    idx = rng.integers(0, 64, (4, 16))
    tgt = np.roll(idx, -1, axis=1)
    port = TrainStep(cfg, tc, params=params, device="cpu")
    step, optimizer = jax_gpt_train.make_train_step(jcfg, jax_gpt_train.TrainConfig(
        learning_rate=1e-2, grad_clip=0.5))
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    opt_state = optimizer.init(jparams)
    clip = optax.clip_by_global_norm(0.5)
    clipped_any = False
    for i in range(3):
        loss_ref, grads = jax.value_and_grad(jax_gpt_train._loss_fn)(jparams, idx, tgt, jcfg, None)
        norm = float(optax.global_norm(grads))
        clipped_any |= norm > 0.5
        grads, _ = clip.update(grads, clip.init(jparams))
        jparams, opt_state, loss_step = step(jparams, opt_state, idx, tgt)
        loss = float(port.step(idx, tgt))
        assert loss == pytest.approx(float(loss_ref), rel=1e-5)
        assert float(loss_step) == pytest.approx(float(loss_ref), rel=1e-6)
        ref_grads = {k: v.numpy() for k, v in gpt_from_numpy(grads).items()}
        got_grads = _state_grads(port.model)
        assert got_grads.keys() == ref_grads.keys()
        for k in ref_grads:
            np.testing.assert_allclose(got_grads[k], ref_grads[k], rtol=1e-3,
                                       atol=1e-5 * np.abs(ref_grads[k]).max(), err_msg=k)
    assert clipped_any
    assert port.steps == 3
    got = gpt_to_numpy(port.model)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree_util.tree_flatten(got)[0]):
        diff = np.abs(np.asarray(a) - b)
        assert diff.max() <= 2 * tc.learning_rate * 3, path
        assert (diff <= 1e-5).mean() >= 0.999, (path, (diff > 1e-5).mean())


def test_clip_matches_optax():
    rng = np.random.default_rng(96)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2))]
    for max_norm in (0.1, 100.0):
        ref = optax.clip_by_global_norm(max_norm).update(grads, None)[0]
        got = [torch.from_numpy(g.copy()) for g in grads]
        clip_by_global_norm(got, max_norm)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    untouched = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm(untouched, 100.0)
    for a, g in zip(untouched, grads):
        np.testing.assert_array_equal(a.numpy(), g)


def test_weight_decay_skips_vectors():
    """With every target -1 the loss is 0 and every gradient 0 (not NaN):
    Adam moves nothing, so only weight decay acts, on the 2-D parameters
    (wte and wpe included) and on no LayerNorm scale."""
    cfg = GPTConfig(**TINY)
    tc = TrainConfig(learning_rate=1e-2, weight_decay=0.1)
    params = init_gpt_params(np.random.default_rng(97), cfg)
    port = TrainStep(cfg, tc, params=params, device="cpu")
    groups = make_optimizer(port.model, tc).param_groups
    assert [g["weight_decay"] for g in groups] == [0.1, 0.0]
    assert all(p.ndim >= 2 for p in groups[0]["params"])
    assert all(p.ndim < 2 for p in groups[1]["params"]) and groups[1]["params"]
    before = {k: p.detach().clone() for k, p in port.model.named_parameters()}
    idx = np.zeros((2, 16), np.int64)
    assert float(port.step(idx, np.full((2, 16), -1))) == 0.0
    for k, p in port.model.named_parameters():
        assert torch.isfinite(p.grad).all() and not p.grad.any(), k
        if p.ndim >= 2:
            torch.testing.assert_close(p.detach(), before[k] * (1 - 1e-2 * 0.1), rtol=1e-6,
                                       atol=0)
        else:
            assert torch.equal(p.detach(), before[k]), k
    assert not torch.equal(port.model.wte.detach(), before["wte"])


def test_train_step_loss_falls_and_refuses_a_mesh():
    cfg = GPTConfig(**TINY)
    port = TrainStep(cfg, TrainConfig(learning_rate=1e-2), seed=0, device="cpu")
    rng = np.random.default_rng(98)
    idx = rng.integers(0, 64, (4, 16))
    tgt = np.roll(idx, -1, axis=1)
    losses = [float(port.step(idx, tgt)) for _ in range(10)]
    assert losses[-1] < losses[0]
    # a mesh that is not a parallel.mesh.Mesh: JAX's make_train_step raises
    # AttributeError for it ('str' object has no attribute 'size')
    with pytest.raises(AttributeError, match="Mesh"):
        TrainStep(cfg, mesh=object(), device="cpu")


def test_train_step_leaves_the_callers_tree_alone():
    params = init_gpt_params(np.random.default_rng(99), GPTConfig(**TINY))
    wte = params["wte"].copy()
    port = TrainStep(GPTConfig(**TINY), TrainConfig(learning_rate=1e-2), params=params,
                     device="cpu")
    port.step(np.zeros((1, 16), np.int64), np.ones((1, 16), np.int64))
    np.testing.assert_array_equal(params["wte"], wte)


def test_default_batch_vectors_matches_jax():
    default = inspect.signature(train_quantizer).parameters["batch_vectors"].default
    assert default == jax_configs.KMeansClusterConfig().batch_size


def test_segment_stream_skips_leading_segments(tmp_path):
    """``skip_segments`` drops a file's leading segments and still counts
    them in ``on_file_complete``."""
    pcm = (np.random.default_rng(72).standard_normal(5 * 16_000) * 3000).astype(np.int16)
    paths = [str(tmp_path / f"{n}.wav") for n in ("a", "b")]
    for p in paths:
        write_wav(p, pcm[None], 16_000)
    done = {}
    stream = AudioSegmentStream(paths, 16_000, 50, 2.0, skip_segments={paths[0]: 2},
                                on_file_complete=lambda n, k: done.__setitem__(n, k))
    starts = sorted((c.file_name, c.start_idx)
                    for _, _, cfgs in batched_segments(stream, 2, num_workers=2)
                    for c in cfgs if c is not None)
    assert starts == [(paths[0], 64_000), (paths[1], 0), (paths[1], 32_000),
                              (paths[1], 64_000)]
    assert done == {paths[0]: 3, paths[1]: 3}
