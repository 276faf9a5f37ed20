"""The rank side of ``test_torch_parallel.py``: functions that run in each
rank of a spawned world (``audiotoken_tpu_torch.parallel.launch``).

Nothing here imports JAX: a rank is a fresh interpreter with the port and
numpy only. The semantic encoders run at a narrow width, patched into the
port's ``encoders`` module as ``test_torch_precision.py`` patches them.
"""

import numpy as np
import torch

from audiotoken_tpu_torch.parallel import dryrun
from audiotoken_tpu_torch.parallel.mesh import make_mesh

NARROW_W2V = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                  intermediate_size=128)
NARROW_HUBERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                     intermediate_size=128, conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                     num_conv_pos_embedding_groups=4)
#: the tensor-parallel conformer of ``test_data_parallel.py``
TP_W2V = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, feature_projection_input_dim=160,
              left_max_position_embeddings=8, right_max_position_embeddings=4,
              conv_depthwise_kernel_size=7)
#: the GPT of ``test_data_parallel.py``'s tp sampler check
SAMPLER_GPT = dict(block_size=64, vocab_size=128, n_layer=2, n_head=4, n_embd=64, bias=False)


def with_biases(tree, seed: int):
    """``tree`` with every bias leaf drawn at random (the initialisers give
    zeros, under which a bias added once per rank would not show)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key == "bias" and node is not None:
            return (rng.standard_normal(np.shape(node)) * 0.1).astype(np.float32)
        return node

    return walk(tree)


def narrow_weights():
    """(w2v-BERT tree, VQ codebook, HuBERT tree, centroids) at the narrow
    widths, from fixed seeds."""
    from audiotoken_tpu_torch.nn.conformer import W2VBertConfig, init_w2vbert_params
    from audiotoken_tpu_torch.nn.hubert import HubertConfig, init_hubert_params

    w2v = init_w2vbert_params(np.random.default_rng(0), W2VBertConfig(**NARROW_W2V))
    codebook = np.random.default_rng(1).standard_normal((2048, 64)).astype(np.float32)
    hub = init_hubert_params(np.random.default_rng(2), HubertConfig(**NARROW_HUBERT))
    centroids = np.random.default_rng(3).standard_normal((1000, 64)).astype(np.float32)
    return w2v, codebook, hub, centroids


def patch_narrow(setattr_):
    """Patch the port's semantic encoders narrow through ``setattr_``
    (``setattr``, or a MonkeyPatch's)."""
    from audiotoken_tpu_torch import encoders
    from audiotoken_tpu_torch.nn.conformer import W2VBertConfig
    from audiotoken_tpu_torch.nn.hubert import HubertConfig

    w2v, codebook, hub, centroids = narrow_weights()
    setattr_(encoders, "W2VBertConfig", lambda **kw: W2VBertConfig(**NARROW_W2V, **kw))
    setattr_(encoders, "HubertConfig", lambda **kw: HubertConfig(**NARROW_HUBERT, **kw))
    setattr_(encoders, "get_w2vbert_params", lambda w, s, c: (w2v, codebook))
    setattr_(encoders, "get_hubert_params", lambda w, s, c: (hub, centroids))


def make_encoder(tok: str, device, mesh=None):
    """The port's encoder of ``tok``: acoustic at full width (2 codebooks),
    the semantic ones narrow (patch first) at output layer 2."""
    from audiotoken_tpu_torch import encoders
    from audiotoken_tpu_torch.configs import (
        AcousticEncoderConfig,
        HubertEncoderConfig,
        Wav2VecBertConfig,
    )

    if tok == "acoustic":
        return encoders.AcousticEncoder(AcousticEncoderConfig(bandwidth=1.5), weights="random",
                                        device=device, mesh=mesh)
    if tok == "semantic_s":
        return encoders.HubertEncoder(HubertEncoderConfig(output_layer=2), weights="random",
                                      device=device, mesh=mesh)
    return encoders.Wav2VecBertEncoder(Wav2VecBertConfig(output_layer=2), weights="random",
                                       device=device, mesh=mesh)


def encode_batches(tok: str, batches, max_device_batch: int, mesh_shape=None,
                   axes=("dp",)) -> dict:
    """Encode each (name, audio, lengths) of ``batches`` with ``tok``'s
    encoder over a mesh -> {name: tokens, or the exception type's name},
    plus "mesh". The bound is ``max_device_batch`` rows a rank."""
    patch_narrow(setattr)
    mesh = make_mesh(axes, mesh_shape, device="cpu")
    enc = make_encoder(tok, "cpu", mesh)
    enc.max_device_batch = max_device_batch
    out = {"mesh": dict(mesh.shape)}
    for name, audio, lengths in batches:
        try:
            out[name] = enc(audio, attention_mask=lengths)
        except ValueError as e:
            out[name] = type(e).__name__
    return out


#: the corpus of the dp 4 world: chunk seconds, batch size
CORPUS_CHUNK, CORPUS_BATCH = 1.0, 4


def dp4_world(batches, max_device_batch: int, corpus_files) -> dict:
    """The dp 4 world: every tokenizer's batches over a ("dp",) mesh, and
    ``AudioToken(mesh=)`` handing its mesh to the encoder, which drives
    ``encode_batch_files`` over ``corpus_files`` into ``out_r<rank>``
    beside them (a batch size that does not split over dp raises first)."""
    import os

    import torch.distributed as dist

    from audiotoken_tpu_torch.api import AudioToken

    out = {tok: encode_batches(tok, batches[tok], max_device_batch)
           for tok in ("acoustic", "semantic_s", "semantic_m")}
    mesh = make_mesh(("dp",), device="cpu")
    at = AudioToken("acoustic", device="cpu", num_codebooks=2, weights="random", mesh=mesh)
    at.load_encoder()
    name, audio, _ = batches["acoustic"][0]
    out["api"] = {"same_mesh": at.encoder.mesh is mesh, name: at.encoder(audio)}
    at.encoder.max_device_batch = max_device_batch
    outdir = os.path.join(os.path.dirname(corpus_files[0]), f"out_r{dist.get_rank()}")
    try:
        at.encode_batch_files(CORPUS_BATCH - 1, outdir, audio_files=["missing.wav"])
    except ValueError as e:
        out["api"]["odd_batch"] = str(e)
    out["api"]["corpus"] = at.encode_batch_files(
        CORPUS_BATCH, outdir, chunk_size=CORPUS_CHUNK, num_workers=2, audio_files=corpus_files)
    # an outdir that is a file: rank 0 fails before its first batch, and its
    # stop message ends the other ranks' loop with an error, not a hang
    try:
        at.encode_batch_files(CORPUS_BATCH, corpus_files[0], audio_files=corpus_files)
    except Exception as e:  # noqa: BLE001  (the test reads which)
        out["api"]["rank0_fails"] = type(e).__name__, str(e)
    return out


def fail_while_others_wait() -> None:
    """The last rank raises; the others wait in a collective for it."""
    import torch.distributed as dist

    if dist.get_rank() == dist.get_world_size() - 1:
        raise RuntimeError("this rank fails on purpose")
    dist.barrier()


def tp_conformer_features(feats, mask, shape) -> dict:
    """The tensor-parallel conformer over a ("dp", "tp") mesh: this rank's
    rows of the features of ``TP_W2V`` (seed-0 weights, 2 blocks)."""
    from audiotoken_tpu_torch.nn.conformer import (
        W2VBertConfig,
        W2VBertFeatures,
        init_w2vbert_params,
    )
    from audiotoken_tpu_torch.parallel.shard import conformer_param_spec, shard_tree
    from audiotoken_tpu_torch.weights import w2vbert_from_numpy

    mesh = make_mesh(("dp", "tp"), shape, device="cpu")
    dp, tp = mesh.axis("dp"), mesh.axis("tp")
    cfg = W2VBertConfig(**TP_W2V)
    params = with_biases(init_w2vbert_params(np.random.default_rng(0), cfg), 1)
    local = shard_tree(params, conformer_param_spec(params), mesh, mesh.rank)
    with torch.device("meta"):
        model = W2VBertFeatures(cfg, 2, tp)
    model.load_state_dict(w2vbert_from_numpy(local, 2), assign=True)
    rows = slice(dp.index * len(feats) // dp.size, (dp.index + 1) * len(feats) // dp.size)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(feats[rows]), torch.from_numpy(mask[rows]))
    return {"mesh": dict(mesh.shape), "rows": (rows.start, rows.stop), "tp_index": tp.index,
            "features": out.numpy(), "pw1_shape": tuple(model.layers[0].conv.pw1.weight.shape)}


#: a GPT with biases, for the row-parallel biases of the tp forward
BIASED_GPT = dict(block_size=32, vocab_size=128, n_layer=2, n_head=4, n_embd=64, bias=True)


def tp_gpt_biases(shape) -> dict:
    """The tp GPT with random biases against the whole one on this rank:
    the gathered logits of a forward, a greedy rollout, one train step."""
    from audiotoken_tpu_torch.nn.gpt import GPTConfig, GPTSampler, _shard_model, init_gpt_params
    from audiotoken_tpu_torch.parallel.collectives import all_gather
    from audiotoken_tpu_torch.train.gpt_train import TrainConfig, TrainStep

    mesh = make_mesh(("dp", "tp"), shape, device="cpu")
    cfg = GPTConfig(**BIASED_GPT)
    params = with_biases(init_gpt_params(np.random.default_rng(5), cfg), 6)
    model = dryrun._gpt(cfg, params, "cpu")
    shard = _shard_model(model, mesh)
    idx = torch.from_numpy(np.random.default_rng(7).integers(0, 128, (2, 16)))
    with torch.inference_mode():
        err = float((all_gather(shard(idx), mesh.axis("tp")) - model(idx)).abs().max())
        step_err = float((_decode_logits(shard, idx) - _decode_logits(model, idx)).abs().max())
    prompts = idx[:, :5].numpy()
    greedy = [GPTSampler(model, mesh=m).generate_batch(prompts, max_new_tokens=8, top_k=1)
              for m in (None, mesh)]
    tc = TrainConfig(learning_rate=1e-4, grad_clip=0.05)
    tgt = np.roll(idx.numpy(), -1, axis=1)
    losses = [float(TrainStep(cfg, tc, params=params, device="cpu", precision="highest",
                              mesh=m).step(idx.numpy(), tgt)) for m in (None, mesh)]
    return {"logit_err": err, "step_err": step_err, "greedy": greedy, "losses": losses}


def _decode_logits(model, idx, P: int = 8):
    """The logits of one decode step (token ``idx[:, P]`` at slot ``P``)
    after a prefill of ``idx[:, :P]``."""
    B, L = idx.shape[0], len(model.layers)
    start = torch.zeros(B, dtype=torch.int32)
    _, kv = model.prefill(idx[:, :P], start.long())
    cache = [torch.zeros((L, B, model.n_head, P + 1, kv[0][0].shape[-1])) for _ in range(2)]
    for li, (k, v) in enumerate(kv):
        cache[0][li, :, :, :P], cache[1][li, :, :, :P] = k, v
    return model.decode_step(idx[:, P], P, start, *cache, model.decode_weights())


def mesh_facts(shape) -> dict:
    """make_mesh in this world: the default factoring, an explicit shape,
    and the ValueError of a shape that does not fit."""
    default = make_mesh(("dp", "tp"), device="cpu")
    explicit = make_mesh(("dp", "tp"), shape, device="cpu")
    try:
        make_mesh(("dp", "tp"), (3, 2), device="cpu")
        bad = None
    except ValueError as e:
        bad = str(e)
    return {"default": default.shape, "explicit": explicit.shape, "bad": bad,
            "axes": {n: (explicit.axis(n).size, explicit.axis(n).index) for n in ("dp", "tp")}}


def dp2tp2_world(feats, mask, acoustic_batches) -> dict:
    """The dp 2 x tp 2 world: make_mesh, the train step, the tp sampler, K4
    on a shard, the tp conformer and a dp acoustic encode on the 2-D mesh."""
    from audiotoken_tpu_torch.nn.gpt import GPTConfig

    shape = (2, 2)
    return {
        "mesh": mesh_facts(shape),
        "train": dryrun.check_train_step("cpu", shape=shape),
        "sampler": dryrun.check_tp_sampler("cpu", max_new_tokens=16, shape=shape,
                                           cfg=GPTConfig(**SAMPLER_GPT), prompt_len=9),
        "attention": dryrun.check_attention_shard("cpu", shape=shape),
        "conformer": tp_conformer_features(feats, mask, shape),
        "biases": tp_gpt_biases(shape),
        "encode": encode_batches("acoustic", acoustic_batches, 1, shape, ("dp", "tp")),
    }
