"""The four multi-device checks, on a world of spawned ranks.

The port's counterpart of ``__graft_entry__.py:dryrun_multichip``:

1. a GPT train step over a ("dp", "tp") mesh, against the same step on
   one rank (the loss, and every rank's parameter shard), at the default
   factoring, with every rank on "dp", and at dp x 2 where the world is
   even and larger than 2;
2. a data-parallel acoustic encode over ("dp",), equal to one rank's
   tokens;
3. the attention kernel K4 on a dp x tp shard of q, k and v, equal to that
   slice of the unsharded call;
4. a tensor-parallel GPT sampler whose greedy rollout equals the
   replicated one's.

Each ``check_*`` runs inside a rank of an initialised process group (one
of :func:`~.launch.run_world`'s) and raises on a mismatch; the tests and
``chip_smoke.py`` call them too. On the cards::

    python -m audiotoken_tpu_torch.parallel.dryrun --world 4

runs them with heads 64 wide (as K4 and K6 take them), over NCCL with a
card a rank, or over gloo where there are more ranks than cards (NCCL
refuses two ranks on one card); it prints one ``OK`` line per check and
exits non-zero on any failure. ``--device cpu`` runs them over gloo on the
CPU, at narrow shapes and on the kernels' plain versions.
"""

import argparse
import sys

import numpy as np
import torch

from .launch import run_world
from .mesh import make_mesh, mesh_shape

#: check 1's steps, learning rate and clip (low enough that the clip engages)
TRAIN_STEPS, TRAIN_LR, TRAIN_CLIP = 2, 1e-4, 0.05
CHECK_TIMEOUT = 300.0  # seconds the world of one check may take


def _head_size(device) -> int:
    """16 on the CPU, as JAX's dryrun; on a card 64, the head size of K4 and K6."""
    return 64 if torch.device(device).type == "cuda" else 16


def tiny_gpt_config(tp: int, device: str = "cuda"):
    """The tiny GPT of the checks: dims divisible by dp and tp, as in JAX's
    dryrun; on a card its heads are 64 wide, the head size of K6."""
    from ..nn.gpt import GPTConfig

    n_head = max(4, tp)
    n_embd = 64 * n_head if torch.device(device).type == "cuda" else 32 * tp
    return GPTConfig(block_size=32, vocab_size=64 * tp, n_layer=2, n_head=n_head,
                     n_embd=n_embd, bias=False)


def _gpt(cfg, params, device, tp=None):
    from ..nn.gpt import GPT
    from ..weights import gpt_from_numpy

    with torch.device("meta"):
        model = GPT(cfg, tp)
    model.load_state_dict(gpt_from_numpy(params), assign=True)
    return model.to(device).eval()


def check_train_step(device: str = "cuda", shape=None) -> dict:
    """Check 1: ``TRAIN_STEPS`` steps of ``TrainStep`` over a ("dp", "tp") mesh
    (default factoring unless ``shape``) on a batch of 2 x dp rows with
    uneven padding (-1 targets) and the clip engaged, against the same steps
    on this rank alone: each step's loss within 1e-6 relative, the first
    step's clipped gradient shard within 1e-5 of the largest gradient, and
    at the end this rank's parameter shard within 1e-5. (Adam divides by
    the root of the gradient's second moment, which magnifies the rounding
    of a gradient that changes sign between steps: at lr 1e-3 a parameter
    moved 2.4e-5 apart on the CPU, and a later step's gradients inherit
    that.)"""
    from ..nn.gpt import init_gpt_params
    from ..train.gpt_train import TrainConfig, TrainStep
    from ..weights import gpt_to_numpy
    from .shard import gpt_param_spec, shard_tree

    mesh = make_mesh(("dp", "tp"), shape, device=device)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    cfg = tiny_gpt_config(tp, device)
    rng = np.random.default_rng(0)
    params = init_gpt_params(rng, cfg)
    B = 2 * dp
    idx = rng.integers(0, cfg.vocab_size, (B, cfg.block_size))
    tgt = rng.integers(0, cfg.vocab_size, (B, cfg.block_size))
    for i in range(B):  # every row padded differently: the dp ranks' counts differ
        tgt[i, cfg.block_size - 3 * i:] = -1
    tc = TrainConfig(learning_rate=TRAIN_LR, grad_clip=TRAIN_CLIP)
    sharded = TrainStep(cfg, tc, params=params, device=device, precision="highest", mesh=mesh)
    alone = TrainStep(cfg, tc, params=params, device=mesh.device, precision="highest")
    losses, grad_errs = [], []
    for _ in range(TRAIN_STEPS):
        a, b = float(sharded.step(idx, tgt)), float(alone.step(idx, tgt))
        if not (np.isfinite(a) and abs(a - b) <= 1e-6 * abs(b)):
            raise AssertionError(f"rank {mesh.rank}: mesh loss {a!r} != one rank's {b!r}")
        losses.append(a)
        if grad_errs:
            continue
        g_full = _grad_tree(alone.model)
        g_want = shard_tree(g_full, gpt_param_spec(g_full), mesh, mesh.rank)
        scale = max(float(np.abs(x).max()) for x in _flat(g_full))
        grad_errs.append(_max_tree_diff(_grad_tree(sharded.model), g_want) / scale)
        if grad_errs[-1] > 1e-5:
            raise AssertionError(f"rank {mesh.rank}: clipped gradient shard off by "
                                 f"{grad_errs[-1]:.3g} of the largest > 1e-5")
    got = gpt_to_numpy(sharded.model)
    full = gpt_to_numpy(alone.model)
    want = shard_tree(full, gpt_param_spec(full), mesh, mesh.rank)
    err = _max_tree_diff(got, want)
    if err > 1e-5:
        raise AssertionError(f"rank {mesh.rank}: parameter shard off by {err:.3g} > 1e-5")
    return {"mesh": dict(mesh.shape), "losses": losses, "param_err": err, "params": got,
            "grad_errs": grad_errs, "grads": _grad_tree(sharded.model), "batch": (idx, tgt),
            "init": params}


def _grad_tree(model):
    """A GPT's gradients as a JAX-layout tree (copies)."""
    from ..weights import gpt_to_numpy

    params = list(model.parameters())
    saved = [p.data for p in params]
    try:
        for p in params:
            p.data = p.grad.detach().clone()
        return gpt_to_numpy(model)
    finally:
        for p, d in zip(params, saved):
            p.data = d


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [] if tree is None else [tree]


def _max_tree_diff(a, b) -> float:
    if isinstance(a, dict):
        return max(_max_tree_diff(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return max(_max_tree_diff(x, y) for x, y in zip(a, b))
    if a is None:
        return 0.0
    if np.shape(a) != np.shape(b):
        raise AssertionError(f"shard shape {np.shape(a)} != {np.shape(b)}")
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def check_dp_encode(device: str = "cuda") -> dict:
    """Check 2: the acoustic encoder (2 codebooks) over a ("dp",) mesh of
    every rank on one row of 0.25 s a rank, against the same encoder on
    this rank alone: equal tokens."""
    from ..configs import AcousticEncoderConfig
    from ..encoders import AcousticEncoder

    mesh = make_mesh(("dp",), device=device)
    cfg = AcousticEncoderConfig(bandwidth=1.5)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((mesh.size, 6_000)) * 0.2).astype(np.float32)
    one = AcousticEncoder(cfg, weights="random", seed=0, device=mesh.device)(audio)
    enc = AcousticEncoder(cfg, weights="random", seed=0, device=device, mesh=mesh)
    toks = enc(audio)
    if not np.array_equal(one, toks):
        raise AssertionError(f"rank {mesh.rank}: dp-sharded tokens != one rank's "
                             f"({int((one != toks).sum())} differ)")
    return {"mesh": dict(mesh.shape), "tokens": toks}


def check_attention_shard(device: str = "cuda", shape=None) -> dict:
    """Check 3: K4 (``flash_attention_relkey``, rel and padding terms) on
    this rank's dp x tp block of [B, H, T, dh] inputs, against the same
    block of the unsharded call: equal bit for bit."""
    from ..ops.flash_attention import flash_attention_relkey

    mesh = make_mesh(("dp", "tp"), shape, device=device)
    dp, tp = mesh.axis("dp"), mesh.axis("tp")
    B, H, T, dh = max(2, dp.size), max(4, tp.size), 64, _head_size(device)
    rng = np.random.default_rng(0)
    q, k = ((rng.standard_normal((B, H, T, dh)) * 0.3).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    E = (rng.standard_normal((13, dh)) * 0.05).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, T - T // 4:] = 0.0
    dev = mesh.device
    q, k, v, E, mask = (torch.from_numpy(a).to(dev) for a in (q, k, v, E, mask))
    rows = slice(dp.index * B // dp.size, (dp.index + 1) * B // dp.size)
    heads = slice(tp.index * H // tp.size, (tp.index + 1) * H // tp.size)
    out = {}
    for form, e, m in (("rel", E, mask), ("no-rel", None, mask)):
        ref = flash_attention_relkey(q, k, v, e, m, left=8, right=4)[rows, heads]
        got = flash_attention_relkey(*(t[rows, heads].contiguous() for t in (q, k, v)), e,
                                     m[rows].contiguous(), left=8, right=4)
        if not torch.equal(got, ref):
            raise AssertionError(f"rank {mesh.rank}: K4 {form} on its shard != the slice of "
                                 f"the unsharded call (max {float((got - ref).abs().max()):.3g})")
        out[form] = got.cpu().numpy()
    return {"mesh": dict(mesh.shape), "shard": [B // dp.size, H // tp.size, T, dh], **out}


def check_tp_sampler(device: str = "cuda", max_new_tokens: int = 12, shape=None, cfg=None,
                     prompt_len: int = 7) -> dict:
    """Check 4: ``GPTSampler`` over a ("dp", "tp") mesh (default factoring
    unless ``shape``), greedy, against the replicated sampler on this rank:
    equal rollouts; and a sampled rollout that every rank agrees on.
    ``cfg``: the GPT (default :func:`tiny_gpt_config`)."""
    import torch.distributed as dist

    from ..nn.gpt import GPTSampler, init_gpt_params

    mesh = make_mesh(("dp", "tp"), shape, device=device)
    cfg = cfg or tiny_gpt_config(mesh.shape["tp"], device)
    model = _gpt(cfg, init_gpt_params(np.random.default_rng(1), cfg), mesh.device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (4, prompt_len)).astype(np.int32)
    ref = GPTSampler(model).generate_batch(prompts, max_new_tokens=max_new_tokens, top_k=1,
                                           seed=3)
    sp = GPTSampler(model, mesh=mesh)
    got = sp.generate_batch(prompts, max_new_tokens=max_new_tokens, top_k=1, seed=3)
    if not np.array_equal(ref, got):
        raise AssertionError(f"rank {mesh.rank}: tp-sharded greedy rollout != replicated")
    drawn = sp.generate_batch(prompts, max_new_tokens=max_new_tokens, top_k=8, seed=5,
                              temperature=1.0)
    every = [None] * mesh.size
    dist.all_gather_object(every, drawn)
    if any(not np.array_equal(drawn, d) for d in every):
        raise AssertionError(f"rank {mesh.rank}: the ranks drew different tokens")
    return {"mesh": dict(mesh.shape), "greedy": got, "drawn": drawn, "prompts": prompts}


CHECKS = (
    ("train_step", "check_train_step", "dp x tp GPT train step == one rank's"),
    ("dp-encode", "check_dp_encode", "dp acoustic encode == one rank's tokens"),
    ("attention-shard", "check_attention_shard", "K4 on a dp x tp shard == unsharded slice"),
    ("tp-sampler", "check_tp_sampler", "tp greedy rollout == replicated"),
)


def train_shapes(world: int):
    """Check 1's meshes for ``world`` ranks: the default factoring, every
    rank on "dp", and dp x 2 where ``world`` is even and larger than 2."""
    shapes = [mesh_shape(world, ("dp", "tp")), (world, 1)]
    if world > 2 and world % 2 == 0:
        shapes.append((world // 2, 2))
    return list(dict.fromkeys(shapes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=8, help="ranks to spawn")
    ap.add_argument("--device", default="cuda",
                    help="cuda (nccl, a card a rank; gloo with more ranks than cards) or cpu "
                         "(gloo)")
    args = ap.parse_args(argv)
    backend = "gloo"
    if args.device == "cuda":
        from ..ops import _build

        if not torch.cuda.is_available():
            raise SystemExit("dryrun: --device cuda but CUDA is not available; pass "
                             "--device cpu to run the checks on the CPU")

        _build.library()  # built once here, so that no two ranks build at once
        # NCCL with a card a rank; more ranks than cards share them over gloo
        if args.world <= torch.cuda.device_count():
            backend = "nccl"
    for name, fn, what in CHECKS:
        shapes = train_shapes(args.world) if fn == "check_train_step" else [None]
        meshes = []
        for shape in shapes:
            args_fn = (args.device,) if shape is None else (args.device, shape)
            out = run_world(f"audiotoken_tpu_torch.parallel.dryrun:{fn}", args.world, args_fn,
                            backend=backend, timeout=CHECK_TIMEOUT)
            meshes.append(str(out[0]["mesh"]))
        print(f"dryrun {name} OK: {args.world} ranks, mesh {', '.join(meshes)}: {what}",
              flush=True)
    print(f"dryrun OK: {args.world} ranks (train_step + dp-encode + attention-shard + "
          "tp-sampler)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
