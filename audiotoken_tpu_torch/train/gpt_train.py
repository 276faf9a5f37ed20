"""Trainer of the semantic -> acoustic GPT, on one device or over a
("dp", "tp") mesh.

Counterpart of ``audiotoken_tpu/train/gpt_train.py``: AdamW with weight
decay on the parameters of two or more dims only (optax's ``mask``;
``wte`` and ``wpe`` are decayed, LayerNorm scales are not), after
``optax.clip_by_global_norm``'s clip: ``g / norm * max_norm`` where the
global norm reaches ``max_norm``, ``g`` untouched below it
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead).
The forward and backward are plain PyTorch (the JAX package's training
forward is plain einsums too), under a precision policy: ``"default"``
allows TF32 matmuls on the card, as the JAX loss runs at
``Precision.DEFAULT``.

Over a mesh (``parallel/mesh.py``) the step computes the same function as
on one device, as JAX's jit over its mesh does. Each rank holds its
Megatron shard of the weights (``parallel/shard.py:gpt_param_spec``) and
of the optimizer state, and the GPT runs tensor parallel over "tp"
(``nn/gpt.py``). Each "dp" rank takes its share of the batch's rows; its
loss divides its rows' summed negative log-likelihoods by the valid
targets of the whole batch, so that the gradients, summed over dp, are
those of the batch's loss. The global-norm clip adds the squared norms of
the tp-sharded gradients over tp and counts the replicated ones once.
JAX's ``with_sharding_constraint(P("dp", "tp", None))`` on the
activations is a layout hint that leaves the function as it is; the
activations here stay whole on every tp rank.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..encoders import mesh_device
from ..nn.gpt import GPT, GPTConfig, gpt_loss, init_gpt_params
from ..parallel.collectives import all_reduce
from ..parallel.shard import gpt_param_spec, shard_tree
from ..runtime.precision import get_policy
from ..weights import gpt_from_numpy


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0


def make_optimizer(model: GPT, tc: TrainConfig) -> torch.optim.AdamW:
    """AdamW (optax's eps 1e-8) in two groups: decay on parameters with
    ndim >= 2, none on the rest."""
    params = list(model.parameters())
    return torch.optim.AdamW(
        [{"params": [p for p in params if p.ndim >= 2], "weight_decay": tc.weight_decay},
         {"params": [p for p in params if p.ndim < 2], "weight_decay": 0.0}],
        lr=tc.learning_rate, betas=(tc.b1, tc.b2), eps=1e-8)


def clip_by_global_norm(grads, max_norm: float, sharded=None, tp=None) -> None:
    """Scale ``grads`` in place as optax's ``clip_by_global_norm`` does,
    with no host synchronisation. Under tensor parallelism ``sharded``
    flags the gradients split over the mesh axis ``tp``: their squared
    norms are summed over tp, the others' counted once."""
    if tp is not None and tp.size > 1:
        sq = [torch.linalg.vector_norm(g).square() for g in grads]
        zero = torch.zeros((), device=grads[0].device)
        split = sum((q for q, s in zip(sq, sharded) if s), zero)
        whole = sum((q for q, s in zip(sq, sharded) if not s), zero)
        norm = (all_reduce(split, tp) + whole).sqrt()
    else:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class TrainStep:
    """The GPT, its optimizer and one training step.

    ``params`` is a JAX-layout tree (``weights.get_semantic_gpt_params``,
    ``weights.gpt_to_numpy``), else seeded random init. The model trains in
    f32 on ``device``; ``step(idx, targets)`` runs forward, backward, clip
    and update and returns the loss (a 0-d device tensor, not waited for).
    With ``mesh`` every rank passes the whole batch, as JAX's step takes
    the global arrays, and gets the whole batch's loss; ``self.model`` is
    the rank's shard, on the mesh's device (``parallel/shard.py:
    join_shards`` over every rank's ``weights.gpt_to_numpy(self.model)``
    gives the whole tree back).
    """

    def __init__(self, cfg: GPTConfig, tc: TrainConfig = TrainConfig(), params=None,
                 seed: int = 0, device="cuda", precision: str = "default", mesh=None):
        self.device = mesh_device(device, mesh)
        self.mesh = mesh
        self.cfg = cfg
        self.tc = tc
        self.policy = get_policy(precision)
        if params is None:
            params = init_gpt_params(np.random.default_rng(seed), cfg)
        self.dp = self.tp = None
        if mesh is not None:
            self.dp, self.tp = mesh.axis("dp"), mesh.axis("tp")
            params = shard_tree(params, gpt_param_spec(params), mesh, mesh.rank)
        with torch.device("meta"):
            model = GPT(cfg, self.tp)
            full = dict(GPT(cfg).named_parameters())
        # cloned: on the CPU the tensors would share the caller's arrays
        model.load_state_dict({k: v.clone() for k, v in gpt_from_numpy(params).items()},
                              assign=True)
        self.model = model.to(self.device).train().requires_grad_(True)
        # the parameters split over tp: those whose shard is smaller than the whole
        self._sharded = [p.shape != full[n].shape for n, p in self.model.named_parameters()]
        self.optimizer = make_optimizer(self.model, tc)
        self.steps = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).long()

    def step(self, idx, targets) -> torch.Tensor:
        count = None
        if self.dp is not None and self.dp.size > 1:
            idx, targets = np.asarray(idx), np.asarray(targets)
            if idx.shape[0] % self.dp.size:
                raise ValueError(f"a batch of {idx.shape[0]} rows does not split over "
                                 f"dp = {self.dp.size} ranks")
            count = self._tensor((targets >= 0).sum())  # the whole batch's valid targets
            rows = idx.shape[0] // self.dp.size
            mine = slice(self.dp.index * rows, (self.dp.index + 1) * rows)
            idx, targets = idx[mine], targets[mine]
        params = list(self.model.parameters())
        with self.policy.numerics():
            self.optimizer.zero_grad(set_to_none=True)
            loss = gpt_loss(self.model, self._tensor(idx), self._tensor(targets), count)
            loss.backward()
            grads = [p.grad for p in params]
            if count is not None:
                flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.dp)
                for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                    g.copy_(part.view_as(g))
                loss = all_reduce(loss.detach(), self.dp)
            clip_by_global_norm(grads, self.tc.grad_clip, self._sharded, self.tp)
            self.optimizer.step()
        self.steps += 1
        return loss.detach()
