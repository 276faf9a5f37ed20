"""Trainer of the semantic -> acoustic GPT on one device.

Counterpart of ``audiotoken_tpu/train/gpt_train.py`` without its mesh:
AdamW with weight decay on the parameters of two or more dims only (optax's
``mask``; ``wte`` and ``wpe`` are decayed, LayerNorm scales are not), after
``optax.clip_by_global_norm``'s clip: ``g / norm * max_norm`` where the
global norm reaches ``max_norm``, ``g`` untouched below it
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead).
The forward and backward are plain PyTorch (the JAX package's training
forward is plain einsums too), under a precision policy: ``"default"``
allows TF32 matmuls on the card, as the JAX loss runs at
``Precision.DEFAULT``.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..encoders import resolve_device
from ..nn.gpt import GPT, GPTConfig, gpt_loss, init_gpt_params
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


def clip_by_global_norm(grads, max_norm: float) -> None:
    """Scale ``grads`` in place as optax's ``clip_by_global_norm`` does,
    with no host synchronisation."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class TrainStep:
    """The GPT, its optimizer and one training step.

    ``params`` is a JAX-layout tree (``weights.get_semantic_gpt_params``,
    ``weights.gpt_to_numpy``), else seeded random init. The model trains in
    f32 on ``device``; ``step(idx, targets)`` runs forward, backward, clip
    and update and returns the loss (a 0-d device tensor, not waited for).
    """

    def __init__(self, cfg: GPTConfig, tc: TrainConfig = TrainConfig(), params=None,
                 seed: int = 0, device="cuda", precision: str = "default", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "gpt_train: data and tensor parallel over a ('dp', 'tp') mesh come with the "
                "multi-card slice of the port (ROADMAP Queue 1); train on one device")
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.policy = get_policy(precision)
        if params is None:
            params = init_gpt_params(np.random.default_rng(seed), cfg)
        with torch.device("meta"):
            model = GPT(cfg)
        # cloned: on the CPU the tensors would share the caller's arrays
        model.load_state_dict({k: v.clone() for k, v in gpt_from_numpy(params).items()},
                              assign=True)
        self.model = model.to(self.device).train().requires_grad_(True)
        self.optimizer = make_optimizer(self.model, tc)
        self.steps = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).long()

    def step(self, idx, targets) -> torch.Tensor:
        with self.policy.numerics():
            self.optimizer.zero_grad(set_to_none=True)
            loss = gpt_loss(self.model, self._tensor(idx), self._tensor(targets))
            loss.backward()
            clip_by_global_norm([p.grad for p in self.model.parameters()], self.tc.grad_clip)
            self.optimizer.step()
        self.steps += 1
        return loss.detach()
