"""Training step for the UnifiedVoice prior (the training contract).

Port of ``tortoise_tpu/training/train_step.py`` on one device. The
reference ships no training loop (training lived in DL-Art-School) but its
models keep the training-only paths that define the contract: UnifiedVoice's
dual text/mel cross-entropy (``models/autoregressive.py``), the diffusion
losses (``diffusion/losses.py``) and CLVP's and CVVP's contrastive losses
(``models/clvp.py``, ``models/cvvp.py``).

The optimizer is the JAX package's optax chain written out: clip to global
norm 1.0 (optax's rule: scale by max_norm / norm only when norm >=
max_norm), then AdamW (b1 0.9, b2 0.96, eps 1e-8, decoupled weight decay)
under a linear warmup from 0, so the first step changes no parameter. As in
optax, every trained parameter is decayed, also one the loss does not reach
(UnifiedVoice's conditioning encoder: the batch carries ``cond_latent``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all elements, a float32 scalar.
    Each leaf's norm is taken in float64: in float32 a large leaf's drifts
    on the CPU, where torch.linalg.vector_norm accumulates sequentially
    (-1.3% over the 126M elements of UnifiedVoice's stacked mlp_fc)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t, dtype=torch.float64) for t in tensors])).float()


# the JAX package's optax chain: clip_by_global_norm(1.0), then adamw(...,
# b1=0.9, b2=0.96) at optax's eps
MAX_NORM, B1, B2, EPS = 1.0, 0.9, 0.96, 1e-8


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``optax.chain(clip_by_global_norm(MAX_NORM), adamw(linear_schedule(0,
    lr, warmup), B1, B2, EPS, weight_decay=weight_decay))``."""
    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup: int = 100

    def init(self, params: list[torch.Tensor]) -> dict:
        """Zeroed first and second moments, and the update count."""
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params], "count": 0}

    def learning_rate(self, count: int) -> float:
        return self.lr * min(count, self.warmup) / self.warmup

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], opt_state: dict,
               params: list[torch.Tensor]) -> torch.Tensor:
        """One step in place over ``params``, ``grads`` and ``opt_state``.
        Returns the gradients' global norm before clipping (a device
        scalar: nothing here waits for the card)."""
        norm = global_norm(grads)
        # g / norm * MAX_NORM where norm >= MAX_NORM, else g
        torch._foreach_div_(grads, torch.where(norm < MAX_NORM, 1.0, norm / MAX_NORM))
        lr = self.learning_rate(opt_state["count"])
        opt_state["count"] += 1
        n = opt_state["count"]
        mu, nu = opt_state["mu"], opt_state["nu"]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - B2)
        denom = torch._foreach_div(nu, 1 - B2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu, 1 - B1 ** n)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        return norm


@dataclasses.dataclass
class TrainState:
    """``params``: the model's trained parameters by name (the module's own
    tensors, updated in place); ``opt_state``: ``Optimizer.init``'s moments
    and count; ``step``: steps taken."""
    params: dict[str, nn.Parameter]
    opt_state: dict
    step: int


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01,
                   warmup: int = 100) -> Optimizer:
    """The JAX package's ``make_optimizer``. Like an optax transformation it
    holds no parameters: its state is ``TrainState.opt_state``."""
    return Optimizer(lr=lr, weight_decay=weight_decay, warmup=warmup)


def unified_voice_loss(model, batch: dict, text_loss_weight: float = 0.01):
    """Dual CE loss (mel-weighted, DL-Art-School style): loss_mel +
    text_loss_weight * loss_text, and the two terms."""
    loss_text, loss_mel, _ = model(batch["cond_latent"], batch["text_tokens"],
                                   batch["mel_codes"], batch["wav_lengths"])
    return loss_mel + text_loss_weight * loss_text, {"loss_text": loss_text,
                                                     "loss_mel": loss_mel}


def init_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    """The train state of ``model``'s trainable parameters, on their device."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    return TrainState(params, optimizer.init(list(params.values())), 0)


def make_train_step(model: nn.Module, optimizer: Optimizer,
                    loss_fn: Callable = unified_voice_loss):
    """(state, batch) -> (state, metrics): ``loss_fn(model, batch)`` ->
    (loss, aux), its gradients, one optimizer update. The metrics are the
    loss, the aux terms and ``grad_norm``, the global norm before clipping,
    as device tensors. A parameter the loss does not reach has a zero
    gradient, so it is decayed as optax decays it."""

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = list(state.params.values())
        for p in params:
            p.grad = None
        loss, aux = loss_fn(model, batch)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        for p in params:
            p.grad = None
        grad_norm = optimizer.update(grads, state.opt_state, params)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                   "grad_norm": grad_norm}
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step
