"""Training step for the UnifiedVoice prior (the training contract).

Port of ``tortoise_tpu/training/train_step.py``. The
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

Over a ("dp", "tp") mesh (``init_sharded_train_state``, ``make_train_step(...,
mesh=mesh)``) the step writes out what GSPMD adds to the JAX package's: each
rank takes its rows of the batch, UnifiedVoice's parameters are split
Megatron-style over tp (``parallel.sharding``, its autograd pair in the GPT
stack and the heads), the gradients are averaged over dp, and the norm is the
unsplit gradient's. The optimizer's moments follow their parameter's split.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from tortoise_tpu_torch.parallel.mesh import batch_sharding, replicate_tree, shard_batch
from tortoise_tpu_torch.parallel.sharding import TensorParallel, shard_unified_voice


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all elements, a float32 scalar.
    Each leaf's norm is taken in float64: in float32 a large leaf's drifts
    on the CPU, where torch.linalg.vector_norm accumulates sequentially
    (-1.3% over the 126M elements of UnifiedVoice's stacked mlp_fc)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t, dtype=torch.float64) for t in tensors])).float()


def split_global_norm(tensors: list[torch.Tensor], split: list[bool],
                      tp: TensorParallel) -> torch.Tensor:
    """``global_norm`` of gradients of which ``split`` mark the tp-split
    leaves: their float64 square sums are all-reduced over tp, and each
    whole leaf, the same on every rank, is counted once."""
    sq = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64) for t in tensors]) ** 2
    mask = torch.tensor(split, device=sq.device)
    parts = sq[mask].sum()
    dist.all_reduce(parts, group=tp.group)
    return (parts + sq[~mask].sum()).sqrt().float()


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
               params: list[torch.Tensor], norm: torch.Tensor | None = None) -> torch.Tensor:
        """One step in place over ``params``, ``grads`` and ``opt_state``.
        Returns the gradients' global norm before clipping (a device
        scalar: nothing here waits for the card); ``norm`` gives it when the
        gradients are split over ranks."""
        norm = global_norm(grads) if norm is None else norm
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


def init_sharded_train_state(model: nn.Module, optimizer: Optimizer, mesh) -> TrainState:
    """The JAX package's ``init_sharded_train_state``: the weights broadcast
    from the mesh's first rank, UnifiedVoice's split over tp in place
    (``parallel.sharding.shard_unified_voice``), and the train state of
    this rank's parts."""
    replicate_tree(model, mesh)
    shard_unified_voice(model, mesh)
    return init_train_state(model, optimizer)


def _dp_mean(tensors: list[torch.Tensor], group) -> None:
    """In place: each tensor averaged over the dp group, in one all-reduce."""
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, mean in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(mean)


def make_train_step(model: nn.Module, optimizer: Optimizer,
                    loss_fn: Callable = unified_voice_loss, mesh=None):
    """(state, batch) -> (state, metrics): ``loss_fn(model, batch)`` ->
    (loss, aux), its gradients, one optimizer update. The metrics are the
    loss, the aux terms and ``grad_norm``, the global norm before clipping,
    as device tensors. A parameter the loss does not reach has a zero
    gradient, so it is decayed as optax decays it.

    With ``mesh`` (the state from ``init_sharded_train_state``) each rank
    takes its rows of the global batch, which must divide by dp; the loss
    is a mean over every position, so the mean of the dp ranks' gradients
    and losses is the global batch's."""
    shard = batch_sharding(mesh) if mesh is not None else None

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = list(state.params.values())
        if shard is not None:
            batch = {k: shard_batch(v, mesh) for k, v in batch.items()}
        for p in params:
            p.grad = None
        loss, aux = loss_fn(model, batch)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        for p in params:
            p.grad = None
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
        if shard is not None and shard.size > 1:
            _dp_mean(grads, shard.group)
            _dp_mean(list(metrics.values()), shard.group)
        tp = getattr(model, "tp", None)
        norm = None if tp is None else split_global_norm(
            grads, [n in tp.split for n in state.params], tp)
        metrics["grad_norm"] = optimizer.update(grads, state.opt_state, params, norm)
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step
