"""Logit processors and samplers for autoregressive decoding.

Port of ``tortoise_tpu/ops/sampling.py``: the HF ``generate`` warper order
repetition_penalty -> [typical] -> temperature -> top_k -> top_p, on (B, V)
float32 logits. Random draws take an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch

from tortoise_tpu_torch.parallel.mesh import draw_rows

NEG_INF = -float("inf")


def apply_repetition_penalty(logits, seen, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor over the ``seen`` (B, V) bool set."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


def apply_temperature(logits, temperature: float):
    return logits if temperature == 1.0 else logits / temperature


def apply_top_k(logits, k: int):
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits, top_p: float):
    """HF TopPLogitsWarper: ascending sort, drop tokens whose cumulative
    probability is <= 1 - p, always keep one."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    remove = cum <= (1.0 - top_p)
    remove[..., -1] = False
    threshold = torch.where(remove, sorted_logits,
                            torch.full_like(sorted_logits, NEG_INF)).amax(-1, keepdim=True)
    return logits.masked_fill(logits <= threshold, NEG_INF)


def apply_typical(logits, mass: float = 0.9):
    """Typical sampling (reference tortoise/utils/typical_sampling.py:5-33)."""
    normalized = torch.log_softmax(logits, dim=-1)
    p = normalized.exp()
    ent = -torch.where(p > 0, normalized * p, torch.zeros_like(p)).sum(-1, keepdim=True)
    shifted = (-normalized - ent).abs()
    order = torch.argsort(shifted, dim=-1)
    sorted_logits = logits.gather(-1, order)
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    last_ind = (cum < mass).sum(-1, keepdim=True)
    cutoff = shifted.gather(-1, order).gather(-1, last_ind)
    return logits.masked_fill(shifted > cutoff, NEG_INF)


def process_logits(logits, seen, *, repetition_penalty: float = 2.0,
                   temperature: float = 0.8, top_k: int = 50, top_p: float = 0.8,
                   typical_mass: float | None = None):
    """The full warper chain in HF order."""
    logits = apply_repetition_penalty(logits.float(), seen, repetition_penalty)
    if typical_mass is not None:
        logits = apply_typical(logits, typical_mass)
    logits = apply_temperature(logits, temperature)
    logits = apply_top_k(logits, top_k)
    return apply_top_p(logits, top_p)


def categorical(generator: torch.Generator, logits, shard=None):
    """One draw per row of (B, V) ``logits`` from their softmax, the draw
    ``torch.multinomial(probs, 1, generator=generator)`` makes: argmax(probs
    / q) with q ~ Exp(1) over the whole (B, V), without multinomial's host
    sync. With ``shard`` (``parallel.mesh.BatchShard``) the rows are this
    rank's part of a batch split over dp: q is drawn at the global batch's
    shape from the generator every rank holds alike, and this rank's rows
    are taken, so each row draws what it draws unsplit."""
    probs = torch.softmax(logits, dim=-1)
    q = draw_rows(lambda n: torch.empty((n, probs.shape[1]), dtype=probs.dtype,
                                        device=probs.device).exponential_(1, generator=generator),
                  probs.shape[0], shard)
    return (probs / q).argmax(dim=-1)


def sample_topk_topp(generator: torch.Generator, logits, seen, *,
                     repetition_penalty: float = 2.0, temperature: float = 0.8,
                     top_k: int = 50, top_p: float = 0.8, shard=None):
    """Same distribution as ``process_logits`` + a categorical draw, with the
    sort and cumsum done on the (B, top_k) subset: top-k precedes top-p in
    HF's order, so nucleus filtering inside the top-k values is exact."""
    logits = apply_repetition_penalty(logits.float(), seen, repetition_penalty)
    logits = apply_temperature(logits, temperature)
    k = min(top_k, logits.shape[-1]) if top_k > 0 else logits.shape[-1]
    vals, idx = torch.topk(logits, k, dim=-1)        # descending
    if top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        cum_before = probs.cumsum(dim=-1) - probs
        vals = vals.masked_fill(cum_before >= top_p, NEG_INF)
    r = categorical(generator, vals, shard)
    return idx.gather(-1, r[..., None])[..., 0]
