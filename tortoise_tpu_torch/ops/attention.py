"""Decode attention over the KV cache, plain PyTorch.

``chunked_decode_attention_merged`` ports the JAX package's function of
that name for the non-fused decode path over the merged (L, B, T, C) cache.
The TPU version walks the cache in chunks with an online softmax to bound
what XLA reads; here the prefix rows [0, cache_index] are sliced directly,
which gives the same softmax.

``chunked_decode_attention_layered`` ports the per-head (L, B, H, T, D)
form, chunks and online softmax kept: no model path reads that layout any
more; ``tools/bench_decode_attn_merged.py`` times it against the merged one.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e9


def chunked_decode_attention_layered(q, ck, cv, layer_idx: int, cache_index: int,
                                     chunk: int = 256, k_scale=None,
                                     v_scale=None) -> torch.Tensor:
    """q (B, H, 1, D); ck / cv (L, B, H, T_max, D). Flash-decode over rows
    0..cache_index of layer ``layer_idx`` in chunks of ``chunk`` rows, an
    online softmax in float32. With the int8 cache, ``k_scale`` /
    ``v_scale`` (L, B, H, T_max, 1) factor out of the products: k scales
    multiply the logits, v scales the weights after their sum. Returns
    (B, H, 1, D) in q's dtype."""
    b, h, _, d = q.shape
    n = cache_index + 1
    qf = q.float()
    m = torch.full((b, h, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, 1), device=q.device)
    acc = torch.zeros((b, h, 1, d), device=q.device)
    for start in range(0, n, chunk):
        blk = lambda buf: buf[layer_idx, :, :, start:start + chunk]
        k_blk, v_blk = blk(ck), blk(cv)
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float()) * (1.0 / np.sqrt(d))
        if k_scale is not None:
            logits = logits * blk(k_scale).transpose(2, 3)
        pos = start + torch.arange(k_blk.shape[2], device=q.device)
        logits = torch.where(pos < n, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = p if v_scale is None else p * blk(v_scale).transpose(2, 3)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", pv, v_blk.float())
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def chunked_decode_attention_merged(q, ck, cv, layer_idx: int, cache_index: int, *,
                                    heads: int, k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B, C); ck/cv: (L, B, T_max, C). Attends to rows 0..cache_index of
    layer ``layer_idx`` in float32; returns (B, C) in q's dtype. With the
    int8 cache, ``k_scale``/``v_scale`` (L, B, H, T_max) factor out of the
    dot products: k scales multiply the logits, v scales the softmax weights
    (whose sum runs over the unscaled weights)."""
    b, c = q.shape
    dh = c // heads
    n = cache_index + 1
    k = ck[layer_idx, :, :n].float().reshape(b, n, heads, dh)
    v = cv[layer_idx, :, :n].float().reshape(b, n, heads, dh)
    qf = q.float().reshape(b, heads, dh)
    logits = torch.einsum("bhd,bthd->bht", qf, k) / np.sqrt(dh)
    if k_scale is not None:
        logits = logits * k_scale[layer_idx, :, :, :n]
    w = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        w = w * v_scale[layer_idx, :, :, :n]
    return torch.einsum("bht,bthd->bhd", w, v).reshape(b, c).to(q.dtype)
