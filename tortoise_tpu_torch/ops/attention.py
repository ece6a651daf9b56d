"""Decode attention over the merged-channel KV cache, plain PyTorch.

Port of ``tortoise_tpu/ops/attention.py::chunked_decode_attention_merged``
for the non-fused decode path. The TPU version walks the cache in chunks
with an online softmax to bound what XLA reads; here the prefix rows
[0, cache_index] are sliced directly, which gives the same softmax.
"""
from __future__ import annotations

import numpy as np
import torch


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
