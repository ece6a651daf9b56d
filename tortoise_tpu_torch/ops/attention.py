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
                                    heads: int) -> torch.Tensor:
    """q: (B, C); ck/cv: (L, B, T_max, C). Attends to rows 0..cache_index of
    layer ``layer_idx`` in float32; returns (B, C) in q's dtype."""
    b, c = q.shape
    dh = c // heads
    n = cache_index + 1
    k = ck[layer_idx, :, :n].float().reshape(b, n, heads, dh)
    v = cv[layer_idx, :, :n].float().reshape(b, n, heads, dh)
    qf = q.float().reshape(b, heads, dh)
    logits = torch.einsum("bhd,bthd->bht", qf, k) / np.sqrt(dh)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bthd->bhd", w, v).reshape(b, c).to(q.dtype)
