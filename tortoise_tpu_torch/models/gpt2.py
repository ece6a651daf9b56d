"""GPT-2 decoder stack with a preallocated KV cache.

Port of ``tortoise_tpu/models/gpt2.py``: pre-LN blocks (LayerNorm eps 1e-5
in float32), fused qkv, float32 softmax, gelu_new MLP and a final ``ln_f``.
Layer weights are stacked along a leading layer axis under ``h_scan.block``,
as the JAX package stacks them under ``nn.scan``; the decode kernel K2 reads
the same stack.

The cache is {"k", "v"} of (L, B, T_max, C), the JAX package's B-major
merged-channel layout. Unlike the JAX functional cache, ``forward`` writes
the new rows into the given cache tensors IN PLACE.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.layers import Dense, LayerNorm, Norm
from tortoise_tpu_torch.ops.attention import chunked_decode_attention_merged

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    n_layer: int = 30
    n_embd: int = 1024
    n_head: int = 16
    ln_eps: float = 1e-5


def gelu_new(x):
    """HF "gelu_new": the tanh approximation GPT-2 uses."""
    return 0.5 * x * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))


class _Attention(nn.Module):
    def __init__(self, c: int, lead: tuple):
        super().__init__()
        self.c_attn = Dense(c, 3 * c, lead=lead)
        self.c_proj = Dense(c, c, lead=lead)


class _Block(nn.Module):
    """All layers' parameters, stacked: (L, ...)."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        lead = (cfg.n_layer,)
        c = cfg.n_embd
        self.ln_1 = Norm(c, lead)
        self.attn = _Attention(c, lead)
        self.ln_2 = Norm(c, lead)
        self.mlp_fc = Dense(c, 4 * c, lead=lead)
        self.mlp_proj = Dense(4 * c, c, lead=lead)


def init_kv_cache(config: GPT2Config, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> dict[str, torch.Tensor]:
    """Zeroed (L, B, T_max, C) k and v buffers."""
    shape = (config.n_layer, batch, max_len, config.n_embd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class GPT2Stack(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.config = cfg
        self.h_scan = nn.Module()
        self.h_scan.block = _Block(cfg)
        self.ln_f = LayerNorm(cfg.n_embd, eps=cfg.ln_eps)

    def _ln(self, norm: Norm, x, l):
        w, b = norm.params(l)
        return F.layer_norm(x.float(), (x.shape[-1],), w, b, self.config.ln_eps)

    def _attend(self, q, k, v, cache, l, cache_index):
        b, t, c = q.shape
        h = self.config.n_head
        dh = c // h
        dtype = q.dtype
        if cache is not None:
            kc, vc = cache["k"], cache["v"]
            kc[l, :, cache_index:cache_index + t] = k.to(kc.dtype)
            vc[l, :, cache_index:cache_index + t] = v.to(vc.dtype)
            if t == 1 and kc.shape[2] % 256 == 0:
                return chunked_decode_attention_merged(q[:, 0], kc, vc, l, cache_index,
                                                       heads=h)[:, None]
            n = cache_index + t     # keys past the last query are masked anyway
            k, v = kc[l, :, :n].to(dtype), vc[l, :, :n].to(dtype)
        n = k.shape[1]
        qh = q.reshape(b, t, h, dh).transpose(1, 2)
        kh = k.reshape(b, n, h, dh).transpose(1, 2)
        vh = v.reshape(b, n, h, dh).transpose(1, 2)
        logits = torch.einsum("bhtd,bhsd->bhts", qh.float(), kh.float()) / np.sqrt(dh)
        query_pos = (n - t) + torch.arange(t, device=q.device)[:, None]
        mask = torch.arange(n, device=q.device)[None, :] <= query_pos
        logits = logits.masked_fill(~mask, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(dtype)
        return torch.einsum("bhts,bhsd->bhtd", w, vh).transpose(1, 2).reshape(b, t, c)

    def forward(self, emb, cache=None, cache_index: int = 0):
        """emb: (B, T, C). With ``cache`` the new keys/values land at
        [cache_index, cache_index + T) (in place) and attention covers the
        cached prefix; otherwise plain causal attention. Returns
        (ln_f(x) in the compute dtype, cache)."""
        blk = self.h_scan.block
        dtype = blk.attn.c_attn.weight.dtype
        c = self.config.n_embd
        x = emb.to(dtype)
        for l in range(self.config.n_layer):
            h = self._ln(blk.ln_1, x, l).to(dtype)
            q, k, v = blk.attn.c_attn(h, l).split(c, dim=-1)
            x = x + blk.attn.c_proj(self._attend(q, k, v, cache, l, cache_index), l)
            h = self._ln(blk.ln_2, x, l).to(dtype)
            x = x + blk.mlp_proj(gelu_new(blk.mlp_fc(h, l)), l)
        return self.ln_f(x).to(dtype), cache
