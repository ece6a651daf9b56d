"""The x-transformers encoder subset CLVP uses.

Port of ``tortoise_tpu/models/xtransformer.py``: pre-norm RMSNorm, GEGLU
feed-forward (exact erf GELU), rotary embeddings on the first 32 channels
of q, k and v (the vendored version's quirk), a final LayerNorm. Depth is
stacked under ``layers_scan`` as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.layers import Dense, LayerNorm


class RMSNorm(nn.Module):
    """x / max(||x|| d^-1/2, eps) * g."""

    def __init__(self, dim: int, eps: float = 1e-8, lead: tuple = ()):
        super().__init__()
        self.g = nn.Parameter(torch.ones(*lead, dim))
        self.dim, self.eps = dim, eps

    def forward(self, x, l: int | None = None):
        g = self.g if l is None else self.g[l]
        norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True) * self.dim ** -0.5
        return (x / norm.clamp(min=self.eps) * g.float()).to(x.dtype)


def rotary_freqs(seq_len: int, rot_dim: int) -> np.ndarray:
    inv_freq = 1.0 / (10000 ** (np.arange(0, rot_dim, 2, dtype=np.float32) / rot_dim))
    freqs = np.einsum("i,j->ij", np.arange(seq_len, dtype=np.float32), inv_freq)
    return np.concatenate([freqs, freqs], axis=-1)


def apply_rotary(t, freqs):
    d = t.shape[-1]
    rotated = torch.cat([-t[..., d // 2:], t[..., : d // 2]], dim=-1)
    return t * freqs.cos() + rotated * freqs.sin()


class EncoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int = 64, rot_dim: int = 32,
                 lead: tuple = ()):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.rot_dim = heads, dim_head, rot_dim
        self.to_q = Dense(dim, inner, bias=False, lead=lead)
        self.to_k = Dense(dim, inner, bias=False, lead=lead)
        self.to_v = Dense(dim, inner, bias=False, lead=lead)
        self.to_out = Dense(inner, dim, lead=lead)

    def forward(self, x, l: int | None = None, mask=None):
        """``mask`` (B, T) bool: a logit counts only where its query and its
        key are both kept."""
        b, n, _ = x.shape
        h, dh, r = self.heads, self.dim_head, self.rot_dim
        q, k, v = (f(x, l).reshape(b, n, h, dh).transpose(1, 2)
                   for f in (self.to_q, self.to_k, self.to_v))
        freqs = torch.as_tensor(rotary_freqs(n, r), device=x.device)
        # float32 after the rotation, as jnp.concatenate promotes it
        rot = lambda t: torch.cat([apply_rotary(t[..., :r].float(), freqs), t[..., r:].float()],
                                  dim=-1)
        q, k, v = rot(q), rot(k), rot(v)
        logits = torch.einsum("bhid,bhjd->bhij", q, k) * dh ** -0.5
        if mask is not None:
            pair = mask[:, None, :, None] & mask[:, None, None, :]
            logits = logits.masked_fill(~pair, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhij,bhjd->bhid", attn, v.to(x.dtype))
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh), l)


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: float = 2.0, lead: tuple = ()):
        super().__init__()
        inner = int(dim * mult)
        self.proj = Dense(dim, inner * 2, lead=lead)
        self.out = Dense(inner, dim, lead=lead)

    def forward(self, x, l: int | None = None):
        val, gate = self.proj(x, l).chunk(2, dim=-1)
        return self.out(val * F.gelu(gate), l)


class _EncoderLayers(nn.Module):
    """All layers' parameters, stacked: (depth, ...)."""

    def __init__(self, dim: int, heads: int, ff_mult: float, depth: int):
        super().__init__()
        lead = (depth,)
        self.attn_norm = RMSNorm(dim, lead=lead)
        self.attn = EncoderAttention(dim, heads, lead=lead)
        self.ff_norm = RMSNorm(dim, lead=lead)
        self.ff = GEGLUFeedForward(dim, ff_mult, lead=lead)


class XTransformerEncoder(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, ff_mult: float = 2.0):
        super().__init__()
        self.depth = depth
        self.layers_scan = _EncoderLayers(dim, heads, ff_mult, depth)
        self.final_norm = LayerNorm(dim)

    def forward(self, x, mask=None):
        ls = self.layers_scan
        for l in range(self.depth):
            x = x + ls.attn(ls.attn_norm(x, l), l, mask=mask)
            x = x + ls.ff(ls.ff_norm(x, l), l)
        return self.final_norm(x).to(x.dtype)
