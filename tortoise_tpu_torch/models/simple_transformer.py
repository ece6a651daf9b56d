"""CLVP's plain-Transformer variant (``use_xformers=False``).

Port of ``tortoise_tpu/models/simple_transformer.py`` (reference
tortoise/models/transformer.py:182-219). Each layer has two residual
branches, ``x += LayerScale(PreNorm(attention))`` and ``x += LayerScale(
PreNorm(GEGLU feed-forward))``; LayerScale (CaiT, arXiv:2103.17239) starts
each channel's gain at an epsilon chosen by the 1-based layer index. There
is no rotary embedding: the caller adds learned absolute positions. Layers
are separate modules under ``block_{i}``, as in the JAX package, where the
per-layer init breaks the scan's homogeneity. ``dtype`` is the products'
compute dtype and that of the attention weights (None: the weights', and
the input's).
"""
from __future__ import annotations

import torch
from torch import nn

from tortoise_tpu_torch.models.layers import Dense, LayerNorm, gelu


def layerscale_init(layer_index_1based: int) -> float:
    """CaiT's initial LayerScale gain by depth (reference transformer.py:81-87)."""
    if layer_index_1based <= 18:
        return 0.1
    if layer_index_1based <= 24:
        return 1e-5
    return 1e-6


class SimpleAttention(nn.Module):
    """Multi-head attention: bias-free fused qkv, scaled dot product, an
    optional key-padding mask (B, T) True = keep, an optional causal mask,
    a biased output projection (reference transformer.py:135-178). Masked
    logits take the dtype's lowest value; the softmax runs in float32."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64, causal: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.heads, self.dim_head, self.causal, self.dtype = heads, dim_head, causal, dtype
        inner = heads * dim_head
        self.to_qkv = Dense(dim, 3 * inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x, mask=None):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        q, k, v = (t.reshape(b, n, h, dh).transpose(1, 2) for t in self.to_qkv(x).chunk(3, -1))
        dots = torch.einsum("bhid,bhjd->bhij", q * dh ** -0.5, k)
        neg = torch.finfo(dots.dtype).min
        if mask is not None:
            dots = dots.masked_fill(~mask[:, None, None, :], neg)
        if self.causal:
            keep = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
            dots = dots.masked_fill(~keep, neg)
        attn = torch.softmax(dots.float(), dim=-1).to(x.dtype if self.dtype is None
                                                       else self.dtype)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))


class SimpleFeedForward(nn.Module):
    """GEGLU: one widening product to 2 * mult * dim, the value half gated
    by the exact (erf) GELU of the gate half, a product back to dim
    (reference transformer.py:112-130)."""

    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.ff_in = Dense(dim, dim * mult * 2, dtype=dtype)
        self.ff_out = Dense(dim * mult, dim, dtype=dtype)

    def forward(self, x):
        val, gate = self.ff_in(x).chunk(2, dim=-1)
        return self.ff_out(val * gelu(gate, self.dtype))


class SimpleTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, layer_index: int, dim_head: int = 64,
                 ff_mult: int = 4, causal: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        # the LayerScale gains' initial value (weights.init_random)
        self.layerscale = layerscale_init(layer_index)
        self.attn_scale = nn.Parameter(torch.full((dim,), self.layerscale))
        self.ff_scale = nn.Parameter(torch.full((dim,), self.layerscale))
        self.attn_norm = LayerNorm(dim)
        self.attn = SimpleAttention(dim, heads, dim_head, causal, dtype)
        self.ff_norm = LayerNorm(dim)
        self.ff = SimpleFeedForward(dim, ff_mult, dtype)

    def forward(self, x, mask=None):
        x = x + self.attn(self.attn_norm(x).to(x.dtype), mask=mask) * self.attn_scale
        return x + self.ff(self.ff_norm(x).to(x.dtype)) * self.ff_scale


class SimpleTransformer(nn.Module):
    """A stack of SimpleTransformerBlocks, the mask routed to attention
    only, no input or output norm (reference transformer.py:182-219)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int = 64, ff_mult: int = 4,
                 causal: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", SimpleTransformerBlock(
                dim, heads, i + 1, dim_head=dim_head, ff_mult=ff_mult, causal=causal,
                dtype=dtype))

    def forward(self, x, mask=None):
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, mask=mask)
        return x
