"""CLVP, the quality pipeline's text-speech re-ranker, as a plain float32
model.

Reference tortoise/models/clvp.py:99-140 with the x-transformers encoders
it builds (tortoise/models/xtransformers.py): token embeddings, pre-norm
RMSNorm blocks of attention (rotary embeddings on the first 32 channels of
q, k and v, the vendored version's quirk) and a GEGLU feed-forward (exact
GELU), a final LayerNorm, the mean over positions, a projection without
bias, and the cosine of the text's and each speech candidate's latents
times exp(temperature). A candidate holding a code outside the speech
vocabulary scores -inf.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import Dense, Embed, LayerNorm

DIM_HEAD, ROT_DIM = 64, 32


class RMSNorm(nn.Module):
    def __init__(self, dim: int, lead=()):
        super().__init__()
        self.g = nn.Parameter(torch.ones(*lead, dim))

    def forward(self, x, l):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * x.shape[-1] ** -0.5
        return x / norm.clamp(min=1e-8) * self.g[l].float()


def rotate(t: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of (B, H, T, ROT_DIM) by position."""
    n = t.shape[-2]
    inv = 1.0 / (10000 ** (np.arange(0, ROT_DIM, 2, dtype=np.float64) / ROT_DIM))
    ang = np.arange(n, dtype=np.float64)[:, None] * inv[None]
    ang = torch.as_tensor(np.concatenate([ang, ang], -1), dtype=torch.float32, device=t.device)
    half = ROT_DIM // 2
    return t * ang.cos() + torch.cat([-t[..., half:], t[..., :half]], -1) * ang.sin()


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, lead):
        super().__init__()
        inner = heads * DIM_HEAD
        self.heads = heads
        self.to_q = Dense(dim, inner, bias=False, lead=lead)
        self.to_k = Dense(dim, inner, bias=False, lead=lead)
        self.to_v = Dense(dim, inner, bias=False, lead=lead)
        self.to_out = Dense(inner, dim, lead=lead)

    def forward(self, x, l):
        b, n, _ = x.shape
        q, k, v = (f(x, l).reshape(b, n, self.heads, DIM_HEAD).transpose(1, 2)
                   for f in (self.to_q, self.to_k, self.to_v))
        q, k, v = (torch.cat([rotate(t[..., :ROT_DIM]), t[..., ROT_DIM:]], -1) for t in (q, k, v))
        w = torch.softmax(q @ k.transpose(-1, -2) * DIM_HEAD ** -0.5, dim=-1)
        return self.to_out((w @ v).transpose(1, 2).reshape(b, n, -1), l)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, lead):
        super().__init__()
        self.proj = Dense(dim, 4 * dim, lead=lead)
        self.out = Dense(2 * dim, dim, lead=lead)

    def forward(self, x, l):
        val, gate = self.proj(x, l).chunk(2, dim=-1)
        return self.out(val * F.gelu(gate), l)


class _Layers(nn.Module):
    def __init__(self, dim: int, heads: int, depth: int):
        super().__init__()
        lead = (depth,)
        self.attn_norm = RMSNorm(dim, lead)
        self.attn = _Attention(dim, heads, lead)
        self.ff_norm = RMSNorm(dim, lead)
        self.ff = _FeedForward(dim, lead)


class Encoder(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int):
        super().__init__()
        self.depth = depth
        self.layers_scan = _Layers(dim, heads, depth)
        self.final_norm = LayerNorm(dim)

    def forward(self, x):
        ls = self.layers_scan
        x = x.float()
        for l in range(self.depth):
            x = x + ls.attn(ls.attn_norm(x, l), l)
            x = x + ls.ff(ls.ff_norm(x, l), l)
        return self.final_norm(x)


class CLVP(nn.Module):
    def __init__(self, dim: int = 768, depth: int = 20, heads: int = 12, text_tokens: int = 256,
                 speech_tokens: int = 8192):
        super().__init__()
        self.speech_tokens = speech_tokens
        self.text_emb = Embed(text_tokens, dim)
        self.speech_emb = Embed(speech_tokens, dim)
        self.text_transformer = Encoder(dim, depth, heads)
        self.speech_transformer = Encoder(dim, depth, heads)
        self.to_text_latent = Dense(dim, dim, bias=False)
        self.to_speech_latent = Dense(dim, dim, bias=False)
        self.temperature = nn.Parameter(torch.ones(()))

    @staticmethod
    def _latent(x, encoder, proj):
        lat = proj(encoder(x).mean(dim=1))
        return lat / torch.linalg.vector_norm(lat, dim=-1, keepdim=True)

    def scores(self, text: torch.Tensor, candidates: torch.Tensor, rows: int = 32):
        """text (1, Tt) against candidates (B, Ts) -> (B,) float32, in blocks
        of ``rows`` candidates."""
        tl = self._latent(self.text_emb(text), self.text_transformer, self.to_text_latent)
        out = []
        for block in candidates.split(rows):
            bad = (block < 0) | (block >= self.speech_tokens)
            sl = self._latent(self.speech_emb(block.clamp(0, self.speech_tokens - 1)),
                              self.speech_transformer, self.to_speech_latent)
            s = (sl @ tl[0]) * self.temperature.float().exp()
            out.append(s.masked_fill(bad.any(dim=1), -float("inf")))
        return torch.cat(out)
