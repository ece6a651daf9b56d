"""CVVP: contrastive voice <-> voice re-ranker (port of
``tortoise_tpu/models/cvvp.py``; reference tortoise/models/cvvp.py).

Shipped config (reference api.py:254-255): 512 wide, 8 heads, depth 8 on
both sides, mel_codes=8192 (the speech side reads discrete mel codes).
``forward(..., return_loss=True)`` gives the training's symmetric
contrastive loss. ``dtype``: the compute dtype of every product (None: the
weights'); the latents and the loss are float32.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tortoise_tpu_torch.models.blocks import AttentionBlock
from tortoise_tpu_torch.models.clvp import contrastive_loss
from tortoise_tpu_torch.models.layers import Conv1d, Dense, Embed
from tortoise_tpu_torch.models.xtransformer import XTransformerEncoder


@dataclasses.dataclass(frozen=True)
class CVVPConfig:
    model_dim: int = 512
    transformer_heads: int = 8
    conditioning_enc_depth: int = 8
    speech_enc_depth: int = 8
    mel_channels: int = 80
    mel_codes: int = 8192
    latent_multiplier: int = 1


class CollapsingTransformer(nn.Module):
    """Encoder -> 1x1 convs around an AttentionBlock -> mean over time
    (reference cvvp.py:19-51)."""

    def __init__(self, model_dim: int, output_dims: int, heads: int, depth: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.transformer = XTransformerEncoder(model_dim, depth, heads, ff_mult=1.0, dtype=dtype)
        self.pre_conv = Dense(model_dim, output_dims, dtype=dtype)
        self.pre_attn = AttentionBlock(output_dims, heads, dtype=dtype)
        self.post_conv = Dense(output_dims, output_dims, dtype=dtype)

    def forward(self, x):
        h = self.pre_conv(self.transformer(x))
        return self.post_conv(self.pre_attn(h)).mean(dim=1)


def _unit(lat):
    return lat / torch.linalg.vector_norm(lat.float(), dim=-1, keepdim=True)


class CVVP(nn.Module):
    def __init__(self, config: CVVPConfig = CVVPConfig(), dtype: torch.dtype | None = None):
        super().__init__()
        cfg = self.config = config
        latent_dim = cfg.latent_multiplier * cfg.model_dim
        # no activation between the two conditioning convs, as in the reference
        self.cond_conv1 = Conv1d(cfg.mel_channels, cfg.model_dim // 2, 5, stride=2, padding=2,
                                 dtype=dtype)
        self.cond_conv2 = Conv1d(cfg.model_dim // 2, cfg.model_dim, 3, stride=2, padding=1,
                                 dtype=dtype)
        self.conditioning_transformer = CollapsingTransformer(
            cfg.model_dim, cfg.model_dim, cfg.transformer_heads, cfg.conditioning_enc_depth,
            dtype)
        self.to_conditioning_latent = Dense(cfg.model_dim, latent_dim, bias=False, dtype=dtype)
        self.speech_emb = Embed(cfg.mel_codes, cfg.model_dim)
        self.speech_transformer = CollapsingTransformer(
            cfg.model_dim, latent_dim, cfg.transformer_heads, cfg.speech_enc_depth, dtype)
        self.to_speech_latent = Dense(latent_dim, latent_dim, bias=False, dtype=dtype)
        self.temperature = nn.Parameter(torch.ones(()))

    def cond_latents(self, mel_cond):
        """mel_cond: (B, T, mel_channels) -> unit (B, latent) in float32."""
        h = self.cond_conv2(self.cond_conv1(mel_cond))
        return _unit(self.to_conditioning_latent(self.conditioning_transformer(h)))

    def speech_latents(self, mel_input):
        """mel_input: (B, Ts) codes -> unit (B, latent) in float32."""
        return _unit(self.to_speech_latent(self.speech_transformer(self.speech_emb(mel_input))))

    def forward(self, mel_cond, mel_input, return_loss: bool = False):
        """Row-wise similarity (B,) of B conditioning clips and B speech
        inputs, scaled by exp(temperature); with ``return_loss`` the
        symmetric contrastive loss over their B x B similarities."""
        cl, sl = self.cond_latents(mel_cond), self.speech_latents(mel_input)
        temp = self.temperature.float().exp()
        if return_loss:
            return contrastive_loss(cl @ sl.T * temp)
        return (cl * sl).sum(dim=-1) * temp

    def score_candidates(self, mel_cond, candidate_tokens):
        """One conditioning clip (1, T, mel) against B candidates (B, Ts) ->
        (B,) similarities: ``forward`` with the clip repeated B times, its
        latent computed once. A candidate holding a code outside the
        vocabulary scores -inf, as in ``CLVP.score_candidates``."""
        n = self.config.mel_codes
        bad = (candidate_tokens < 0) | (candidate_tokens >= n)
        sl = self.speech_latents(candidate_tokens.clamp(0, n - 1))
        scores = (sl @ self.cond_latents(mel_cond)[0]) * self.temperature.float().exp()
        return scores.masked_fill(bad.any(dim=1), -float("inf"))
