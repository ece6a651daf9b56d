"""CLVP: contrastive text <-> speech re-ranker, the default x-transformers
variant (port of ``tortoise_tpu/models/clvp.py``; reference
tortoise/models/clvp.py). Shipped config: 768-d, 20 + 20 layers, 12 heads.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tortoise_tpu_torch.models.layers import Dense, Embed
from tortoise_tpu_torch.models.xtransformer import XTransformerEncoder


@dataclasses.dataclass(frozen=True)
class CLVPConfig:
    dim_text: int = 768
    dim_speech: int = 768
    dim_latent: int = 768
    num_text_tokens: int = 256
    text_enc_depth: int = 20
    text_heads: int = 12
    num_speech_tokens: int = 8192
    speech_enc_depth: int = 20
    speech_heads: int = 12


class CLVP(nn.Module):
    def __init__(self, config: CLVPConfig = CLVPConfig()):
        super().__init__()
        cfg = self.config = config
        self.text_emb = Embed(cfg.num_text_tokens, cfg.dim_text)
        self.speech_emb = Embed(cfg.num_speech_tokens, cfg.dim_speech)
        self.text_transformer = XTransformerEncoder(cfg.dim_text, cfg.text_enc_depth,
                                                    cfg.text_heads)
        self.speech_transformer = XTransformerEncoder(cfg.dim_speech, cfg.speech_enc_depth,
                                                      cfg.speech_heads)
        self.to_text_latent = Dense(cfg.dim_text, cfg.dim_latent, bias=False)
        self.to_speech_latent = Dense(cfg.dim_speech, cfg.dim_latent, bias=False)
        self.temperature = nn.Parameter(torch.ones(()))

    @staticmethod
    def _latent(emb, transformer, proj):
        lat = proj(transformer(emb).mean(dim=1))
        return lat / torch.linalg.vector_norm(lat.float(), dim=-1, keepdim=True)

    def text_latents(self, text):
        return self._latent(self.text_emb(text), self.text_transformer, self.to_text_latent)

    def speech_latents(self, speech_tokens):
        return self._latent(self.speech_emb(speech_tokens), self.speech_transformer,
                            self.to_speech_latent)

    def score_candidates(self, text, candidate_tokens):
        """One text (1, Tt) against B candidates (B, Ts) -> (B,) similarities.

        A candidate holding a code outside the speech vocabulary (the AR
        model's start token 8192 can be sampled from untrained weights) scores
        -inf: its embedding lookup would be out of range."""
        tl = self.text_latents(text)
        bad = (candidate_tokens < 0) | (candidate_tokens >= self.config.num_speech_tokens)
        sl = self.speech_latents(candidate_tokens.clamp(0, self.config.num_speech_tokens - 1))
        scores = (sl @ tl[0]) * self.temperature.float().exp()
        return scores.masked_fill(bad.any(dim=1), -float("inf"))
