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


def masked_mean(t, mask):
    """(B, T, D) -> (B, D): the mean over the kept positions (reference
    clvp.py:15-17)."""
    if mask is None:
        return t.mean(dim=1)
    return (t * mask[..., None].to(t.dtype)).sum(dim=1) / mask.sum(dim=1)[..., None]


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
    def _latent(emb, transformer, proj, mask):
        lat = proj(masked_mean(transformer(emb, mask=mask), mask))
        return lat / torch.linalg.vector_norm(lat.float(), dim=-1, keepdim=True)

    def text_latents(self, text, mask=None):
        return self._latent(self.text_emb(text), self.text_transformer, self.to_text_latent,
                            mask)

    def speech_latents(self, speech_tokens, mask=None):
        return self._latent(self.speech_emb(speech_tokens), self.speech_transformer,
                            self.to_speech_latent, mask)

    def forward(self, text, speech_tokens, return_loss: bool = False, text_mask=None,
                voice_mask=None):
        """text (B, Tt), speech_tokens (B, Ts) codes; the masks (B, T) bool
        keep positions (training's token dropout). Returns each pair's
        cosine similarity x exp(temperature) (B,), or with ``return_loss``
        the symmetric contrastive loss over the batch's B x B similarities
        (reference clvp.py:99-140)."""
        tl = self.text_latents(text, mask=text_mask)
        sl = self.speech_latents(speech_tokens, mask=voice_mask)
        temp = self.temperature.float().exp()
        if not return_loss:
            return (tl * sl).sum(dim=-1) * temp
        return contrastive_loss(tl @ sl.T * temp)

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


def _xent_rows(sim, labels):
    logp = torch.log_softmax(sim.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def contrastive_loss(sim):
    """The symmetric contrastive loss of a (B, B) similarity matrix whose
    diagonal holds the matching pairs: the mean float32 cross-entropy of its
    rows and of its columns, averaged (CLVP's and CVVP's training loss)."""
    labels = torch.arange(sim.shape[0], device=sim.device)
    return (_xent_rows(sim, labels) + _xent_rows(sim.T, labels)) / 2
