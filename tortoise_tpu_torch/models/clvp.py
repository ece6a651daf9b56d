"""CLVP: contrastive text <-> speech re-ranker (port of
``tortoise_tpu/models/clvp.py``; reference tortoise/models/clvp.py).
Shipped config: 768-d, 20 + 20 layers, 12 heads, the x-transformers
encoders. ``use_xformers=False`` builds the reference's plain-Transformer
variant (``models/simple_transformer.py``) with learned absolute position
tables (reference clvp.py:84-97). ``dtype``: the encoders' and the latent
projections' compute dtype (None: the weights'); the embeddings give their
table's dtype, the latents and the loss are float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from tortoise_tpu_torch.models.layers import Dense, Embed
from tortoise_tpu_torch.models.simple_transformer import SimpleTransformer
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
    # the plain-Transformer variant; text_seq_len sizes its text position
    # table only (reference api.py:230 passes 350)
    use_xformers: bool = True
    text_seq_len: int = 350


def masked_mean(t, mask):
    """(B, T, D) -> (B, D): the mean over the kept positions (reference
    clvp.py:15-17)."""
    if mask is None:
        return t.mean(dim=1)
    return (t * mask[..., None].to(t.dtype)).sum(dim=1) / mask.sum(dim=1)[..., None]


class CLVP(nn.Module):
    def __init__(self, config: CLVPConfig = CLVPConfig(), dtype: torch.dtype | None = None):
        super().__init__()
        cfg = self.config = config
        self.text_emb = Embed(cfg.num_text_tokens, cfg.dim_text)
        self.speech_emb = Embed(cfg.num_speech_tokens, cfg.dim_speech)
        encoder = XTransformerEncoder if cfg.use_xformers else SimpleTransformer
        self.text_transformer = encoder(cfg.dim_text, cfg.text_enc_depth, cfg.text_heads,
                                        dtype=dtype)
        self.speech_transformer = encoder(cfg.dim_speech, cfg.speech_enc_depth,
                                          cfg.speech_heads, dtype=dtype)
        if not cfg.use_xformers:
            # the speech table is sized by the token vocabulary: a reference
            # quirk kept for its checkpoints (reference clvp.py:96-97)
            self.text_pos_emb = Embed(cfg.text_seq_len, cfg.dim_text)
            self.speech_pos_emb = Embed(cfg.num_speech_tokens, cfg.dim_speech)
        self.to_text_latent = Dense(cfg.dim_text, cfg.dim_latent, bias=False, dtype=dtype)
        self.to_speech_latent = Dense(cfg.dim_speech, cfg.dim_latent, bias=False, dtype=dtype)
        self.temperature = nn.Parameter(torch.ones(()))

    @staticmethod
    def _latent(emb, transformer, proj, mask):
        lat = proj(masked_mean(transformer(emb, mask=mask), mask))
        return lat / torch.linalg.vector_norm(lat.float(), dim=-1, keepdim=True)

    def _embed(self, tokens, side: str):
        """``{side}_emb`` of the tokens; in the plain variant plus
        ``{side}_pos_emb`` of their positions (reference clvp.py:116-118)."""
        x = getattr(self, f"{side}_emb")(tokens)
        if not self.config.use_xformers:
            pos = torch.arange(tokens.shape[1], device=tokens.device)
            x = x + getattr(self, f"{side}_pos_emb")(pos)
        return x

    def text_latents(self, text, mask=None):
        return self._latent(self._embed(text, "text"), self.text_transformer,
                            self.to_text_latent, mask)

    def speech_latents(self, speech_tokens, mask=None):
        return self._latent(self._embed(speech_tokens, "speech"), self.speech_transformer,
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


def config_for_tree(config: CLVPConfig, tree) -> CLVPConfig:
    """``config`` with the encoder variant, its depths and the text
    position table's length that a JAX-layout param tree holds: the plain
    variant's tree has position tables and ``block_{i}`` layers."""
    if "text_pos_emb" not in tree:
        return dataclasses.replace(config, use_xformers=True)
    depth = lambda enc: sum(k.startswith("block_") for k in tree[enc])
    return dataclasses.replace(
        config, use_xformers=False, text_enc_depth=depth("text_transformer"),
        speech_enc_depth=depth("speech_transformer"),
        text_seq_len=int(np.shape(tree["text_pos_emb"]["embedding"])[0]))


def _xent_rows(sim, labels):
    logp = torch.log_softmax(sim.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def contrastive_loss(sim):
    """The symmetric contrastive loss of a (B, B) similarity matrix whose
    diagonal holds the matching pairs: the mean float32 cross-entropy of its
    rows and of its columns, averaged (CLVP's and CVVP's training loss)."""
    labels = torch.arange(sim.shape[0], device=sim.device)
    return (_xent_rows(sim, labels) + _xent_rows(sim.T, labels)) / 2
