"""UnifiedVoice: the GPT-2 autoregressive mel-token prior.

Port of ``tortoise_tpu/models/autoregressive.py`` (reference
tortoise/models/autoregressive.py:293-574): a GPT-2 over
[cond_latent | text tokens | mel tokens] with learned per-modality position
embeddings. Shipped config: 30 layers, d=1024, 16 heads, 402 text / 604 mel
positions, 255 text tokens (start 255, stop 0), 8194 mel codes (start 8192,
stop 8193).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.blocks import ConditioningEncoder
from tortoise_tpu_torch.models.gpt2 import GPT2Config, GPT2Stack
from tortoise_tpu_torch.models.layers import Dense, Embed, LayerNorm


@dataclasses.dataclass(frozen=True)
class UnifiedVoiceConfig:
    layers: int = 30
    model_dim: int = 1024
    heads: int = 16
    max_text_tokens: int = 402
    max_mel_tokens: int = 604
    max_conditioning_inputs: int = 2
    mel_length_compression: int = 1024
    number_text_tokens: int = 255
    start_text_token: int = 255
    stop_text_token: int = 0
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    types: int = 1
    quant_weights: bool = False  # int8 GPT block denses (gpt2.QuantDense)

    @property
    def gpt_config(self) -> GPT2Config:
        return GPT2Config(n_layer=self.layers, n_embd=self.model_dim, n_head=self.heads,
                          quant_weights=self.quant_weights)

    @property
    def text_vocab(self) -> int:
        return self.number_text_tokens * self.types + 1

    @property
    def mel_pos_len(self) -> int:
        return self.max_mel_tokens + 2 + self.max_conditioning_inputs

    @property
    def text_pos_len(self) -> int:
        return self.max_text_tokens + 2


class UnifiedVoice(nn.Module):
    def __init__(self, config: UnifiedVoiceConfig = UnifiedVoiceConfig()):
        super().__init__()
        cfg = self.config = config
        self.conditioning_encoder = ConditioningEncoder(80, cfg.model_dim, attn_blocks=6,
                                                        num_attn_heads=cfg.heads)
        self.text_embedding = Embed(cfg.text_vocab, cfg.model_dim)
        self.mel_embedding = Embed(cfg.number_mel_codes, cfg.model_dim)
        self.text_pos_embedding = Embed(cfg.text_pos_len, cfg.model_dim)
        self.mel_pos_embedding = Embed(cfg.mel_pos_len, cfg.model_dim)
        self.gpt = GPT2Stack(cfg.gpt_config)
        self.final_norm = LayerNorm(cfg.model_dim)
        self.text_head = Dense(cfg.model_dim, cfg.text_vocab)
        self.mel_head = Dense(cfg.model_dim, cfg.number_mel_codes)

    def _positions(self, n: int):
        return torch.arange(n, device=self.text_embedding.weight.device)

    def get_conditioning(self, cond_mels):
        """(B, n_clips, T, 80) -> (B, model_dim): the encoder's t=0 vector,
        averaged over clips."""
        b, n, t, c = cond_mels.shape
        enc = self.conditioning_encoder(cond_mels.reshape(b * n, t, c))
        return enc.reshape(b, n, -1).mean(dim=1)

    def forward(self, cond_latent, text_inputs, mel_codes, wav_lengths=None,
                return_latent: bool = False, return_logits: bool = False):
        """Teacher-forced forward (reference autoregressive.py:454-512).
        Returns (loss_text, loss_mel, mel_logits) by default, the mel latents
        (B, Tm, D) with ``return_latent``, (text_logits, mel_logits) with
        ``return_logits``. Mel positions past wav_length // 1024 + 1 become
        the stop token."""
        cfg = self.config
        if wav_lengths is not None:
            mel_lengths = wav_lengths // cfg.mel_length_compression
            pos = self._positions(mel_codes.shape[1])[None, :]
            mel_codes = torch.where(pos >= mel_lengths[:, None] + 1,
                                    torch.full_like(mel_codes, cfg.stop_mel_token), mel_codes)
        text_inputs = F.pad(text_inputs, (0, 1), value=cfg.stop_text_token)
        mel_codes = F.pad(mel_codes, (0, 1), value=cfg.stop_mel_token)
        text_inp = F.pad(text_inputs, (1, 0), value=cfg.start_text_token)
        mel_inp = F.pad(mel_codes, (1, 0), value=cfg.start_mel_token)
        text_tar = F.pad(text_inputs, (0, 1), value=cfg.stop_text_token)
        mel_tar = F.pad(mel_codes, (0, 1), value=cfg.stop_mel_token)
        text_emb = self.text_embedding(text_inp) + self.text_pos_embedding(
            self._positions(text_inp.shape[1]))
        mel_emb = self.mel_embedding(mel_inp) + self.mel_pos_embedding(
            self._positions(mel_inp.shape[1]))
        emb = torch.cat([cond_latent[:, None, :].to(text_emb.dtype), text_emb, mel_emb], dim=1)
        hidden, _ = self.gpt(emb)
        enc = self.final_norm(hidden[:, 1:]).to(hidden.dtype)
        t_text, t_mel = text_inp.shape[1], mel_inp.shape[1]
        if return_latent:
            return enc[:, t_text:t_text + t_mel][:, :-2]
        text_logits = self.text_head(enc[:, :t_text])
        mel_logits = self.mel_head(enc[:, -t_mel:])
        if return_logits:
            return text_logits, mel_logits
        return _xent(text_logits, text_tar), _xent(mel_logits, mel_tar), mel_logits

    def compute_prompt(self, cond_latent, text_tokens):
        """Decode prompt [cond | start, text..., stop, stop | start_mel] (B, P, D);
        ``text_tokens`` already carries the api-level stop pad."""
        cfg = self.config
        text_tokens = F.pad(text_tokens, (0, 1), value=cfg.stop_text_token)
        text_tokens = F.pad(text_tokens, (1, 0), value=cfg.start_text_token)
        text_emb = self.text_embedding(text_tokens) + self.text_pos_embedding(
            self._positions(text_tokens.shape[1]))
        conds = cond_latent[:, None, :].to(text_emb.dtype)
        start = torch.full((text_tokens.shape[0], 1), cfg.start_mel_token,
                           dtype=torch.long, device=text_tokens.device)
        start_emb = self.mel_embedding(start) + self.mel_pos_embedding(self._positions(1))
        return torch.cat([conds, text_emb, start_emb], dim=1)

    def decode_embed(self, tokens, step: int):
        """Embedding of generated mel tokens at decode step ``step``: the s-th
        sampled token enters with mel position s+2 (reference :145-149)."""
        pos = torch.full((1,), step + 2, dtype=torch.long, device=tokens.device)
        return self.mel_embedding(tokens) + self.mel_pos_embedding(pos)

    def hidden_to_mel_logits(self, hidden):
        return self.mel_head(self.final_norm(hidden).to(hidden.dtype))

    def hidden_to_latent(self, hidden):
        """final_norm'd hidden state (float32)."""
        return self.final_norm(hidden)


def _xent(logits, targets):
    """Mean float32 cross-entropy over every position, start and stop
    padding included."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()
