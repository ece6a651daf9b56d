"""UnifiedVoice, Tortoise's autoregressive prior, as a plain float32 model.

Reference tortoise/models/autoregressive.py:293-512: a GPT-2 (pre-LN blocks,
fused qkv, gelu_new MLP, ``ln_f``) over [conditioning latent | start, text,
stop | start_mel, mel codes] with learned position embeddings per modality;
the conditioning latent is a 1x1 conv and six attention blocks over the
clip's mel, its t=0 vector averaged over the clips
(autoregressive.py:204-228, arch_util.py AttentionBlock). ``teacher_forced``
runs the whole sequence at once with causal attention, the reference's
forward, and returns the logits of every mel position and the final-norm
latents; the served program's cache and batching are absent on purpose.

The AR reference interface of ``portbench.reference``: ``NAME``,
``PROGRAM_CONFIG``, ``SUPPRESSED``, ``build``, ``trunk_ops`` (``flops.gpt``)
and ``conditioning_ops`` (``flops.conditioning_encoder``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench import flops
from portbench.reference.layers import Dense, Embed, LayerNorm, Norm

NAME = "UnifiedVoice"
PROGRAM_CONFIG = "tortoise_tpu_torch.models.autoregressive:UnifiedVoiceConfig"
# the calm code 83 and the vocabulary's last two codes, the start and stop
# tokens
SUPPRESSED = ("mel_head.bias", (83, -2, -1), -30.0)
# keys of the configuration's ``autoregressive`` group that only the program
# reads, ignored here on purpose: the int8 denses are a serving option judged
# against this float32 model; the APIs multiply the codes' count by the
# wav-to-mel compression for the latent re-extraction and the model divides
# it out again, so it moves no served number
IGNORED = ("quant_weights", "mel_length_compression")


@dataclasses.dataclass(frozen=True)
class Config:
    layers: int = 30
    model_dim: int = 1024
    heads: int = 16
    max_text_tokens: int = 402
    max_mel_tokens: int = 604
    max_conditioning_inputs: int = 2
    number_text_tokens: int = 255
    start_text_token: int = 255
    stop_text_token: int = 0
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193


def group_count(channels: int) -> int:
    """arch_util.normalization's group count."""
    groups = 32 if channels > 64 else (16 if channels > 16 else 8)
    while channels % groups:
        groups //= 2
    return groups


class GroupNorm32(nn.Module):
    def __init__(self, channels: int, lead=()):
        super().__init__()
        self.GroupNorm_0 = Norm(channels, lead)
        self.groups = group_count(channels)

    def forward(self, x, mask=None, l=None):
        """(B, T, C); with ``mask`` (B, T) the statistics cover the valid
        frames only and padded frames come out zero."""
        w, b = self.GroupNorm_0.params(l)
        if mask is None:
            return F.group_norm(x.float().transpose(1, 2), self.groups, w, b,
                                1e-5).transpose(1, 2)
        bsz, t, c = x.shape
        g = self.groups
        m = mask.float()[:, :, None]
        xg = (x.float() * m).reshape(bsz, t, g, c // g)
        count = m.sum(dim=1) * (c // g)                               # (B, 1)
        mean = xg.sum(dim=(1, 3)) / count
        dev = xg - mean[:, None, :, None]
        var = (dev ** 2 * m[..., None]).sum(dim=(1, 3)) / count
        xn = (dev * torch.rsqrt(var[:, None, :, None] + 1e-5)).reshape(bsz, t, c)
        return (xn * w + b) * m


class AttentionBlock(nn.Module):
    """arch_util.AttentionBlock: group norm, qkv with the per-head [q|k|v]
    channel layout, q and k each scaled by ch^-1/4, an optional additive
    bias (B or 1, H, T, T), masked keys, residual."""

    def __init__(self, channels: int, heads: int, relative_pos: bool = False, lead=()):
        super().__init__()
        self.heads = heads
        self.GroupNorm32_0 = GroupNorm32(channels, lead)
        self.qkv = Dense(channels, 3 * channels, lead=lead)
        self.proj_out = Dense(channels, channels, lead=lead)
        self.rel_pos = Embed(32, heads, lead=lead) if relative_pos else None

    def forward(self, x, mask=None, bias=None, l=None):
        b, t, c = x.shape
        h = self.heads
        ch = c // h
        qkv = self.qkv(self.GroupNorm32_0(x, mask, l), l).reshape(b, t, h, 3, ch)
        scale = ch ** -0.25
        logits = torch.einsum("bthd,bshd->bhts", qkv[..., 0, :] * scale, qkv[..., 1, :] * scale)
        if bias is not None:
            logits = logits + bias
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhts,bshd->bthd", w, qkv[..., 2, :]).reshape(b, t, c)
        out = x.float() + self.proj_out(out, l)
        return out if mask is None else out * mask[:, :, None]


class ConditioningEncoder(nn.Module):
    def __init__(self, spec_dim: int, dim: int, blocks: int, heads: int):
        super().__init__()
        self.init = Dense(spec_dim, dim)
        self.n_blocks = blocks
        for i in range(blocks):
            setattr(self, f"attn_{i}", AttentionBlock(dim, heads))

    def forward(self, mel):
        h = self.init(mel)
        for i in range(self.n_blocks):
            h = getattr(self, f"attn_{i}")(h)
        return h[:, 0]


def gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))


class _Attention(nn.Module):
    def __init__(self, c, lead):
        super().__init__()
        self.c_attn = Dense(c, 3 * c, lead=lead)
        self.c_proj = Dense(c, c, lead=lead)


class _Block(nn.Module):
    def __init__(self, c, n):
        super().__init__()
        lead = (n,)
        self.ln_1 = LayerNorm(c, lead=lead)
        self.attn = _Attention(c, lead)
        self.ln_2 = LayerNorm(c, lead=lead)
        self.mlp_fc = Dense(c, 4 * c, lead=lead)
        self.mlp_proj = Dense(4 * c, c, lead=lead)


class GPT2(nn.Module):
    def __init__(self, layers: int, dim: int, heads: int):
        super().__init__()
        self.n_layer, self.heads = layers, heads
        self.h_scan = nn.Module()
        self.h_scan.block = _Block(dim, layers)
        self.ln_f = LayerNorm(dim)

    def forward(self, x):
        blk = self.h_scan.block
        b, t, c = x.shape
        h, dh = self.heads, c // self.heads
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        x = x.float()
        for l in range(self.n_layer):
            q, k, v = blk.attn.c_attn(blk.ln_1(x, l), l).split(c, dim=-1)
            q, k, v = (y.reshape(b, t, h, dh).transpose(1, 2) for y in (q, k, v))
            logits = (q @ k.transpose(-1, -2)) / np.sqrt(dh)
            w = torch.softmax(logits.masked_fill(~causal, -1e9), dim=-1)
            a = (w @ v).transpose(1, 2).reshape(b, t, c)
            x = x + blk.attn.c_proj(a, l)
            x = x + blk.mlp_proj(gelu_new(blk.mlp_fc(blk.ln_2(x, l), l)), l)
        return self.ln_f(x)


class UnifiedVoice(nn.Module):
    def __init__(self, cfg: Config = Config()):
        super().__init__()
        self.config = cfg
        d = cfg.model_dim
        self.conditioning_encoder = ConditioningEncoder(80, d, 6, cfg.heads)
        self.text_embedding = Embed(cfg.number_text_tokens + 1, d)
        self.mel_embedding = Embed(cfg.number_mel_codes, d)
        self.text_pos_embedding = Embed(cfg.max_text_tokens + 2, d)
        self.mel_pos_embedding = Embed(cfg.max_mel_tokens + 2 + cfg.max_conditioning_inputs, d)
        self.gpt = GPT2(cfg.layers, d, cfg.heads)
        self.final_norm = LayerNorm(d)
        self.text_head = Dense(d, cfg.number_text_tokens + 1)
        self.mel_head = Dense(d, cfg.number_mel_codes)

    def conditioning(self, cond_mels):
        """(1, n_clips, T, 80) -> (1, D): the clips' latents averaged."""
        b, n, t, c = cond_mels.shape
        return self.conditioning_encoder(cond_mels.reshape(b * n, t, c)).reshape(b, n, -1) \
            .mean(dim=1)

    def teacher_forced(self, cond, text, codes, served_positions: bool):
        """cond (B, D); text (B, T) the text tokens as the served API holds
        them (the BPE ids, a stop token, stop-token padding); codes (B, M)
        mel codes. Returns (logits (B, M, V), latents (B, M, D)), both from
        the final-norm state where the token before codes[:, i] is fed (the
        start token for i = 0): logits[:, i] predicts codes[:, i].

        ``served_positions``: the mel positions of the served decode, the
        start token at 0 and code i at i + 2 (the HF ``generate`` path of
        autoregressive.py:145-149); otherwise the teacher-forced forward's
        0, 1, 2, ... (the latent re-extraction, autoregressive.py:454-512)."""
        cfg = self.config
        dev = codes.device
        text = F.pad(F.pad(text, (1, 0), value=cfg.start_text_token), (0, 1),
                     value=cfg.stop_text_token)
        mel = F.pad(codes, (1, 0), value=cfg.start_mel_token)
        m = codes.shape[1]
        mel_pos = torch.arange(m + 1, device=dev)
        if served_positions:
            mel_pos = torch.where(mel_pos > 0, mel_pos + 1, mel_pos)
        emb = torch.cat([cond[:, None].float(),
                         self.text_embedding(text)
                         + self.text_pos_embedding(torch.arange(text.shape[1], device=dev)),
                         self.mel_embedding(mel) + self.mel_pos_embedding(mel_pos)], dim=1)
        latents = self.final_norm(self.gpt(emb)[:, -(m + 1):-1])
        return self.mel_head(latents), latents


def config(ar: dict) -> Config:
    """The ``autoregressive`` group as this model's ``Config``; raises on a
    key that is neither a field nor ``IGNORED``."""
    fields = Config.__dataclass_fields__
    unknown = sorted(k for k in ar if k not in fields and k not in IGNORED)
    if unknown:
        raise ValueError(f"{__name__}: unknown autoregressive key(s) {', '.join(unknown)}")
    return Config(**{k: v for k, v in ar.items() if k in fields})


def build(ar: dict) -> UnifiedVoice:
    return UnifiedVoice(config(ar))


def trunk_ops(ar: dict, batch: int, new: int, context: int) -> float:
    return flops.gpt(ar["layers"], ar["model_dim"], batch, new, context)


def conditioning_ops(ar: dict, frames: int, clips: int) -> float:
    return flops.conditioning_encoder(ar["model_dim"], frames, clips)
