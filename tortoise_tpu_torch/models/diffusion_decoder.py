"""DiffusionTts: the latent/code-conditioned mel diffusion decoder.

Port of ``tortoise_tpu/models/diffusion_decoder.py`` (reference
tortoise/models/diffusion_decoder.py:134-322): 10 DiffusionLayers
(scale-shift ResBlock + relative-position attention) and 3 timestep ResBlocks
at d=1024, fed by AR latents (the quality pipeline, bucketed) or discrete mel
codes (``code_embedding``, ``code_converter``, ``mel_head``; the training's
unbucketed ``timestep_independent``) and FiLM'd by a 2048-d voice latent.

The relative-position bias of the 13 attention blocks that run every
diffusion step is a per-layer diagonal vector (L, H, 2T-1) built once per
sampling call (``rel_bias_vectors``), in place of the JAX package's
``compute_rel_bias_blocks`` tile stacks.

``dtype`` is the compute dtype of every product but ``out_conv``, which is
float32, as in the JAX model (None: each weight's, the serving models').
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.blocks import AttentionBlock, GroupNorm32
from tortoise_tpu_torch.models.layers import Conv1d, Dense, Embed, silu
from tortoise_tpu_torch.ops.attn import rel_bias_vector
from tortoise_tpu_torch.ops.interpolate import nearest_interpolate


@dataclasses.dataclass(frozen=True)
class DiffusionTtsConfig:
    model_channels: int = 1024
    num_layers: int = 10
    in_channels: int = 100
    in_latent_channels: int = 1024
    in_tokens: int = 8193
    out_channels: int = 200
    num_heads: int = 16


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """Sinusoidal embeddings, cos first (frequency table in float64)."""
    half = dim // 2
    freqs = torch.as_tensor(
        np.exp(-np.log(max_period) * np.arange(half, dtype=np.float64) / half)
        .astype(np.float32), device=timesteps.device)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([args.cos(), args.sin()], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _masked(x, mask):
    return x if mask is None else x * mask[:, :, None].to(x.dtype)


class TimestepResBlock(nn.Module):
    """Scale-shift-norm ResBlock: 1x1 in/skip convs, k3 out conv."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int | None = None,
                 kernel_size: int = 3, lead: tuple = (), dtype: torch.dtype | None = None):
        super().__init__()
        out_ch = out_channels or channels
        pad = {1: 0, 3: 1, 5: 2}[kernel_size]
        self.dtype = dtype
        self.GroupNorm32_0 = GroupNorm32(channels, lead=lead)
        self.in_conv = Dense(channels, out_ch, lead=lead, dtype=dtype)
        self.emb_proj = Dense(emb_channels, 2 * out_ch, lead=lead, dtype=dtype)
        self.GroupNorm32_1 = GroupNorm32(out_ch, lead=lead)
        self.out_conv = Conv1d(out_ch, out_ch, kernel_size, padding=pad, lead=lead, dtype=dtype)
        self.skip_conv = Dense(channels, out_ch, lead=lead, dtype=dtype) \
            if out_ch != channels else None

    def forward(self, x, emb, valid_mask=None, l: int | None = None):
        h = silu(self.GroupNorm32_0(x, mask=valid_mask, l=l), self.dtype)
        h = self.in_conv(h, l)
        scale, shift = self.emb_proj(silu(emb, self.dtype), l)[:, None, :].chunk(2, dim=-1)
        h = self.GroupNorm32_1(h, mask=valid_mask, l=l) * (1 + scale) + shift
        h = _masked(silu(h, self.dtype), valid_mask)
        h = self.out_conv(h, l)
        skip = x if self.skip_conv is None else self.skip_conv(x, l)
        return _masked(skip + h, valid_mask)


class DiffusionLayer(nn.Module):
    def __init__(self, channels: int, num_heads: int, lead: tuple = (),
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.resblk = TimestepResBlock(channels, channels, lead=lead, dtype=dtype)
        self.attn = AttentionBlock(channels, num_heads, relative_pos_embeddings=True, lead=lead,
                                   dtype=dtype)

    def forward(self, x, emb, valid_mask, rel_bias, flash: bool, l: int | None = None):
        h = self.resblk(x, emb, valid_mask=valid_mask, l=l)
        return self.attn(h, valid_mask=valid_mask, rel_bias=rel_bias, flash=flash, l=l)


class _Stacked(nn.Module):
    """``<name>.layer``: the JAX package's nn.scan path for stacked layers."""

    def __init__(self, layer: nn.Module, n: int):
        super().__init__()
        self.layer = layer
        self.n = n


class DiffusionTts(nn.Module):
    def __init__(self, config: DiffusionTtsConfig = DiffusionTtsConfig(),
                 dtype: torch.dtype | None = None):
        super().__init__()
        cfg = self.config = config
        ch = cfg.model_channels
        self.compute_dtype = dtype
        attn = lambda c: AttentionBlock(c, cfg.num_heads, relative_pos_embeddings=True,
                                        dtype=dtype)
        self.inp_block = Conv1d(cfg.in_channels, ch, 3, padding=1, dtype=dtype)
        self.time_embed_1 = Dense(ch, ch, dtype=dtype)
        self.time_embed_2 = Dense(ch, ch, dtype=dtype)
        self.code_norm = GroupNorm32(ch)
        self.latent_conv = Conv1d(cfg.in_latent_channels, ch, 3, padding=1, dtype=dtype)
        for i in range(4):
            setattr(self, f"latent_attn_{i}", attn(ch))
        self.ctx_conv1 = Conv1d(cfg.in_channels, ch, 3, stride=2, padding=1, dtype=dtype)
        self.ctx_conv2 = Conv1d(ch, 2 * ch, 3, stride=2, padding=1, dtype=dtype)
        for i in range(5):
            setattr(self, f"ctx_attn_{i}", attn(2 * ch))
        self.unconditioned_embedding = nn.Parameter(torch.empty(1, 1, ch))
        self.cond_scan = _Stacked(DiffusionLayer(ch, cfg.num_heads, lead=(3,), dtype=dtype), 3)
        self.integrating_conv = Dense(2 * ch, ch, dtype=dtype)
        self.layers_scan = _Stacked(
            DiffusionLayer(ch, cfg.num_heads, lead=(cfg.num_layers,), dtype=dtype),
            cfg.num_layers)
        for i in range(3):
            setattr(self, f"tail_{i}", TimestepResBlock(ch, ch, dtype=dtype))
        self.out_norm = GroupNorm32(ch)
        self.out_conv = Conv1d(ch, cfg.out_channels, 3, padding=1)
        # the code path, registered last so that weights.init_random draws
        # every other parameter as it did before the path existed
        self.code_embedding = Embed(cfg.in_tokens, ch)
        for i in range(3):
            setattr(self, f"code_converter_{i}", attn(ch))
        self.mel_head = Conv1d(ch, cfg.in_channels, 3, padding=1, dtype=dtype)

    @property
    def dtype(self):
        """The compute dtype: ``dtype``, else the stored weights'."""
        return self.time_embed_1.weight.dtype if self.compute_dtype is None \
            else self.compute_dtype

    def get_conditioning(self, cond_mels):
        """(B, n_clips, T, 100) univnet mels -> (B, 2048) voice latent."""
        b, n, t, c = cond_mels.shape
        h = self.ctx_conv2(self.ctx_conv1(cond_mels.reshape(b * n, t, c)))
        for i in range(5):
            h = getattr(self, f"ctx_attn_{i}")(h)
        return h.reshape(b, n * h.shape[1], -1).mean(dim=1)

    def timestep_independent(self, aligned_conditioning, conditioning_latent,
                             expected_seq_len: int, return_code_pred: bool = False):
        """The conditioning path at exact lengths (reference
        diffusion_decoder.py:232-260): float latents (B, S, 1024) through
        ``latent_conv`` and ``latent_attn``, or integer codes (B, S) through
        ``code_embedding`` and ``code_converter``; then FiLM by the voice
        latent (B, 2048) and a nearest resize to ``expected_seq_len``.
        ``return_code_pred`` adds ``mel_head``'s (B, T, 100) prediction."""
        if aligned_conditioning.is_floating_point():
            code_emb = self.latent_conv(aligned_conditioning)
            blocks = [f"latent_attn_{i}" for i in range(4)]
        else:
            code_emb = self.code_embedding(aligned_conditioning)
            blocks = [f"code_converter_{i}" for i in range(3)]
        for name in blocks:
            code_emb = getattr(self, name)(code_emb, flash=False)
        cond_scale, cond_shift = conditioning_latent.chunk(2, dim=-1)
        code_emb = self.code_norm(code_emb) * (1 + cond_scale[:, None]) + cond_shift[:, None]
        expanded = nearest_interpolate(code_emb, expected_seq_len)
        if not return_code_pred:
            return expanded
        return expanded, self.mel_head(expanded)

    def timestep_independent_bucketed(self, latents, n_latents, conditioning_latent,
                                      out_len, out_bucket: int):
        """latents (B, S_bucket, D) zero-padded; n_latents, out_len: (B,)
        true lengths. Returns (B, out_bucket, C): the first out_len[b] frames
        of row b equal an exact-length run, the rest are zero."""
        b, s_bucket, _ = latents.shape
        dev = latents.device
        n_latents = n_latents.reshape(-1).expand(b)
        out_len = out_len.reshape(-1).expand(b)
        lat_mask = torch.arange(s_bucket, device=dev)[None, :] < n_latents[:, None]
        code_emb = self.latent_conv(_masked(latents, lat_mask))
        for i in range(4):
            code_emb = getattr(self, f"latent_attn_{i}")(code_emb, valid_mask=lat_mask)
        cond_scale, cond_shift = conditioning_latent.chunk(2, dim=-1)
        code_emb = self.code_norm(code_emb, mask=lat_mask) * (1 + cond_scale[:, None]) \
            + cond_shift[:, None]
        code_emb = _masked(code_emb, lat_mask)
        # frame i < out_len[b] reads latent floor(i * n[b] / out_len[b]), the
        # exact-length F.interpolate(mode="nearest")
        i = torch.arange(out_bucket, device=dev)
        idx = ((i[None, :] * n_latents[:, None]) // out_len[:, None].clamp(min=1)) \
            .clamp(0, s_bucket - 1)
        expanded = code_emb.gather(1, idx[:, :, None].expand(-1, -1, code_emb.shape[-1]))
        return _masked(expanded, i[None, :] < out_len[:, None])

    def rel_bias_vectors(self, t: int):
        """Per-layer diagonal bias vectors for a T-frame run, float32 holding
        values rounded to the model dtype: ((L, H, 2T-1), (3, H, 2T-1))."""
        scale = (self.config.model_channels // self.config.num_heads) ** 0.5
        vec = lambda stack: rel_bias_vector(stack.layer.attn.rel_pos.weight, t, scale) \
            .to(self.dtype).float()
        return vec(self.layers_scan), vec(self.cond_scan)

    def forward(self, x, timesteps, precomputed_aligned_embeddings=None,
                aligned_conditioning=None, conditioning_latent=None,
                conditioning_free: bool = False, valid_len=None, rel_biases=None,
                flash: bool = False):
        """x (B, T, 100) noisy mel; timesteps (B,) original-scale steps. The
        conditioning (B, T, C) is the learned unconditioned embedding with
        ``conditioning_free``, else precomputed_aligned_embeddings, else
        ``timestep_independent(aligned_conditioning, conditioning_latent,
        T)``. valid_len (B,) or None; rel_biases from
        ``rel_bias_vectors(T)`` (or None: each block builds its own); flash
        routes the 13 per-step attention blocks through K3. Returns
        (B, T, 200): eps and variance channels."""
        valid_mask = None
        if valid_len is not None:
            pos = torch.arange(x.shape[1], device=x.device)[None, :]
            valid_mask = pos < valid_len.reshape(-1, 1)
            x = _masked(x, valid_mask)
        if conditioning_free:
            code_emb = _masked(self.unconditioned_embedding.to(self.dtype).expand(
                x.shape[0], x.shape[1], -1), valid_mask)
        elif precomputed_aligned_embeddings is not None:
            code_emb = precomputed_aligned_embeddings
        else:
            code_emb = self.timestep_independent(aligned_conditioning, conditioning_latent,
                                                 x.shape[1])
        time_emb = self.time_embed_2(silu(self.time_embed_1(
            timestep_embedding(timesteps, self.config.model_channels)), self.compute_dtype))
        b_layers, b_cond = rel_biases if rel_biases is not None else (None, None)
        for l in range(self.cond_scan.n):
            code_emb = self.cond_scan.layer(code_emb, time_emb, valid_mask,
                                            None if b_cond is None else b_cond[l], flash, l)
        h = self.integrating_conv(torch.cat([self.inp_block(x), code_emb.to(self.dtype)], -1))
        for l in range(self.layers_scan.n):
            h = self.layers_scan.layer(h, time_emb, valid_mask,
                                       None if b_layers is None else b_layers[l], flash, l)
        for i in range(3):
            h = getattr(self, f"tail_{i}")(h, time_emb, valid_mask=valid_mask)
        h = _masked(silu(self.out_norm(h.float(), mask=valid_mask), self.compute_dtype),
                    valid_mask)
        w = self.out_conv
        # float32 like the JAX out_conv (dtype=float32 over the stored weights)
        return F.conv1d(h.transpose(1, 2), w.weight.float(), w.bias.float(),
                        padding=w.padding).transpose(1, 2)
