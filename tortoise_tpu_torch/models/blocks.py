"""Shared building blocks: GroupNorm32, AttentionBlock, ConditioningEncoder,
and the classifier's ResBlock, Downsample, Upsample and AudioMiniEncoder.

Port of ``tortoise_tpu/models/blocks.py`` (itself the reference's
arch_util.py). Activations are (batch, time, channels); normalizations run
in float32 and return the input dtype. ``dtype`` is a block's compute dtype
(``models/layers.py``); with None the attention weights and values take
the input's dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.layers import Conv1d, Dense, Embed, Norm
from tortoise_tpu_torch.ops import attn as attn_ops


def norm_num_groups(channels: int) -> int:
    """Group count heuristic (reference arch_util.py:26-41)."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups = int(groups / 2)
    assert groups > 2
    return groups


class GroupNorm32(nn.Module):
    """GroupNorm in float32. With ``mask`` ((B, T) bool) the statistics cover
    valid positions only and padded positions come out zero, so a
    right-padded run equals an unpadded one."""

    def __init__(self, channels: int, eps: float = 1e-5, lead: tuple = ()):
        super().__init__()
        self.GroupNorm_0 = Norm(channels, lead)
        self.groups = norm_num_groups(channels)
        self.eps = eps

    def forward(self, x, mask=None, l: int | None = None):
        scale, bias = self.GroupNorm_0.params(l)
        b, t, c = x.shape
        if mask is None:
            y = F.group_norm(x.float().transpose(1, 2), self.groups, scale, bias, self.eps)
            return y.transpose(1, 2).to(x.dtype)
        g = self.groups
        m = mask.float()[:, :, None]                              # (B, T, 1)
        xg = (x.float() * m).reshape(b, t, g, c // g)
        count = m.sum(dim=1, keepdim=True) * (c // g)             # (B, 1, 1)
        mean = xg.sum(dim=(1, 3)) / count[:, 0]                   # (B, G)
        dev = xg - mean[:, None, :, None]
        var = (dev ** 2 * m[..., None]).sum(dim=(1, 3)) / count[:, 0]
        xn = (dev * torch.rsqrt(var[:, None, :, None] + self.eps)).reshape(b, t, c)
        return ((xn * scale + bias) * m).to(x.dtype)


class AttentionBlock(nn.Module):
    """Self-attention over time with the diffusion-codebase head layout
    (per-head [q|k|v] channel interleave), 1/sqrt(sqrt(d)) applied to q and k,
    float32 softmax, residual output.

    ``valid_mask`` ((B, T) bool) excludes padded keys and zeroes padded
    outputs. ``rel_bias`` is the layer's pre-scaled diagonal relative-position
    vector (H, 2T-1); a block with ``relative_pos_embeddings`` and no
    ``rel_bias`` builds it from its own bucket table. ``flash`` routes the
    attention through kernel K3 (``ops/attn.py``), the other path is the
    plain einsum (``tortoise_tpu/models/blocks.py:253-281``).
    """

    def __init__(self, channels: int, num_heads: int = 1,
                 relative_pos_embeddings: bool = False, lead: tuple = (),
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.GroupNorm32_0 = GroupNorm32(channels, lead=lead)
        self.qkv = Dense(channels, 3 * channels, lead=lead, dtype=dtype)
        self.proj_out = Dense(channels, channels, lead=lead, dtype=dtype)
        self.rel_pos = Embed(32, num_heads, lead=lead) if relative_pos_embeddings else None

    def forward(self, x, valid_mask=None, rel_bias=None, flash: bool = False,
                l: int | None = None):
        b, t, c = x.shape
        h = self.num_heads
        ch = c // h
        y = self.GroupNorm32_0(x, mask=valid_mask, l=l)
        qkv = self.qkv(y, l=l).reshape(b, t, h, 3, ch)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        if rel_bias is None and self.rel_pos is not None:
            table = self.rel_pos.weight if l is None else self.rel_pos.weight[l]
            rel_bias = attn_ops.rel_bias_vector(table, t, ch ** 0.5)
        if flash:
            if rel_bias is None:
                raise ValueError("the flash path needs a relative-position bias")
            lens = (torch.full((b,), t, dtype=torch.int32, device=x.device)
                    if valid_mask is None else valid_mask.sum(-1).to(torch.int32))
            o = attn_ops.flash_rel_attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), rel_bias.float().contiguous(), lens)
            out = o.transpose(1, 2).reshape(b, t, c)
        else:
            scale = 1.0 / np.sqrt(np.sqrt(ch))
            if self.dtype is None:      # the serving models: q and k scaled in their dtype
                q, k = (q * scale).float(), (k * scale).float()
            else:                       # the JAX block's numpy scale promotes them to float32
                q, k = q.float() * scale, k.float() * scale
            logits = torch.einsum("bthd,bshd->bhts", q, k)
            if rel_bias is not None:
                logits = logits + attn_ops.expand_rel_bias(rel_bias.float(), t)[None]
            if valid_mask is not None:
                logits = logits.masked_fill(~valid_mask[:, None, None, :],
                                            torch.finfo(torch.float32).min)
            dt = x.dtype if self.dtype is None else self.dtype
            w = torch.softmax(logits, dim=-1).to(dt)
            out = torch.einsum("bhts,bshd->bthd", w, v.to(dt)).reshape(b, t, c)
        out = x + self.proj_out(out, l=l)
        if valid_mask is not None:
            out = out * valid_mask[:, :, None].to(out.dtype)
        return out


class ConditioningEncoder(nn.Module):
    """Mel clip -> one conditioning vector: 1x1 conv then an attention stack,
    taking the t=0 vector (reference autoregressive.py:204-228)."""

    def __init__(self, spec_dim: int, embedding_dim: int, attn_blocks: int = 6,
                 num_attn_heads: int = 4, dtype: torch.dtype | None = None):
        super().__init__()
        self.init = Dense(spec_dim, embedding_dim, dtype=dtype)
        self.n_blocks = attn_blocks
        for i in range(attn_blocks):
            setattr(self, f"attn_{i}", AttentionBlock(embedding_dim, num_attn_heads,
                                                      dtype=dtype))

    def forward(self, mel_btc):
        h = self.init(mel_btc)
        for i in range(self.n_blocks):
            h = getattr(self, f"attn_{i}")(h)
        return h[:, 0]


class ResBlock(nn.Module):
    """1-D residual block: GroupNorm32, SiLU and a conv, twice (reference
    arch_util.py:181-246; its up/down options are unused by the shipped
    models). The skip is the identity, a k-conv (``use_conv_skip``) or a
    1x1 conv."""

    def __init__(self, channels: int, out_channels: int | None = None, kernel_size: int = 3,
                 use_conv_skip: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        pad = 1 if kernel_size == 3 else 2
        self.GroupNorm32_0 = GroupNorm32(channels)
        self.in_conv = Conv1d(channels, out_ch, kernel_size, padding=pad)
        self.GroupNorm32_1 = GroupNorm32(out_ch)
        self.out_conv = Conv1d(out_ch, out_ch, kernel_size, padding=pad)
        if out_ch == channels:
            self.skip_conv = None
        elif use_conv_skip:
            self.skip_conv = Conv1d(channels, out_ch, kernel_size, padding=pad)
        else:
            self.skip_conv = Conv1d(channels, out_ch, 1)

    def forward(self, x):
        h = self.in_conv(F.silu(self.GroupNorm32_0(x)))
        h = self.out_conv(F.silu(self.GroupNorm32_1(h)))
        return (x if self.skip_conv is None else self.skip_conv(x)) + h


class Downsample(nn.Module):
    """Strided-conv downsampling (reference arch_util.py:153-178)."""

    def __init__(self, channels: int, out_channels: int | None = None, factor: int = 4,
                 ksize: int = 5, pad: int = 2):
        super().__init__()
        self.conv = Conv1d(channels, out_channels or channels, ksize, stride=factor,
                           padding=pad)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest-neighbour upsampling, then a k=5 conv (reference
    arch_util.py:126-150)."""

    def __init__(self, channels: int, out_channels: int | None = None, factor: int = 4):
        super().__init__()
        self.factor = factor
        self.conv = Conv1d(channels, out_channels or channels, 5, padding=2)

    def forward(self, x):
        return self.conv(x.repeat_interleave(self.factor, dim=1))


class AudioMiniEncoder(nn.Module):
    """Waveform/spectrogram pyramid encoder of the Tortoise-detect classifier
    (reference tortoise/models/classifier.py:78-120): ResBlocks and a
    downsampling per level, then attention blocks; returns the t=0 vector."""

    def __init__(self, spec_dim: int, embedding_dim: int, base_channels: int = 128,
                 depth: int = 2, resnet_blocks: int = 2, attn_blocks: int = 4,
                 num_attn_heads: int = 4, downsample_factor: int = 2, kernel_size: int = 3):
        super().__init__()
        self.init = Conv1d(spec_dim, base_channels, 3, padding=1)
        self.pyramid = []
        ch, idx = base_channels, 0
        for _ in range(depth):
            for _ in range(resnet_blocks):
                self.pyramid.append(f"res_{idx}")
                setattr(self, f"res_{idx}", ResBlock(ch, kernel_size=kernel_size))
                idx += 1
            self.pyramid.append(f"down_{idx}")
            setattr(self, f"down_{idx}", Downsample(ch, ch * 2, factor=downsample_factor))
            idx += 1
            ch *= 2
        self.GroupNorm32_0 = GroupNorm32(ch)
        self.final = Conv1d(ch, embedding_dim, 1)
        self.n_attn = attn_blocks
        for i in range(attn_blocks):
            setattr(self, f"attn_{i}", AttentionBlock(embedding_dim, num_attn_heads))

    def forward(self, x_btc):
        h = self.init(x_btc)
        for name in self.pyramid:
            h = getattr(self, name)(h)
        h = self.final(F.silu(self.GroupNorm32_0(h)))
        for i in range(self.n_attn):
            h = getattr(self, f"attn_{i}")(h)
        return h[:, 0]
