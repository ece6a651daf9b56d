"""HiFi-GAN decoder: GPT latents -> 24 kHz waveform (the fast path).

Port of ``tortoise_tpu/models/hifigan.py`` (reference
tortoise/models/hifigan_decoder.py:159-303): conv_pre over the GPT latents
plus a speaker-conditioning dense, four transposed-conv upsample stages
[8, 8, 2, 2], each followed by the mean of three ResBlocks (kernels 3/7/11,
dilations 1/3/5), then conv_post and tanh. Weight norm is folded at
conversion. float32, like the JAX package (the caller keeps TF32 off).

Activations are (B, T, C). ``valid_frames`` zeroes every activation at or
past the valid length after each conv, so a right-padded input decodes its
valid region exactly as an unpadded one; ``inference_window`` uses it to
decode one fixed-size window of a stream.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.layers import Conv1d, ConvTranspose1d, Dense
from tortoise_tpu_torch.ops.interpolate import linear_interpolate, windowed_linear_gather

LRELU_SLOPE = 0.1


class ResBlock1(nn.Module):
    """MRF residual block type 1 (reference hifigan_decoder.py:15-103)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3, 5)):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            setattr(self, f"conv1_{i}", Conv1d(channels, channels, kernel_size,
                                               padding=(kernel_size * d - d) // 2, dilation=d))
            setattr(self, f"conv2_{i}", Conv1d(channels, channels, kernel_size,
                                               padding=(kernel_size - 1) // 2))

    def forward(self, x, valid_mask=None):
        for i in range(len(self.dilations)):
            xt = getattr(self, f"conv1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            if valid_mask is not None:
                xt = xt * valid_mask      # conv2 reads this; pads must stay zero
            xt = getattr(self, f"conv2_{i}")(F.leaky_relu(xt, LRELU_SLOPE))
            if valid_mask is not None:
                xt = xt * valid_mask
            x = x + xt
        return x


class ResBlock2(nn.Module):
    """MRF residual block type 2 (reference hifigan_decoder.py:105-156)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3)):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            setattr(self, f"conv_{i}", Conv1d(channels, channels, kernel_size,
                                              padding=(kernel_size * d - d) // 2, dilation=d))

    def forward(self, x, valid_mask=None):
        for i in range(len(self.dilations)):
            xt = getattr(self, f"conv_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            if valid_mask is not None:
                xt = xt * valid_mask
            x = x + xt
        return x


@dataclasses.dataclass(frozen=True)
class HifiganConfig:
    """Shipping config of the reference (api_fast.py:222-225)."""
    in_channels: int = 1024
    out_channels: int = 1
    resblock_type: str = "1"
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    resblock_kernel_sizes: tuple = (3, 7, 11)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    upsample_factors: tuple = (8, 8, 2, 2)
    cond_channels: int = 1024


class HifiganGenerator(nn.Module):
    def __init__(self, config: HifiganConfig = HifiganConfig()):
        super().__init__()
        cfg = self.config = config
        self.conv_pre = Conv1d(cfg.in_channels, cfg.upsample_initial_channel, 7, padding=3)
        self.cond_layer = Dense(cfg.cond_channels, cfg.upsample_initial_channel)
        resblock = ResBlock1 if cfg.resblock_type == "1" else ResBlock2
        ch = cfg.upsample_initial_channel
        for i, (u, k) in enumerate(zip(cfg.upsample_factors, cfg.upsample_kernel_sizes)):
            out = cfg.upsample_initial_channel // (2 ** (i + 1))
            setattr(self, f"up_{i}", ConvTranspose1d(ch, out, k, u, padding=(k - u) // 2))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                setattr(self, f"resblock_{i}_{j}", resblock(out, rk, rd))
            ch = out
        self.conv_post = Conv1d(ch, cfg.out_channels, 7, padding=3)

    def forward(self, x, g=None, valid_frames: int | None = None):
        """x: (B, T, in_channels); g: (B, cond_channels). Returns (B, T *
        prod(upsample_factors), out_channels) in [-1, 1]. Frames at or past
        ``valid_frames`` are right-padding: zeroed after every conv."""
        cfg = self.config

        def mask_for(t, valid):
            if valid is None:
                return None
            return (torch.arange(t, device=x.device) < valid).to(x.dtype)[None, :, None]

        vm = mask_for(x.shape[1], valid_frames)
        if vm is not None:
            x = x * vm
        o = self.conv_pre(x)
        if g is not None:
            o = o + self.cond_layer(g)[:, None, :]
        if vm is not None:
            o = o * vm
        n_kernels = len(cfg.resblock_kernel_sizes)
        valid = valid_frames
        for i, u in enumerate(cfg.upsample_factors):
            o = getattr(self, f"up_{i}")(F.leaky_relu(o, LRELU_SLOPE))
            if valid is not None:
                valid = valid * u
                vm = mask_for(o.shape[1], valid)
                o = o * vm
            z = sum(getattr(self, f"resblock_{i}_{j}")(o, valid_mask=vm)
                    for j in range(n_kernels))
            o = z / n_kernels
        o = self.conv_post(F.leaky_relu(o, 0.01))  # the reference's default slope here
        return torch.tanh(o)

    def inference(self, c, g, valid_frames: int | None = None):
        """c: (B, T, in_channels) GPT latents; g: (B, cond_channels). The
        latents are linearly interpolated x(1024/256), then x(24000/22050),
        and decoded (reference hifigan_decoder.py:268-294)."""
        up = linear_interpolate(c, 1024.0 / 256.0)
        up = linear_interpolate(up, 24000.0 / 22050.0)
        return self(up, g, valid_frames=valid_frames)

    def inference_window(self, c_win, g, lat_offset: int, n_valid: int, u_start: int,
                         u_len: int, valid_u: int | None = None):
        """Samples [u_start * 256, (u_start + u_len) * 256) of what
        ``inference(c_full[:, :n_valid], g)`` produces, computed from
        ``c_win``, the latent frames from global index ``lat_offset``.

        The interpolations use global index math, so the window's inner
        samples equal the full decode's; the conv stack's receptive field
        (~15 u-frames a side at the shipping config) makes the window's edge
        frames differ, and callers keep a halo at least that wide. ``valid_u``
        (window-relative) masks u-frames at and past the decode frontier, as
        the full decode's right edge."""
        m_offset = 4 * lat_offset
        mel_win = windowed_linear_gather(c_win, lat_offset, n_valid, m_offset,
                                         4 * c_win.shape[1], 1024, 256)
        u = windowed_linear_gather(mel_win, m_offset, 4 * n_valid, u_start, u_len, 24000, 22050)
        return self(u, g, valid_frames=valid_u)
