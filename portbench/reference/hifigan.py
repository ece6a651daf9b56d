"""The fast pipeline's HiFi-GAN decoder as a plain float32 model.

Reference tortoise/models/hifigan_decoder.py:159-303 (the decoder of
tortoise/api_fast.py): the GPT latents linearly interpolated x4 and then
x(24000/22050) (``F.interpolate``, ``align_corners=False``), conv_pre plus
a dense of the speaker latent, four transposed-conv upsamplings [8, 8, 2,
2], each followed by the mean of three type-1 MRF blocks (kernels 3, 7, 11,
dilations 1, 3, 5), conv_post and tanh. Weight norm is folded into the
weights, which the benchmark makes whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import Conv1d, ConvTranspose1d, Dense

SLOPE = 0.1
KERNELS, DILATIONS = (3, 7, 11), (1, 3, 5)
UPSAMPLE, UP_KERNELS = (8, 8, 2, 2), (16, 16, 4, 4)


class ResBlock1(nn.Module):
    def __init__(self, ch: int, k: int):
        super().__init__()
        for i, d in enumerate(DILATIONS):
            setattr(self, f"conv1_{i}", Conv1d(ch, ch, k, padding=(k * d - d) // 2, dilation=d))
            setattr(self, f"conv2_{i}", Conv1d(ch, ch, k, padding=(k - 1) // 2))

    def forward(self, x):
        for i in range(len(DILATIONS)):
            xt = getattr(self, f"conv1_{i}")(F.leaky_relu(x, SLOPE))
            x = x + getattr(self, f"conv2_{i}")(F.leaky_relu(xt, SLOPE))
        return x


class Hifigan(nn.Module):
    def __init__(self, in_channels: int = 1024, initial: int = 512):
        super().__init__()
        self.conv_pre = Conv1d(in_channels, initial, 7, padding=3)
        self.cond_layer = Dense(in_channels, initial)
        ch = initial
        for i, (u, k) in enumerate(zip(UPSAMPLE, UP_KERNELS)):
            out = initial // 2 ** (i + 1)
            setattr(self, f"up_{i}", ConvTranspose1d(ch, out, k, u, padding=(k - u) // 2))
            for j, rk in enumerate(KERNELS):
                setattr(self, f"resblock_{i}_{j}", ResBlock1(out, rk))
            ch = out
        self.conv_post = Conv1d(ch, 1, 7, padding=3)

    def forward(self, latents, speaker):
        """latents (B, n, D) float32, speaker (B, D) -> wav (B, S) in [-1, 1]."""
        return self.decode(self.interpolate(latents), speaker)

    @staticmethod
    def interpolate(latents):
        x = F.interpolate(latents.float().transpose(1, 2), scale_factor=4.0, mode="linear",
                          align_corners=False)
        return F.interpolate(x, scale_factor=24000.0 / 22050.0, mode="linear",
                             align_corners=False).transpose(1, 2)

    def decode(self, x, speaker):
        """The stack after the interpolation: (B, T, D) frames -> (B, 256 T)."""
        o = self.conv_pre(x) + self.cond_layer(speaker)[:, None, :]
        for i in range(len(UPSAMPLE)):
            o = getattr(self, f"up_{i}")(F.leaky_relu(o, SLOPE))
            o = sum(getattr(self, f"resblock_{i}_{j}")(o) for j in range(len(KERNELS))) \
                / len(KERNELS)
        return torch.tanh(self.conv_post(F.leaky_relu(o, 0.01)))[..., 0]
