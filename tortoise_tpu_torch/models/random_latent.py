"""Random-voice latent generator (reference
tortoise/models/random_latent_generator.py).

Port of ``tortoise_tpu/models/random_latent.py``: N(0, 1) noise -> a
plausible conditioning latent through five EqualLinear layers (StyleGAN's
equalized learning rate, leaky-relu with sqrt(2) gain) and a final dense.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.layers import Dense


class EqualLinear(nn.Module):
    """weight (out, in) stored at 1/lr_mul of its effective scale."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 0.1):
        super().__init__()
        self.lr_mul = lr_mul
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        scale = (1.0 / math.sqrt(self.weight.shape[1])) * self.lr_mul
        y = x @ (self.weight * scale).t()
        return F.leaky_relu(y + self.bias * self.lr_mul, 0.2) * math.sqrt(2.0)


class RandomLatentConverter(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        for i in range(5):
            setattr(self, f"eq_{i}", EqualLinear(channels, channels, lr_mul=0.1))
        self.final = Dense(channels, channels)

    def forward(self, noise):
        """noise: (B, channels) standard normal -> (B, channels) latent."""
        h = noise
        for i in range(5):
            h = getattr(self, f"eq_{i}")(h)
        return self.final(h)


def sample_random_latent(model: RandomLatentConverter, generator: torch.Generator,
                         batch: int = 1) -> torch.Tensor:
    """A random voice latent (batch, channels) from the generator's next
    standard-normal draw."""
    dev = model.final.weight.device
    noise = torch.randn((batch, model.channels), generator=generator, device=dev)
    return model(noise)
