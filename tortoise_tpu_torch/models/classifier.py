"""Tortoise-detect classifier (port of ``tortoise_tpu/models/classifier.py``;
reference tortoise/models/classifier.py).

An AudioMiniEncoder pyramid over the raw 24 kHz waveform and a linear head.
Shipped config (reference api.py:139-141): 2 classes, spec_dim=1, embedding
512, depth 5, downsample 4, base 32, kernel 5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from tortoise_tpu_torch.models.blocks import AudioMiniEncoder
from tortoise_tpu_torch.models.layers import Dense


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    classes: int = 2
    spec_dim: int = 1
    embedding_dim: int = 512
    base_channels: int = 32
    depth: int = 5
    resnet_blocks: int = 2
    attn_blocks: int = 4
    num_attn_heads: int = 4
    downsample_factor: int = 4
    kernel_size: int = 5


class AudioMiniEncoderWithClassifierHead(nn.Module):
    def __init__(self, config: ClassifierConfig = ClassifierConfig()):
        super().__init__()
        cfg = self.config = config
        self.enc = AudioMiniEncoder(
            spec_dim=cfg.spec_dim, embedding_dim=cfg.embedding_dim,
            base_channels=cfg.base_channels, depth=cfg.depth, resnet_blocks=cfg.resnet_blocks,
            attn_blocks=cfg.attn_blocks, num_attn_heads=cfg.num_attn_heads,
            downsample_factor=cfg.downsample_factor, kernel_size=cfg.kernel_size)
        self.head = Dense(cfg.embedding_dim, cfg.classes)

    def forward(self, x_btc):
        """x_btc: (B, T, spec_dim) waveform -> (B, classes) logits."""
        return self.head(self.enc(x_btc))


@torch.inference_mode()
def classify_audio_clip(clip, model: AudioMiniEncoderWithClassifierHead) -> float:
    """Probability that the clip came from Tortoise (reference api.py:133-145).
    clip: a (T,) or (1, T) waveform, numpy or torch, moved to the model's
    device."""
    dev = next(model.parameters()).device
    clip = torch.as_tensor(np.asarray(clip, np.float32), device=dev)
    if clip.ndim == 1:
        clip = clip[None]
    logits = model(clip[:, :, None])
    return float(torch.softmax(logits.float(), dim=-1)[0, 0])
