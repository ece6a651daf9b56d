"""UnivNet-c32 vocoder: mel + noise -> 24 kHz waveform, float32.

Port of ``tortoise_tpu/models/vocoder.py`` (reference
tortoise/models/vocoder.py:225-312): 256x upsampling through 3 LVC blocks
(strides 8/8/4), each with four dilated convs gated by location-variable
convolutions whose per-frame kernels a KernelPredictor derives from the mel.
The LVC is the JAX package's default shifted-reshape form (K shifted
reshapes + frame-batched matmuls) or, with ``UnivNetConfig.use_kernel`` (the
JAX package's ``use_pallas``), kernel K4 (``ops/lvc.py``), which the quality
API turns on for CUDA.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tortoise_tpu_torch.models.layers import Conv1d, ConvTranspose1d
from tortoise_tpu_torch.ops.lvc import location_variable_convolution_lvc

LRELU_SLOPE = 0.2


def location_variable_convolution(x, kernels, bias, hop: int):
    """x (B, F*hop, Ci); kernels (B, F, Ci, Co, K); bias (B, F, Co). Each
    hop-long segment of x is convolved ('same' padding, halo from its
    neighbours) with its own kernel. Returns (B, F*hop, Co)."""
    b, t, ci = x.shape
    _, f, _, co, k = kernels.shape
    assert t == f * hop, f"length mismatch: {t} != {f}*{hop}"
    p = (k - 1) // 2
    xp = F.pad(x, (0, 0, p, p))
    y = bias[:, :, None, :].float()
    for tap in range(k):
        xk = xp[:, tap:tap + t].reshape(b, f, hop, ci)
        y = y + torch.einsum("bfsi,bfio->bfso", xk, kernels[..., tap])
    return y.reshape(b, f * hop, co).to(x.dtype)


def predictor_layout(kernel_out, bias_out, layers: int, ci: int, co: int, k: int):
    """The kernel predictor's conv outputs (B, F, L*Ci*Co*K) and (B, F, L*Co)
    as kernels (B, L, F, Ci, Co, K) and bias (B, L, F, Co), views without a
    copy: from Conv1d's transposed view of a channels-first output, frames
    innermost, which K4 reads as they lie."""
    b, f, _ = kernel_out.shape
    return (kernel_out.reshape(b, f, layers, ci, co, k).transpose(1, 2),
            bias_out.reshape(b, f, layers, co).transpose(1, 2))


def random_predictor_output(g: torch.Generator, b: int, layers: int, f: int, ci: int, co: int,
                            k: int):
    """Random kernels and bias on g's device, laid out as
    KernelPredictor.forward returns them (predictor_layout of channels-first
    conv outputs): K4's inputs as UnivNet hands them over."""
    kern = torch.randn((b, layers * ci * co * k, f), generator=g, device=g.device)
    bias = torch.randn((b, layers * co, f), generator=g, device=g.device)
    return predictor_layout(kern.transpose(1, 2), bias.transpose(1, 2), layers, ci, co, k)


class KernelPredictor(nn.Module):
    def __init__(self, cond_channels: int, conv_in_channels: int, conv_out_channels: int,
                 conv_layers: int, conv_kernel_size: int = 3, hidden: int = 64,
                 kpnet_conv_size: int = 3):
        super().__init__()
        pad = (kpnet_conv_size - 1) // 2
        self.shape = (conv_layers, conv_in_channels, conv_out_channels, conv_kernel_size)
        self.input_conv = Conv1d(cond_channels, hidden, 5, padding=2)
        for i in range(3):
            setattr(self, f"res_{i}_a", Conv1d(hidden, hidden, kpnet_conv_size, padding=pad))
            setattr(self, f"res_{i}_b", Conv1d(hidden, hidden, kpnet_conv_size, padding=pad))
        lw = conv_in_channels * conv_out_channels * conv_kernel_size * conv_layers
        self.kernel_conv = Conv1d(hidden, lw, kpnet_conv_size, padding=pad)
        self.bias_conv = Conv1d(hidden, conv_out_channels * conv_layers, kpnet_conv_size,
                                padding=pad)

    def forward(self, c):
        """c (B, F, mel) -> kernels (B, L, F, Ci, Co, K), bias (B, L, F, Co)."""
        h = F.leaky_relu(self.input_conv(c), LRELU_SLOPE)
        for i in range(3):
            r = F.leaky_relu(getattr(self, f"res_{i}_a")(h), LRELU_SLOPE)
            h = h + F.leaky_relu(getattr(self, f"res_{i}_b")(r), LRELU_SLOPE)
        return predictor_layout(self.kernel_conv(h), self.bias_conv(h), *self.shape)


class LVCBlock(nn.Module):
    def __init__(self, in_channels: int, stride: int, dilations=(1, 3, 9, 27),
                 conv_kernel_size: int = 3, cond_hop_length: int = 256, cond_channels: int = 100,
                 use_kernel: bool = False):
        super().__init__()
        s = stride
        self.in_channels, self.hop, self.dilations = in_channels, cond_hop_length, dilations
        self.use_kernel = use_kernel
        self.kernel_predictor = KernelPredictor(cond_channels, in_channels, 2 * in_channels,
                                                len(dilations), conv_kernel_size)
        self.convt_pre = ConvTranspose1d(in_channels, in_channels, 2 * s, s,
                                         padding=s // 2 + s % 2, output_padding=s % 2)
        for i, d in enumerate(dilations):
            setattr(self, f"conv_{i}", Conv1d(in_channels, in_channels, conv_kernel_size,
                                              padding=d * (conv_kernel_size - 1) // 2,
                                              dilation=d))

    def forward(self, x, c):
        # K4 reads the predictor's frames-innermost layout as it is
        kernels, bias = self.kernel_predictor(c)
        lvc = location_variable_convolution_lvc if self.use_kernel \
            else location_variable_convolution
        x = self.convt_pre(F.leaky_relu(x, LRELU_SLOPE))
        ch = self.in_channels
        for i in range(len(self.dilations)):
            out = F.leaky_relu(getattr(self, f"conv_{i}")(F.leaky_relu(x, LRELU_SLOPE)),
                               LRELU_SLOPE)
            out = lvc(out, kernels[:, i], bias[:, i], self.hop)
            x = x + torch.sigmoid(out[..., :ch]) * torch.tanh(out[..., ch:])
        return x


@dataclasses.dataclass(frozen=True)
class UnivNetConfig:
    noise_dim: int = 64
    channel_size: int = 32
    dilations: tuple = (1, 3, 9, 27)
    strides: tuple = (8, 8, 4)
    hop_length: int = 256
    n_mel_channels: int = 100
    # the LVC through kernel K4 (the JAX package's use_pallas): its plain
    # version on CPU tensors, the CUDA kernel on CUDA tensors
    use_kernel: bool = False


def _reflect_pad(x, p: int):
    return F.pad(x.transpose(1, 2), (p, p), mode="reflect").transpose(1, 2)


class UnivNetGenerator(nn.Module):
    def __init__(self, config: UnivNetConfig = UnivNetConfig()):
        super().__init__()
        cfg = self.config = config
        self.conv_pre = Conv1d(cfg.noise_dim, cfg.channel_size, 7)
        hop = 1
        for i, s in enumerate(cfg.strides):
            hop *= s
            setattr(self, f"lvc_{i}", LVCBlock(cfg.channel_size, s, cfg.dilations,
                                               cond_hop_length=hop,
                                               cond_channels=cfg.n_mel_channels,
                                               use_kernel=cfg.use_kernel))
        self.conv_post = Conv1d(cfg.channel_size, 1, 7)

    def forward(self, c, z):
        """c (B, F, 100) mel; z (B, F, noise_dim) -> (B, F*256, 1)."""
        x = self.conv_pre(_reflect_pad(z, 3))
        for i in range(len(self.config.strides)):
            x = getattr(self, f"lvc_{i}")(x, c)
        x = self.conv_post(_reflect_pad(F.leaky_relu(x, LRELU_SLOPE), 3))
        return torch.tanh(x)

    def inference(self, c, z):
        """Append 10 frames of log-floor mel, decode, trim 10 hops, clamp
        (reference vocoder.py:300-312). z has F + 10 frames."""
        cfg = self.config
        pad = torch.full((c.shape[0], 10, cfg.n_mel_channels), -11.5129, dtype=c.dtype,
                         device=c.device)
        audio = self(torch.cat([c, pad], dim=1), z)
        return audio[:, : -(cfg.hop_length * 10)].clamp(-1, 1)
