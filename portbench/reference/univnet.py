"""UnivNet-c32, the quality pipeline's vocoder, as a plain float32 model.

Reference tortoise/models/vocoder.py:225-312: noise through a k=7 conv,
three LVC blocks (strides 8, 8, 4), each a transposed conv and four dilated
convs (1, 3, 9, 27) gated by location-variable convolutions whose per-frame
kernels and biases a kernel predictor derives from the mel, then a k=7
conv and tanh. The served decode appends ten frames of the log floor to the
mel and trims ten hops after this forward, as the reference's
``inference`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import Conv1d, ConvTranspose1d, tf32

SLOPE = 0.2
NOISE, CH, STRIDES, DILATIONS, MELS, HOP = 64, 32, (8, 8, 4), (1, 3, 9, 27), 100, 256


def lvc(x, kernels, bias, hop: int, precision: str):
    """x (B, F*hop, Ci); kernels (B, F, Ci, Co, K); bias (B, F, Co): each
    hop-long frame convolved ('same', the halo from its neighbours) with its
    own kernel (vocoder.py:137-173)."""
    b, t, ci = x.shape
    _, f, _, co, k = kernels.shape
    p = (k - 1) // 2
    xw = F.pad(x.float(), (0, 0, p, p)).unfold(1, hop + k - 1, hop)   # (B, F, Ci, hop+K-1)
    y = bias[:, :, None, :].float()
    with tf32(precision == "tf32"):
        for tap in range(k):
            y = y + torch.einsum("bfis,bfio->bfso", xw[..., tap:tap + hop],
                                 kernels[..., tap].float())
    return y.reshape(b, f * hop, co)


class KernelPredictor(nn.Module):
    def __init__(self, ci: int, co: int, layers: int, k: int = 3, hidden: int = 64):
        super().__init__()
        self.shape = (layers, ci, co, k)
        self.input_conv = Conv1d(MELS, hidden, 5, padding=2)
        for i in range(3):
            setattr(self, f"res_{i}_a", Conv1d(hidden, hidden, 3, padding=1))
            setattr(self, f"res_{i}_b", Conv1d(hidden, hidden, 3, padding=1))
        self.kernel_conv = Conv1d(hidden, ci * co * k * layers, 3, padding=1)
        self.bias_conv = Conv1d(hidden, co * layers, 3, padding=1)

    def forward(self, c):
        h = F.leaky_relu(self.input_conv(c), SLOPE)
        for i in range(3):
            r = F.leaky_relu(getattr(self, f"res_{i}_a")(h), SLOPE)
            h = h + F.leaky_relu(getattr(self, f"res_{i}_b")(r), SLOPE)
        layers, ci, co, k = self.shape
        b, f, _ = h.shape
        return (self.kernel_conv(h).reshape(b, f, layers, ci, co, k),
                self.bias_conv(h).reshape(b, f, layers, co))


class LVCBlock(nn.Module):
    precision = "f32"

    def __init__(self, stride: int, hop: int):
        super().__init__()
        self.hop = hop
        self.kernel_predictor = KernelPredictor(CH, 2 * CH, len(DILATIONS))
        self.convt_pre = ConvTranspose1d(CH, CH, 2 * stride, stride,
                                         padding=stride // 2 + stride % 2,
                                         output_padding=stride % 2)
        for i, d in enumerate(DILATIONS):
            setattr(self, f"conv_{i}", Conv1d(CH, CH, 3, padding=d, dilation=d))

    def forward(self, x, c):
        kernels, bias = self.kernel_predictor(c)
        x = self.convt_pre(F.leaky_relu(x, SLOPE))
        for i in range(len(DILATIONS)):
            out = F.leaky_relu(getattr(self, f"conv_{i}")(F.leaky_relu(x, SLOPE)), SLOPE)
            out = lvc(out, kernels[:, :, i], bias[:, :, i], self.hop, self.precision)
            x = x + torch.sigmoid(out[..., :CH]) * torch.tanh(out[..., CH:])
        return x


def _reflect(x, p: int):
    return F.pad(x.transpose(1, 2), (p, p), mode="reflect").transpose(1, 2)


class UnivNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_pre = Conv1d(NOISE, CH, 7)
        hop = 1
        for i, s in enumerate(STRIDES):
            hop *= s
            setattr(self, f"lvc_{i}", LVCBlock(s, hop))
        self.conv_post = Conv1d(CH, 1, 7)

    def forward(self, mel, z):
        """mel (B, F, 100), z (B, F, 64) -> (B, F * 256)."""
        x = self.pre(z)
        for i in range(len(STRIDES)):
            x = getattr(self, f"lvc_{i}")(x, mel.float())
        return self.post(x)

    def pre(self, z):
        return self.conv_pre(_reflect(z.float(), 3))

    def post(self, x):
        return torch.tanh(self.conv_post(_reflect(F.leaky_relu(x, SLOPE), 3)))[..., 0]
