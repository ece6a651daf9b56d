"""Leaf layers of the plain reference, in float32, and its precisions.

Parameters sit under the names and in the layouts of the published models'
JAX-style trees as the served program loads them: a dense weight is
(*lead, out, in), a conv weight (*lead, out, in, K), a transposed conv's
(in, out, K), a norm's scale is ``weight``. ``lead`` stacks layers on a
leading axis and ``forward(..., l=i)`` takes layer ``i``.

Every product goes through ``_operands``, which applies the module's
``precision`` (set on a whole model by ``set_precision``):

* ``"f32"``: float32 operands, TF32 off (the reference itself);
* ``"tf32"``: float32 operands with cuBLAS's and cuDNN's TF32 on, the step
  below float32 (the control of a float32 model);
* ``"fp8"``: each operand rounded to float8 e4m3 under one scale a tensor
  (its largest magnitude at 448), the step below bfloat16 (the control of
  a bfloat16 model).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

PRECISIONS = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor, in float32."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    for m in model.modules():
        m.precision = precision
    return model


@contextlib.contextmanager
def tf32(on: bool):
    """cuBLAS's and cuDNN's TF32 flags for a block, restored after it."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _pick(t, l):
    return t if (t is None or l is None) else t[l]


class _Leaf(nn.Module):
    precision = "f32"

    def _operands(self, x, w):
        if self.precision == "fp8":
            return fp8_round(x), fp8_round(w)
        return x.float(), w.float()

    def _run(self, fn):
        with tf32(self.precision == "tf32"):
            return fn()


class Dense(_Leaf):
    def __init__(self, in_features: int, out_features: int, bias: bool = True, lead=()):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*lead, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(*lead, out_features)) if bias else None

    def forward(self, x, l: int | None = None):
        xo, w = self._operands(x, _pick(self.weight, l))
        b = _pick(self.bias, l)
        return self._run(lambda: F.linear(xo, w, None if b is None else b.float()))


class Conv1d(_Leaf):
    """A convolution over time of (B, T, C) activations."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, lead=()):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*lead, out_ch, in_ch, kernel_size))
        self.bias = nn.Parameter(torch.zeros(*lead, out_ch))
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x, l: int | None = None):
        xo, w = self._operands(x, _pick(self.weight, l))
        b = _pick(self.bias, l).float()
        return self._run(lambda: F.conv1d(xo.transpose(1, 2), w, b, stride=self.stride,
                                          padding=self.padding,
                                          dilation=self.dilation).transpose(1, 2))


class ConvTranspose1d(_Leaf):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int, padding: int,
                 output_padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding, self.output_padding = stride, padding, output_padding

    def forward(self, x):
        xo, w = self._operands(x, self.weight)
        return self._run(lambda: F.conv_transpose1d(
            xo.transpose(1, 2), w, self.bias.float(), stride=self.stride,
            padding=self.padding, output_padding=self.output_padding).transpose(1, 2))


class Norm(nn.Module):
    """The scale (``weight``) and shift (``bias``) of a layer or group norm."""

    def __init__(self, channels: int, lead=()):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(*lead, channels))
        self.bias = nn.Parameter(torch.zeros(*lead, channels))

    def params(self, l: int | None = None):
        return _pick(self.weight, l).float(), _pick(self.bias, l).float()


class LayerNorm(Norm):
    def __init__(self, channels: int, eps: float = 1e-5, lead=()):
        super().__init__(channels, lead)
        self.eps = eps

    def forward(self, x, l: int | None = None):
        w, b = self.params(l)
        return F.layer_norm(x.float(), (x.shape[-1],), w, b, self.eps)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int, lead=()):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*lead, num, dim))

    def forward(self, idx):
        return F.embedding(idx, self.weight.float())
