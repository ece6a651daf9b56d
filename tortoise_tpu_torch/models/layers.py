"""Leaf parameter modules shared by every model of the port.

Each holds the parameters of one flax leaf module of ``tortoise_tpu`` under
the same attribute path, so a port parameter ``a.b.weight`` is the JAX tree's
``a/b/kernel`` (or ``scale`` / ``embedding``) in torch layout; see
``convert/from_jax.py``. ``lead`` adds leading axes for layers that the JAX
package stacks under ``nn.scan``; ``forward(..., l=i)`` then uses layer ``i``.

Activations keep the JAX package's (batch, time, channels) layout; the conv
modules transpose to torch's (batch, channels, time) around the call.

``dtype`` is a product's compute dtype, flax's ``dtype`` beside its
``param_dtype``: the input, weight and bias are cast to it at use, so a
bf16 forward over float32 parameters returns float32 gradients to them, as
``jax.grad`` does. ``dtype=None`` computes in the stored weight's dtype:
the serving models, whose weights ``weights.cast_for_inference`` casts in
place. A tensor already in the compute dtype is used as it is.

A module built with a ``dtype`` rounds where the JAX module does: a dense's
product rounds before its bias is added, ``silu`` and ``gelu`` round after
each of jax.nn's ops. The serving models (``dtype=None``) keep the fused
ops, each rounding once, that they were served with.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _pick(t: torch.Tensor | None, l: int | None):
    return t if (t is None or l is None) else t[l]


def cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    """``t`` in ``dtype``: ``t`` itself when it has it (or is None)."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


def silu(x, dtype: torch.dtype | None):
    """SiLU of a module with compute dtype ``dtype``: jax.nn.silu's ``x *
    logistic(x)``, the logistic as XLA expands it, ``1 / (1 + exp(-x))``,
    rounding after each op; None: ``F.silu``."""
    return F.silu(x) if dtype is None else x * (1 / (1 + torch.exp(-x)))


def gelu(x, dtype: torch.dtype | None):
    """Exact (erf) GELU of a module with compute dtype ``dtype``:
    jax.nn.gelu's ``0.5 x erfc(-x sqrt(1/2))``, the constant in x's dtype,
    rounding after each op; None: ``F.gelu``."""
    if dtype is None:
        return F.gelu(x)
    return 0.5 * x * torch.erfc(-x * torch.tensor(np.sqrt(0.5), dtype=x.dtype))


class Dense(nn.Module):
    """flax ``nn.Dense``: weight (*lead, out, in), bias (*lead, out), the
    product in ``dtype`` (None: the weight's)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 lead: tuple = (), dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*lead, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(*lead, out_features)) if bias else None
        self.dtype = dtype

    def forward(self, x, l: int | None = None, bias: bool = True):
        """``bias=False``: the product of the compute-dtype operands alone,
        in float32, a row-split product's partial sum, all-reduced before
        its bias is added once (``models/gpt2.py``): the sum rounds to the
        compute dtype once, as the unsplit product does."""
        w = _pick(self.weight, l)
        dt = w.dtype if self.dtype is None else self.dtype
        if not bias:
            return F.linear(cast(x, dt).float(), cast(w, dt).float())
        b = cast(_pick(self.bias, l), dt)
        if self.dtype is None or b is None:
            return F.linear(cast(x, dt), cast(w, dt), b)
        # flax's order: the product rounds to the compute dtype, then the
        # bias is added in it
        return F.linear(cast(x, dt), cast(w, dt)) + b


def quantize_rows(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a float weight (*lead, out, in):
    scale s = max(max|w| over in, 1e-12) / 127, q = round(w / s) (half to
    even) clipped to +-127. Returns (q int8, s float32 (*lead, out)), the
    rule of ``tortoise_tpu/weights.py::quantize_gpt_weights``."""
    w = w.float()
    s = w.abs().amax(-1).clamp_min(1e-12) / 127.0
    q = torch.round(w / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


class QuantDense(nn.Module):
    """Weight-only int8 dense (``tortoise_tpu/models/gpt2.py::QuantDense``):
    int8 weight (*lead, out, in), f32 per-output ``qscale`` and bias. The
    product accumulates in f32, then ``acc * qscale + bias`` rounds once to
    the input's dtype."""

    def __init__(self, in_features: int, out_features: int, lead: tuple = ()):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*lead, out_features, in_features,
                                               dtype=torch.int8), requires_grad=False)
        self.qscale = nn.Parameter(torch.ones(*lead, out_features))
        self.bias = nn.Parameter(torch.zeros(*lead, out_features))

    def forward(self, x, l: int | None = None, bias: bool = True):
        """``bias=False``: the float32 ``acc * qscale`` alone, as ``Dense``."""
        w, s, b = _pick(self.weight, l), _pick(self.qscale, l), _pick(self.bias, l)
        acc = F.linear(x.float(), w.float()) * s.float()
        return (acc + b.float()).to(x.dtype) if bias else acc


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over time on (B, T, C) input: weight (*lead, out,
    in / groups, K); ``groups`` is flax's ``feature_group_count``; the
    convolution in ``dtype`` (None: the weight's)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, lead: tuple = (), groups: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*lead, out_ch, in_ch // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(*lead, out_ch))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.dtype = dtype

    def forward(self, x, l: int | None = None):
        w = _pick(self.weight, l)
        dt = w.dtype if self.dtype is None else self.dtype
        y = F.conv1d(cast(x, dt).transpose(1, 2), cast(w, dt), cast(_pick(self.bias, l), dt),
                     stride=self.stride, padding=self.padding, dilation=self.dilation,
                     groups=self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """torch ``ConvTranspose1d`` on (B, T, C): weight (in, out, K). The JAX
    package stores it as a time-flipped (K, in, out) dilated-conv kernel."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 padding: int, output_padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding, self.output_padding = stride, padding, output_padding

    def forward(self, x):
        y = F.conv_transpose1d(x.to(self.weight.dtype).transpose(1, 2), self.weight,
                               self.bias, stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding)
        return y.transpose(1, 2)


class Norm(nn.Module):
    """Scale/bias of a flax LayerNorm or GroupNorm: weight (= scale), bias."""

    def __init__(self, channels: int, lead: tuple = ()):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(*lead, channels))
        self.bias = nn.Parameter(torch.zeros(*lead, channels))

    def params(self, l: int | None = None):
        return _pick(self.weight, l).float(), _pick(self.bias, l).float()


class LayerNorm(Norm):
    """flax ``nn.LayerNorm(dtype=float32)``: returns float32."""

    def __init__(self, channels: int, eps: float = 1e-5, lead: tuple = ()):
        super().__init__(channels, lead)
        self.eps = eps

    def forward(self, x, l: int | None = None):
        w, b = self.params(l)
        return F.layer_norm(x.float(), (x.shape[-1],), w, b, self.eps)


class Embed(nn.Module):
    """flax ``nn.Embed`` (or a bucket table): weight (*lead, num, dim). The
    rows come out in the table's dtype, as flax's with no ``dtype``: float32
    in training, bf16 from a model cast for serving."""

    def __init__(self, num: int, dim: int, lead: tuple = ()):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*lead, num, dim))

    def forward(self, idx):
        return F.embedding(idx, self.weight)
