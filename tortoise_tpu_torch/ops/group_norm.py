"""GroupNorm in float32 and the activation chain after it: kernel
``group_norm_act`` (csrc/group_norm.cu) and its plain PyTorch version.

For x (B, T, C) the statistics of each (batch row, group) cover the frames
``mask`` ((B, T) bool) marks valid, over their count (without a mask:
``F.group_norm`` over every frame); then the per-channel affine ``weight``,
``bias`` (C,) float32, a cast to ``out_dtype`` (x's by default), and,
optionally, the FiLM ``* (1 + scale) + shift`` of ``film`` ((B, 2C), scale
then shift) and SiLU, each rounded in the output dtype as PyTorch's ops
round them. With a mask, padded frames come out zero (and a row with no
valid frame zero throughout).

The JAX package leaves GroupNorm to XLA, so this kernel replaces none of its
kernels: it is the diffusion decoder's masked norm chain, 46 a served
forward (``models/blocks.py`` ``GroupNorm32``), which op by op was ~21
launches writing full-width float32 intermediates.

The wrapper dispatches on the device of ``x``: CPU tensors run the plain
version, CUDA tensors launch the kernel (bf16 x, groups of 32 channels, at
most ``MAX_FRAMES`` frames, bf16 or float32 out) or raise. ``engages`` is the
condition under which a module routes a chain to the wrapper on the card.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.models.layers import silu as _silu
from tortoise_tpu_torch.ops import _build

GROUP_WIDTH = 32
MAX_FRAMES = 3072
_P = ctypes.c_void_p
_I = ctypes.c_int
_KERNEL = _build.Kernel("group_norm", "tt_group_norm_act",
                        [_P] * 6 + [_I] * 4 + [ctypes.c_float, _I])


def group_norm_act_plain(x, mask, weight, bias, groups: int, eps: float, film=None,
                         silu: bool = False, out_dtype=None, dtype=None):
    """The chain op by op; ``dtype`` is the caller's compute dtype, which
    picks SiLU's form (``models/layers.silu``; None: ``F.silu``, the
    kernel's)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    b, t, c = x.shape
    if mask is None:
        y = F.group_norm(x.float().transpose(1, 2), groups, weight, bias, eps)
        y = y.transpose(1, 2).to(out_dtype)
    else:
        m = mask.float()[:, :, None]                                      # (B, T, 1)
        xg = (x.float() * m).reshape(b, t, groups, c // groups)
        count = (m.sum(dim=1, keepdim=True) * (c // groups)).clamp(min=1)  # (B, 1, 1)
        mean = xg.sum(dim=(1, 3)) / count[:, 0]                           # (B, G)
        dev = xg - mean[:, None, :, None]
        var = (dev ** 2 * m[..., None]).sum(dim=(1, 3)) / count[:, 0]
        xn = (dev * torch.rsqrt(var[:, None, :, None] + eps)).reshape(b, t, c)
        y = ((xn * weight + bias) * m).to(out_dtype)
    if film is not None:
        scale, shift = film[:, None, :].chunk(2, dim=-1)
        y = y * (1 + scale) + shift
    if silu:
        y = _silu(y, dtype)
    if mask is not None and (film is not None or silu):
        y = y * mask[:, :, None].to(y.dtype)
    return y


def engages(x, mask, weight, bias, groups: int, film=None) -> bool:
    """Whether a chain on these inputs takes the kernel: x bf16 and
    contiguous on the card, a mask, no gradient wanted, groups of
    ``GROUP_WIDTH`` channels, at most ``MAX_FRAMES`` frames, a film of
    (B, 2C) bf16 or none. The caller adds its own condition (the serving
    model's compute dtype None)."""
    if mask is None or not x.is_cuda:
        return False
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, film)):
        return False
    b, t, c = x.shape
    return (x.dtype == torch.bfloat16 and x.is_contiguous() and c == groups * GROUP_WIDTH
            and t <= MAX_FRAMES
            and (film is None or (film.dtype == torch.bfloat16 and film.is_contiguous()
                                  and tuple(film.shape) == (b, 2 * c))))


def _check(x, mask, weight, bias, groups, film, out_dtype):
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(f"group_norm_act: x needs a contiguous, 16-byte aligned bf16 (B, T, C) "
                         f"tensor, got {x.dtype} {tuple(x.shape)} strides {x.stride()}")
    b, t, c = x.shape
    dev = x.device
    if c % groups or c // groups != GROUP_WIDTH:
        raise ValueError(f"group_norm_act: groups of {GROUP_WIDTH} channels only, got C={c} in "
                         f"{groups} groups")
    if not 1 <= t <= MAX_FRAMES:
        raise ValueError(f"group_norm_act: 1 to {MAX_FRAMES} frames, got {t}")
    want = {"mask": (mask, (b, t), torch.bool), "weight": (weight, (c,), torch.float32),
            "bias": (bias, (c,), torch.float32)}
    if film is not None:
        want["film"] = (film, (b, 2 * c), torch.bfloat16)
    for name, (v, shape, dtype) in want.items():
        # every operand but the mask is read in 16-byte vectors
        aligned = name == "mask" or v.data_ptr() % 16 == 0
        if tuple(v.shape) != shape or v.dtype != dtype or v.device != dev \
                or not v.is_contiguous() or not aligned:
            raise ValueError(f"group_norm_act: {name} needs a contiguous {dtype} {shape} tensor "
                             f"on {dev} (16-byte aligned but the mask), got {v.dtype} "
                             f"{tuple(v.shape)} strides {v.stride()} on {v.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm_act: bf16 or float32 out, got {out_dtype}")


def group_norm_act(x, mask, weight, bias, groups: int, eps: float, film=None,
                   silu: bool = False, out_dtype=None):
    """See the module's text. Returns (B, T, C) in ``out_dtype``."""
    if not x.is_cuda:
        return group_norm_act_plain(x, mask, weight, bias, groups, eps, film, silu, out_dtype)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if mask is None:
        raise ValueError("group_norm_act: the kernel needs a mask")
    _check(x, mask, weight, bias, groups, film, out_dtype)
    b, t, c = x.shape
    out = torch.empty((b, t, c), dtype=out_dtype, device=x.device)
    _KERNEL(x.get_device(), x.data_ptr(), mask.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if film is None else film.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), b, t, c, float(eps), int(silu))
    group_norm_act.launches += 1
    return out


group_norm_act.launches = 0
