"""Interpolation over the time axis of (B, T, C) activations.

Port of ``tortoise_tpu/ops/interpolate.py``: ``F.interpolate`` semantics
(linear with ``align_corners=False``, nearest with floor indexing) written
as index math, plus the windowed gather that lets the streaming decoder
compute a slice of a global interpolation from a window of its input.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def linear_interpolate(x: torch.Tensor, scale: float, out_len: int | None = None) -> torch.Tensor:
    """1-D linear interpolation over axis 1 of (B, T, C), align_corners=False:
    output length floor(T * scale), source coordinate (i + 0.5) / scale - 0.5
    clamped to [0, T - 1]."""
    t = x.shape[1]
    if out_len is None:
        out_len = int(math.floor(t * scale))
    src = np.clip((np.arange(out_len) + 0.5) / scale - 0.5, 0.0, t - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, t - 1)
    w = torch.as_tensor((src - lo).astype(np.float32), device=x.device)[None, :, None]
    lo, hi = (torch.as_tensor(i, device=x.device) for i in (lo, hi))
    return x[:, lo] * (1.0 - w) + x[:, hi] * w


def windowed_linear_gather(x_win: torch.Tensor, win_offset: int, n_valid: int, out_start: int,
                           out_len: int, scale_num: int, scale_den: int) -> torch.Tensor:
    """The values ``linear_interpolate(x_full[:, :n_valid], scale_num /
    scale_den)`` has at output indices [out_start, out_start + out_len),
    read from ``x_win``, the slice of the full input that starts at global
    index ``win_offset``.

    The source position of output j is ((2j + 1) * scale_den - scale_num) /
    (2 * scale_num), kept as an exact int64 rational: that is what makes the
    streamed chunks exact slices of the full decode. Indices clamp to the
    window only as an out-of-range guard; the caller makes the window cover
    the source range."""
    b = 2 * scale_num
    j = out_start + torch.arange(out_len, dtype=torch.int64, device=x_win.device)
    num = ((2 * j + 1) * scale_den - scale_num).clamp(0, (n_valid - 1) * b)
    lo = num // b
    w = ((num - lo * b).to(torch.float32) / b)[None, :, None].to(x_win.dtype)
    hi = torch.clamp_max(lo + 1, n_valid - 1)
    last = x_win.shape[1] - 1
    a = x_win[:, (lo - win_offset).clamp(0, last)]
    c = x_win[:, (hi - win_offset).clamp(0, last)]
    return a * (1.0 - w) + c * w


def nearest_interpolate(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour resize over axis 1 of (B, T, C), floor((i * T) /
    out_len) in exact integers, as ``F.interpolate(mode="nearest")``."""
    t = x.shape[1]
    idx = torch.clamp_max(torch.arange(out_len, dtype=torch.int64) * t // out_len, t - 1)
    return x[:, idx.to(x.device)]
