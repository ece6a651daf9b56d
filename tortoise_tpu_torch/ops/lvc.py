"""K4: UnivNet's location-variable convolution, as a CUDA kernel
(csrc/lvc.cu) and its plain PyTorch version.

Port of ``tortoise_tpu/ops/lvc_pallas.py::location_variable_convolution_pallas``:
x (B, F*hop, Ci), kernels (B, F, Ci, Co, K), bias (B, F, Co) -> (B, F*hop,
Co). Each hop-long frame of x is convolved with its own kernel, 'same'
padding, the halo taken from the neighbouring frames and zeros past the
ends. The kernel adds the bias in its epilogue.

``location_variable_convolution_lvc`` dispatches on the device of ``x``:
CPU tensors run ``location_variable_convolution_lvc_plain``, CUDA tensors
launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_KERNEL = _build.Kernel("lvc", "tt_lvc", [_P] * 4 + [_I] * 6 + [_L] * 7)


def location_variable_convolution_lvc_plain(x, kernels, bias, hop: int):
    """The Pallas body's arithmetic: per frame, the (hop + K - 1, Ci) window
    with its halo; the sum over taps of a shifted (hop, Ci) @ (Ci, Co)
    product in f32; cast to x's dtype; plus the bias."""
    b, t, ci = x.shape
    _, f, _, co, k = kernels.shape
    if t != f * hop:
        raise ValueError(f"length mismatch: {t} != {f}*{hop}")
    p = (k - 1) // 2
    xw = F.pad(x, (0, 0, p, p)).unfold(1, hop + k - 1, hop)      # (B, F, Ci, hop + K - 1)
    acc = torch.zeros((b, f, hop, co), dtype=torch.float32, device=x.device)
    for tap in range(k):
        acc = acc + torch.einsum("bfis,bfio->bfso", xw[..., tap:tap + hop].float(),
                                 kernels[..., tap].float())
    out = acc.to(x.dtype) + bias[:, :, None, :].to(x.dtype)
    return out.reshape(b, f * hop, co)


def _check_cuda_args(x, kernels, bias, hop):
    b, t, ci = x.shape
    if kernels.dim() != 5 or bias.dim() != 3:
        raise ValueError(f"kernels: needs (B, F, Ci, Co, K), bias (B, F, Co); got "
                         f"{tuple(kernels.shape)}, {tuple(bias.shape)}")
    _, f, _, co, k = kernels.shape
    if t != f * hop or kernels.shape[:3] != (b, f, ci) or tuple(bias.shape) != (b, f, co):
        raise ValueError(f"shapes: x {tuple(x.shape)}, kernels {tuple(kernels.shape)}, bias "
                         f"{tuple(bias.shape)} do not fit hop={hop}")
    for name, a in (("x", x), ("kernels", kernels), ("bias", bias)):
        if a.dtype != torch.float32 or a.device != x.device:
            raise ValueError(f"{name}: needs float32 on {x.device}, got {a.dtype} on {a.device}")
    if x.stride(1) != 1 and x.stride(2) != 1:
        raise ValueError("x: needs unit stride along time or along channels")
    if kernels.stride()[2:] != (co * k, k, 1) or bias.stride(2) != 1 \
            or kernels.stride(0) % 4 or kernels.stride(1) % 4 or kernels.data_ptr() % 16:
        raise ValueError("kernels: each frame's (Ci, Co, K) block must be contiguous and "
                         "16-byte aligned, and bias's last dim contiguous")
    groups = co // 4
    if k % 2 == 0 or co % 4 or 256 % groups or hop > 16 * (256 // groups):
        raise ValueError(f"the LVC kernel takes odd K, Co a multiple of 4 dividing 1024 and "
                         f"hop <= 16384 / Co; got K={k}, Co={co}, hop={hop}")


def location_variable_convolution_lvc(x, kernels, bias, hop: int):
    """x (B, F*hop, Ci) float32, channels-last or the transposed view of a
    channels-first conv output; kernels (B, F, Ci, Co, K) float32, each
    frame's block contiguous (a slice ``kernels[:, l]`` of the predictor's
    output is taken as it is); bias (B, F, Co). Returns (B, F*hop, Co)
    contiguous."""
    if not x.is_cuda:
        return location_variable_convolution_lvc_plain(x, kernels, bias, hop)
    _check_cuda_args(x, kernels, bias, hop)
    b, t, ci = x.shape
    _, f, _, co, k = kernels.shape
    out = torch.empty((b, t, co), dtype=torch.float32, device=x.device)
    _KERNEL(x.get_device(), x.data_ptr(), kernels.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
            f, hop, ci, co, k, *x.stride(), kernels.stride(0), kernels.stride(1),
            bias.stride(0), bias.stride(1))
    location_variable_convolution_lvc.launches += 1
    return out


location_variable_convolution_lvc.launches = 0
