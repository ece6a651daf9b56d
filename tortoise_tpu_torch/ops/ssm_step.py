"""The Mamba-2 decode step of one layer: kernel ``ssm_decode_step``
(csrc/ssm_step.cu) and its plain PyTorch version.

For every batch row and head of a layer (``models/granite_hybrid.py``), one
new token: the causal depthwise conv's window moves by the token's x, B and
C inputs and the conv (with its bias) and SiLU give x, B and C; dt =
softplus(dt + dt_bias), dA = exp(dt A) with A = -exp(A_log); the state
becomes h <- dA h + dt x B^T, in float32, stored in place in its own dtype;
and y = h C + D x (from the float32 state), in float32. One group: B and C
are shared by all heads. The JAX package has no such model, so this kernel
replaces none of its kernels; it is the decode step's largest traffic.

Arguments: ``xbc`` (B, conv_dim) and ``dt`` (B, H), rows with unit column
stride (views into the in-projection's output); ``conv_state`` (B,
conv_dim, K - 1), the last K - 1 inputs, oldest first; ``conv_w`` (conv_dim,
1, K), ``conv_b`` (conv_dim,); ``dt_bias``, ``a_log``, ``d`` (H,) float32;
``state`` (B, H, P, N); ``counters`` (B,) int32 zeros, the kernel's per-row
arrival counts, which it leaves at zero. ``conv_state`` and ``state`` are
updated in place; returns y (B, H P) float32.

The wrapper dispatches on the device of ``xbc``: CPU tensors run the plain
version, CUDA tensors launch the kernel (bf16 inputs, state and conv state;
P = 64, N = 128, K = 4) or raise.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops import _build

HEAD_DIM = 64
D_STATE = 128
D_CONV = 4
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_KERNEL = _build.Kernel("ssm_step", "tt_ssm_decode_step",
                        [_P, _L, _P, _L] + [_P] * 9 + [_I, _I])


def ssm_decode_step_plain(xbc, dt, conv_state, conv_w, conv_b, dt_bias, a_log, d, state,
                          counters=None):
    """The kernel's arithmetic op by op (``counters`` is unused)."""
    b, conv_dim = xbc.shape
    heads, p, n = state.shape[1:]
    k = conv_w.shape[-1]
    window = torch.cat([conv_state.float(), xbc.float()[:, :, None]], -1)   # (B, CD, K)
    conv = (window * conv_w.float().reshape(conv_dim, k)).sum(-1) + conv_b.float()
    conv_state.copy_(window[:, :, 1:])
    x, bm, cm = F.silu(conv).split([heads * p, n, n], -1)
    x = x.reshape(b, heads, p)
    dtv = F.softplus(dt.float() + dt_bias.float())                           # (B, H)
    da = torch.exp(dtv * -torch.exp(a_log.float()))
    h = state.float() * da[:, :, None, None] \
        + (dtv[:, :, None] * x)[..., None] * bm[:, None, None, :]
    state.copy_(h)
    y = (h * cm[:, None, None, :]).sum(-1) + d.float()[None, :, None] * x
    return y.reshape(b, heads * p)


def _check(xbc, dt, conv_state, conv_w, conv_b, dt_bias, a_log, d, state, counters):
    b, conv_dim = xbc.shape
    heads = state.shape[1]
    dev = xbc.device
    want = {"xbc": (xbc, (b, heads * HEAD_DIM + 2 * D_STATE), torch.bfloat16),
            "dt": (dt, (b, heads), torch.bfloat16),
            "conv_state": (conv_state, (b, conv_dim, D_CONV - 1), torch.bfloat16),
            "conv_w": (conv_w, (conv_dim, 1, D_CONV), torch.bfloat16),
            "conv_b": (conv_b, (conv_dim,), torch.bfloat16),
            "dt_bias": (dt_bias, (heads,), torch.float32),
            "a_log": (a_log, (heads,), torch.float32),
            "d": (d, (heads,), torch.float32),
            "state": (state, (b, heads, HEAD_DIM, D_STATE), torch.bfloat16),
            "counters": (counters, (b,), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        rows = name in ("xbc", "dt")
        laid_out = t.stride(-1) == 1 if rows else t.is_contiguous()
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev or not laid_out:
            raise ValueError(
                f"ssm_decode_step: {name} needs a {dtype} {shape} tensor on {dev}"
                f"{' with unit column stride' if rows else ', contiguous'}, got {t.dtype} "
                f"{tuple(t.shape)} strides {t.stride()} on {t.device}")


def ssm_decode_step(xbc, dt, conv_state, conv_w, conv_b, dt_bias, a_log, d, state, counters):
    """See the module's text. Returns y (B, H P) float32."""
    if not xbc.is_cuda:
        return ssm_decode_step_plain(xbc, dt, conv_state, conv_w, conv_b, dt_bias, a_log, d,
                                     state)
    _check(xbc, dt, conv_state, conv_w, conv_b, dt_bias, a_log, d, state, counters)
    b, heads = dt.shape
    y = torch.empty((b, heads * HEAD_DIM), dtype=torch.float32, device=xbc.device)
    _KERNEL(xbc.get_device(), xbc.data_ptr(), xbc.stride(0), dt.data_ptr(), dt.stride(0),
            conv_state.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
            a_log.data_ptr(), d.data_ptr(), state.data_ptr(), y.data_ptr(),
            counters.data_ptr(), b, heads)
    ssm_decode_step.launches += 1
    return y


ssm_decode_step.launches = 0
