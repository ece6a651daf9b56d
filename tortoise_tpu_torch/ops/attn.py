"""K3: attention with a T5 relative-position bias and per-row key masking,
as a CUDA kernel (csrc/flash_rel_attn.cu) and its plain PyTorch version.

Port of ``tortoise_tpu/ops/attn_pallas.py::flash_rel_attention``. The bias
is Toeplitz (a function of j - i only), so it travels as a pre-scaled
diagonal vector (H, 2T-1) with ``vec[h, j - i + T - 1]``, built once per
sampling call by ``rel_bias_vector``, instead of the TPU kernel's
(H, 2nq-1, 256, 256) tile stack.

``flash_rel_attention`` dispatches on the device of ``q``: CPU tensors run
``flash_rel_attention_plain``, CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tortoise_tpu_torch.ops import _build

HEAD_DIM = 64
NEG = -1e9
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {"tt_flash_rel_attn": [_P] * 6 + [_I] * 3 + [_P]}


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                             max_distance: int, causal: bool) -> np.ndarray:
    """T5 log-bucketed relative positions, float32 math (a copy of
    ``tortoise_tpu.models.blocks._np_relative_position_bucket``)."""
    ret = np.zeros_like(relative_position)
    n = -relative_position
    if not causal:
        num_buckets //= 2
        ret = ret + (n < 0).astype(np.int32) * num_buckets
        n = np.abs(n)
    else:
        n = np.maximum(n, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    with np.errstate(divide="ignore"):
        val_if_large = max_exact + (
            np.log(n.astype(np.float32) / max_exact + np.float32(1e-20))
            / np.float32(np.log(max_distance / max_exact))
            * (num_buckets - max_exact)
        ).astype(np.int32)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return (ret + np.where(is_small, n, val_if_large)).astype(np.int32)


def rel_bias_vector(table: torch.Tensor, t: int, scale: float, num_buckets: int = 32,
                    max_distance: int = 64) -> torch.Tensor:
    """table (..., num_buckets, H) -> (..., H, 2T-1) float32 with entry
    ``d + T - 1`` = scale * table[bucket(d)] for the offset d = j - i."""
    buckets = relative_position_bucket(np.arange(-(t - 1), t), num_buckets, max_distance,
                                       False)
    idx = torch.as_tensor(buckets, dtype=torch.long, device=table.device)
    picked = table.float().index_select(-2, idx)            # (..., 2T-1, H)
    return picked.transpose(-1, -2) * scale


def expand_rel_bias(vec: torch.Tensor, t: int) -> torch.Tensor:
    """(..., 2T-1) diagonal vector -> (..., T, T) dense bias, [i, j] = vec[j - i + T - 1]."""
    ar = torch.arange(t, device=vec.device)
    idx = ar[None, :] - ar[:, None] + (t - 1)
    return vec[..., idx]


def flash_rel_attention_plain(q, k, v, bias_vec, valid_len):
    """softmax(q k^T / sqrt(D) + bias) v with keys >= valid_len[b] masked.
    q, k, v (B, H, T, D); bias_vec (H, 2T-1); valid_len (B,) int. The softmax
    weights are rounded to v's dtype before the weighted sum, as in the TPU
    kernel. Rows past valid_len carry no meaning."""
    b, h, t, d = q.shape
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / np.sqrt(d)
    s = s + expand_rel_bias(bias_vec.float(), t)[None]
    keys = torch.arange(t, device=q.device)
    valid = keys[None, :] < valid_len.to(q.device).reshape(-1, 1)            # (B, T)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", w.float(), v.float()).to(q.dtype)


def _check_cuda_args(q, k, v, bias_vec, valid_len):
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_rel_attention kernel needs D={HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != torch.bfloat16 or not x.is_contiguous() \
                or x.device != q.device:
            raise ValueError(f"{name}: needs a contiguous bf16 {tuple(q.shape)} tensor on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if bias_vec.shape != (h, 2 * t - 1) or bias_vec.dtype != torch.float32 \
            or not bias_vec.is_contiguous() or bias_vec.device != q.device:
        raise ValueError(f"bias: needs contiguous float32 {(h, 2 * t - 1)} on {q.device}, "
                         f"got {bias_vec.dtype} {tuple(bias_vec.shape)} on {bias_vec.device}")
    if valid_len.shape != (b,) or valid_len.dtype != torch.int32 \
            or valid_len.device != q.device:
        raise ValueError(f"valid_len: needs int32 ({b},) on {q.device}")


def flash_rel_attention(q, k, v, bias_vec, valid_len):
    """q, k, v (B, H, T, 64); bias_vec (H, 2T-1) float32; valid_len (B,)
    int32. Returns (B, H, T, 64) in q's dtype. On CUDA q, k and v are cast
    to bf16, the kernel's only compute dtype."""
    if not q.is_cuda:
        return flash_rel_attention_plain(q, k, v, bias_vec, valid_len)
    out_dtype = q.dtype
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    _check_cuda_args(q, k, v, bias_vec, valid_len)
    b, h, t, _ = q.shape
    lib = _build.load("flash_rel_attn", _SIGNATURE)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.tt_flash_rel_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_vec.data_ptr(),
                                valid_len.data_ptr(), out.data_ptr(), b, h, t, stream)
    _build.check(err, "flash_rel_attn kernel")
    flash_rel_attention.launches += 1
    return out.to(out_dtype)


flash_rel_attention.launches = 0
