"""The two attention kernels of ``tortoise_tpu/ops/attn_pallas.py``, each as a
CUDA kernel and its plain PyTorch version.

K3, ``flash_rel_attention`` (csrc/flash_rel_attn.cu): attention with a T5
relative-position bias and per-row key masking. The bias is Toeplitz (a
function of j - i only), so it travels as a pre-scaled diagonal vector
(H, 2T-1) with ``vec[h, j - i + T - 1]``, built once per sampling call by
``rel_bias_vector``, instead of the TPU kernel's (H, 2nq-1, 256, 256) tile
stack.

K1, ``decode_attention_merged`` (csrc/decode_attn_merged.cu): one layer's
decode self-attention over the merged (L, B, T, C) KV cache, writing the new
k/v rows at (layer, :, pos) in place; the per-layer decode of the GPT-2
stack when K2 is off.

Each dispatches on the device of its first argument: CPU tensors run the
plain version, CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tortoise_tpu_torch.ops import _build
from tortoise_tpu_torch.ops.attention import chunked_decode_attention_merged

HEAD_DIM = 64
NEG = -1e9
_P = ctypes.c_void_p
_I = ctypes.c_int
_K3 = _build.Kernel("flash_rel_attn", "tt_flash_rel_attn", [_P] * 6 + [_I] * 3)
_K1 = _build.Kernel("decode_attn_merged", "tt_decode_attn_merged",
                    [_P] * 3 + [_I] + [_P] * 3 + [_I] * 7)
_K1_DTYPES = (torch.bfloat16, torch.float32)
# the kernel's type switch: bit 0 an f32 q, bit 1 an f32 cache
_K1_KIND = {(qd, cd): int(qd is torch.float32) | int(cd is torch.float32) << 1
            for qd in _K1_DTYPES for cd in _K1_DTYPES}
# K1's plan (k1_plan): the H100's SMs; a cluster's blocks at most (the
# portable size); rows a split at least
_SMS = 132
K1_MAX_SPLITS = 8
_MIN_SPLIT_ROWS = 32


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
    out = torch.empty_like(q)
    _K3(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_vec.data_ptr(),
        valid_len.data_ptr(), out.data_ptr(), b, h, t)
    flash_rel_attention.launches += 1
    return out.to(out_dtype)


flash_rel_attention.launches = 0


def decode_attention_merged_plain(q, k_new, v_new, k_cache, v_cache, layer: int, pos: int, *,
                                  heads: int):
    """Writes k_new / v_new (B, C), cast to the cache's dtype, at (layer, :,
    pos) of the (L, B, T, C) caches in place, then attends q (B, C) to rows
    0..pos of that layer in float32 (``ops/attention.py``). Returns (B, C)
    in q's dtype: ``decode_attention_merged_xla`` of the JAX package."""
    k_cache[layer, :, pos] = k_new.to(k_cache.dtype)
    v_cache[layer, :, pos] = v_new.to(v_cache.dtype)
    return chunked_decode_attention_merged(q, k_cache, v_cache, layer, pos, heads=heads)


@functools.lru_cache(maxsize=8192)
def k1_plan(batch: int, heads: int, pos: int) -> tuple[int, int]:
    """K1's launch plan, (group, splits): a block takes ``group`` heads of
    one batch row (4 where the heads allow it, so each cache row is read as
    a run of 4 x 64 values) and one of ``splits`` parts of the pos prefix
    rows, a thread-block cluster of at most K1_MAX_SPLITS. As many splits
    as keep the blocks within one an SM (_SMS): on the H100 fewer, longer
    splits stream better than more, shorter ones. Each split keeps at least
    _MIN_SPLIT_ROWS rows, none is empty, and pos 0 has one."""
    group = 4 if heads % 4 == 0 else 2 if heads % 2 == 0 else 1
    splits = max(1, min(K1_MAX_SPLITS, _SMS // (batch * (heads // group)),
                        pos // _MIN_SPLIT_ROWS))
    if pos == 0:
        return group, 1
    chunk = -(-pos // splits)
    return group, -(-pos // chunk)


def _k1_arg_error(q, k_new, v_new, k_cache, v_cache, heads) -> ValueError:
    """The message of the first argument ``_check_k1_args`` refuses."""
    b, c = q.shape
    if c != heads * HEAD_DIM:
        return ValueError(f"decode_attention_merged kernel needs a head dim of {HEAD_DIM}: "
                          f"C={c}, heads={heads}")
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if x.shape != q.shape or x.dtype not in _K1_DTYPES or x.dtype != q.dtype \
                or x.stride() != q.stride() or x.stride(1) != 1 or x.device != q.device:
            return ValueError(f"{name}: needs a bf16 or f32 {tuple(q.shape)} tensor with unit "
                              f"column stride and q's dtype, strides and device, got {x.dtype} "
                              f"{tuple(x.shape)} {x.stride()} on {x.device}")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dim() != 4 or x.shape[1] != b or x.shape[3] != c or x.shape != k_cache.shape \
                or x.dtype not in _K1_DTYPES or x.dtype != k_cache.dtype \
                or not x.is_contiguous() or x.device != q.device or x.data_ptr() % 16:
            return ValueError(f"{name}: needs a contiguous, 16-byte aligned bf16 or f32 (L, {b}, "
                              f"T, {c}) cache on {q.device} (the int8 cache's scales are not "
                              f"K1's), got {x.dtype} {tuple(x.shape)} on {x.device}")
    return ValueError("decode_attention_merged: bad arguments")


def _check_k1_args(q, k_new, v_new, k_cache, v_cache, layer, pos, heads):
    """Raises ValueError unless the kernel takes these arguments: one
    expression on the path that passes, the message built only on failure."""
    shape, dtype, stride, dev = q.shape, q.dtype, q.stride(), q.get_device()
    cshape, cdtype = k_cache.shape, k_cache.dtype
    if not (len(shape) == 2 and shape[1] == heads * HEAD_DIM and stride[1] == 1
            and dtype in _K1_DTYPES and k_new.dtype is dtype and v_new.dtype is dtype
            and k_new.shape == shape and v_new.shape == shape
            and k_new.stride() == stride and v_new.stride() == stride
            and k_new.get_device() == dev and v_new.get_device() == dev
            and len(cshape) == 4 and cshape[1] == shape[0] and cshape[3] == shape[1]
            and v_cache.shape == cshape and cdtype in _K1_DTYPES and v_cache.dtype is cdtype
            and k_cache.is_contiguous() and v_cache.is_contiguous()
            and k_cache.get_device() == dev and v_cache.get_device() == dev
            and not (k_cache.data_ptr() | v_cache.data_ptr()) & 15):
        raise _k1_arg_error(q, k_new, v_new, k_cache, v_cache, heads)
    if not 0 <= layer < cshape[0] or not 0 <= pos < cshape[2]:
        raise ValueError(f"layer={layer}, pos={pos} outside the cache {tuple(cshape)}")


def decode_attention_merged(q, k_new, v_new, k_cache, v_cache, layer: int, pos: int, *,
                            heads: int):
    """q, k_new, v_new (B, C), rows may be views into one qkv product;
    k_cache / v_cache (L, B, T, C) bf16 or f32. Writes the new k/v rows at
    (layer, :, pos) IN PLACE and returns the attention output (B, C) in q's
    dtype."""
    if not q.is_cuda:
        return decode_attention_merged_plain(q, k_new, v_new, k_cache, v_cache, layer, pos,
                                             heads=heads)
    _check_k1_args(q, k_new, v_new, k_cache, v_cache, layer, pos, heads)
    b, c = q.shape
    t = k_cache.shape[2]
    group, splits = k1_plan(b, heads, pos)
    out = q.new_empty((b, c))
    layer_bytes = layer * b * t * c * k_cache.element_size()
    _K1(q.get_device(), q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), q.stride(0),
        k_cache.data_ptr() + layer_bytes, v_cache.data_ptr() + layer_bytes, out.data_ptr(),
        _K1_KIND[q.dtype, k_cache.dtype], b, t, c, group, pos, splits)
    decode_attention_merged.launches += 1
    return out


decode_attention_merged.launches = 0
