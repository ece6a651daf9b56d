"""K2: one whole GPT-2 decode step, as a CUDA kernel (csrc/decode_step.cu)
and its plain PyTorch version.

Port of ``tortoise_tpu/ops/decode_step_pallas.py::fused_decode_step``. The
contract is the TPU kernel's: ``fused_decode_step(stacked, x, cache, pos,
heads) -> (hidden, k_rows, v_rows)`` with ``hidden`` the pre-ln_f residual
stream (B, C) and the new cache rows (L, B, C), all bf16. The cache
{"k", "v"} of (L, B, T, C) is read-only here; the caller writes the rows.

``fused_decode_step`` dispatches on the device of ``x``: a CPU tensor runs
``fused_decode_step_plain``, a CUDA tensor launches the kernel (or raises).
"""
from __future__ import annotations

import ctypes

import torch

from tortoise_tpu_torch.ops import _build

HEAD_DIM = 64
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {"tt_decode_step": [_P] * 18 + [_I] * 5 + [_P]}
_WEIGHTS = ("ln1", "wqkv", "bqkv", "wproj", "bproj", "ln2", "wfc", "bfc", "wfc2", "bfc2")


def prepare_stacked_params(gpt) -> dict[str, torch.Tensor]:
    """The kernel's weight stack from a ``models.gpt2.GPT2Stack``. Call once
    at load and pass the result to every step: bf16, contiguous, torch Linear
    layout (out, in), layer norms as (L, 2, C) = [scale; bias]."""
    blk = gpt.h_scan.block
    f = lambda t: t.detach().to(torch.bfloat16).contiguous()

    def ln(norm):
        return f(torch.stack([norm.weight, norm.bias], dim=1))

    return {
        "ln1": ln(blk.ln_1), "ln2": ln(blk.ln_2),
        "wqkv": f(blk.attn.c_attn.weight), "bqkv": f(blk.attn.c_attn.bias),
        "wproj": f(blk.attn.c_proj.weight), "bproj": f(blk.attn.c_proj.bias),
        "wfc": f(blk.mlp_fc.weight), "bfc": f(blk.mlp_fc.bias),
        "wfc2": f(blk.mlp_proj.weight), "bfc2": f(blk.mlp_proj.bias),
    }


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))


def _layer_norm(x: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
    """bf16 (B, C) -> bf16, f32 statistics, eps 1e-5; ln is (2, C) bf16."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5) * ln[0].float()
            + ln[1].float()).to(torch.bfloat16)


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 accumulate, round to bf16, then add the bf16 bias (rounds again)."""
    return (h.float() @ w.float().t()).to(torch.bfloat16) + b


def _attention(q, k_cur, v_cur, k_prev, v_prev, heads):
    """Softmax over the prefix rows plus the current row, f32. The prefix
    weights are rounded to bf16 before the weighted sum, the current row's
    weight stays f32 (the TPU kernel's order)."""
    b, c = q.shape
    t = k_prev.shape[1]
    dh = c // heads
    qf = q.float().reshape(b, heads, dh)
    cur = (qf * k_cur.float().reshape(b, heads, dh)).sum(-1) / dh ** 0.5   # (B, H)
    prev = torch.einsum("bhd,bthd->bht", qf,
                        k_prev.float().reshape(b, t, heads, dh)) / dh ** 0.5
    m = torch.maximum(cur, prev.amax(-1)) if t else cur
    p_prev = torch.exp(prev - m[..., None])
    p_cur = torch.exp(cur - m)
    l = p_prev.sum(-1) + p_cur
    num = torch.einsum("bht,bthd->bhd", p_prev.to(torch.bfloat16).float(),
                       v_prev.float().reshape(b, t, heads, dh))
    num = num + p_cur[..., None] * v_cur.float().reshape(b, heads, dh)
    return (num / l[..., None]).reshape(b, c).to(torch.bfloat16)


def fused_decode_step_plain(stacked: dict, x: torch.Tensor, cache: dict, pos: int,
                            heads: int, with_attention: bool = False):
    """Plain PyTorch K2 with the TPU kernel's rounding order.
    ``with_attention`` also returns the last layer's attention output (B, C)."""
    x = x.to(torch.bfloat16)
    s = stacked
    n_layers = s["wqkv"].shape[0]
    c = x.shape[-1]
    k_rows, v_rows = [], []
    for l in range(n_layers):
        h = _layer_norm(x, s["ln1"][l])
        qkv = _dense(h, s["wqkv"][l], s["bqkv"][l])
        q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]
        k_rows.append(k)
        v_rows.append(v)
        attn = _attention(q, k, v, cache["k"][l, :, :pos], cache["v"][l, :, :pos], heads)
        x = x + _dense(attn, s["wproj"][l], s["bproj"][l])
        h2 = _layer_norm(x, s["ln2"][l])
        f = _gelu_new(_dense(h2, s["wfc"][l], s["bfc"][l]).float()).to(torch.bfloat16)
        x = x + _dense(f, s["wfc2"][l], s["bfc2"][l])
    out = (x, torch.stack(k_rows), torch.stack(v_rows))
    return out + (attn,) if with_attention else out


def _check_cuda_args(stacked, x, cache, pos, heads):
    lcount, b, t, c = cache["k"].shape
    if c != heads * HEAD_DIM:
        raise ValueError(f"decode kernel needs head dim {HEAD_DIM}: C={c}, heads={heads}")
    if x.shape != (b, c):
        raise ValueError(f"x {tuple(x.shape)} does not match cache batch/width {(b, c)}")
    if not 0 <= pos < t:
        raise ValueError(f"pos {pos} outside the cache length {t}")
    expect = {"ln1": (lcount, 2, c), "ln2": (lcount, 2, c), "wqkv": (lcount, 3 * c, c),
              "bqkv": (lcount, 3 * c), "wproj": (lcount, c, c), "bproj": (lcount, c),
              "wfc": (lcount, 4 * c, c), "bfc": (lcount, 4 * c),
              "wfc2": (lcount, c, 4 * c), "bfc2": (lcount, c)}
    tensors = [(n, stacked[n]) for n in _WEIGHTS] + [("cache k", cache["k"]),
                                                     ("cache v", cache["v"])]
    for name, t_ in tensors:
        if t_.device != x.device or t_.dtype != torch.bfloat16 or not t_.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous bf16 tensor on {x.device}, got "
                             f"{t_.dtype} on {t_.device} (contiguous={t_.is_contiguous()})")
        if name in expect and tuple(t_.shape) != expect[name]:
            raise ValueError(f"{name}: shape {tuple(t_.shape)} != {expect[name]}")
    if cache["v"].shape != cache["k"].shape:
        raise ValueError("cache k and v shapes differ")


def fused_decode_step(stacked: dict, x: torch.Tensor, cache: dict, pos: int, heads: int,
                      with_attention: bool = False):
    """One decode step over all layers. x: (B, C) embedding (cast to bf16, the
    kernel's only compute dtype). Returns (hidden (B, C), k_rows (L, B, C),
    v_rows (L, B, C)), bf16. ``with_attention`` also returns the last layer's
    attention output (B, C), which the kernel leaves in its scratch: checks
    hold it against the plain version's. CPU tensors take the plain version."""
    if not x.is_cuda:
        return fused_decode_step_plain(stacked, x, cache, pos, heads, with_attention)
    x = x.to(torch.bfloat16)
    _check_cuda_args(stacked, x, cache, pos, heads)
    lcount, b, t, c = cache["k"].shape
    lib = _build.load("decode_step", _SIGNATURE)
    hidden = x.clone()
    qkv = torch.empty((b, 3 * c), dtype=torch.bfloat16, device=x.device)
    attn = torch.empty((b, c), dtype=torch.bfloat16, device=x.device)
    ffn = torch.empty((b, 4 * c), dtype=torch.bfloat16, device=x.device)
    k_rows = torch.empty((lcount, b, c), dtype=torch.bfloat16, device=x.device)
    v_rows = torch.empty_like(k_rows)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tt_decode_step(
        hidden.data_ptr(), qkv.data_ptr(), attn.data_ptr(), ffn.data_ptr(),
        *(stacked[n].data_ptr() for n in _WEIGHTS),
        cache["k"].data_ptr(), cache["v"].data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
        lcount, b, t, c, int(pos), stream)
    _build.check(err, "decode_step kernel")
    fused_decode_step.launches += 1
    return (hidden, k_rows, v_rows, attn) if with_attention else (hidden, k_rows, v_rows)


fused_decode_step.launches = 0
