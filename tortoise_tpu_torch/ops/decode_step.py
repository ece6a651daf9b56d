"""K2: one whole GPT-2 decode step, as a CUDA kernel (csrc/decode_step.cu)
and its plain PyTorch version.

Port of ``tortoise_tpu/ops/decode_step_pallas.py::fused_decode_step``. The
contract is the TPU kernel's: ``fused_decode_step(stacked, x, cache, pos,
heads) -> (hidden, k_rows, v_rows)`` with ``hidden`` the pre-ln_f residual
stream (B, C) and the new cache rows (L, B, C), all bf16. The cache
{"k", "v"} of (L, B, T, C) is read-only here; the caller writes the rows.

Both of the TPU kernel's static branches are ported, so there are four
variants (``VARIANTS``): bf16 or int8 weights (the stack of
``prepare_stacked_params`` holds int8 weights with f32 qscale rows and f32
biases) times a bf16 or int8 cache (int8 ``k``/``v`` plus f32 ``k_scale``/
``v_scale`` of (L, B, H, T)). With the int8 cache the step attends to its
own row unquantized, as the TPU kernel does; the plain layer stack reads
back the quantized row, so the two differ by at most that row's
quantization error.

``fused_decode_step`` dispatches on the device of ``x``: a CPU tensor runs
``fused_decode_step_plain``, a CUDA tensor launches the kernel (or raises).
"""
from __future__ import annotations

import ctypes

import torch

from tortoise_tpu_torch.models.gpt2 import quantize_kv_rows
from tortoise_tpu_torch.models.layers import QuantDense, quantize_rows
from tortoise_tpu_torch.ops import _build

HEAD_DIM = 64
_P = ctypes.c_void_p
_I = ctypes.c_int
_KERNEL = _build.Kernel("decode_step", "tt_decode_step", [_P] * 24 + [_I] * 5)
_WEIGHTS = ("ln1", "wqkv", "bqkv", "wproj", "bproj", "ln2", "wfc", "bfc", "wfc2", "bfc2")
_QSCALES = ("sqkv", "sproj", "sfc", "sfc2")
# (weights, cache) -> variant name; each variant counts its own launches
VARIANTS = {(torch.bfloat16, torch.bfloat16): "bf16",
            (torch.int8, torch.bfloat16): "int8_weights",
            (torch.bfloat16, torch.int8): "int8_cache",
            (torch.int8, torch.int8): "int8_weights_int8_cache"}
# stack key -> the dense layer of the GPT-2 block it comes from
_DENSES = {"qkv": "attn.c_attn", "proj": "attn.c_proj", "fc": "mlp_fc", "fc2": "mlp_proj"}


def _dense_module(blk, path: str):
    for p in path.split("."):
        blk = getattr(blk, p)
    return blk


def prepare_stacked_params(gpt, quantized: dict | None = None) -> dict[str, torch.Tensor]:
    """The kernel's weight stack from a ``models.gpt2.GPT2Stack``. Call once
    at load and pass the result to every step: contiguous, torch Linear
    layout (out, in), layer norms as (L, 2, C) bf16 = [scale; bias].

    bf16 layers give bf16 weights and biases. QuantDense layers
    (``quant_weights``), or ``quantized`` = {stack key: (int8 weight, qscale)}
    for a bf16 model (``gpt_weights="int8_decode"``, quantized from the f32
    weights before the cast, ``quantize_gpt_denses``), give the int8 stack:
    int8 weights, f32 qscale rows "sqkv"/"sproj"/"sfc"/"sfc2" (L, N) and f32
    biases, as the TPU kernel's stack."""
    blk = gpt.h_scan.block
    bf = lambda t: t.detach().to(torch.bfloat16).contiguous()

    def ln(norm):
        return bf(torch.stack([norm.weight, norm.bias], dim=1))

    out = {"ln1": ln(blk.ln_1), "ln2": ln(blk.ln_2)}
    for key, path in _DENSES.items():
        d = _dense_module(blk, path)
        if isinstance(d, QuantDense):
            w, s = d.weight, d.qscale
        elif quantized is not None:
            w, s = quantized[key]
        else:
            out["w" + key], out["b" + key] = bf(d.weight), bf(d.bias)
            continue
        out["w" + key] = w.detach().contiguous()
        out["s" + key] = s.detach().float().contiguous()
        out["b" + key] = d.bias.detach().float().contiguous()
    return out


def quantize_gpt_denses(gpt) -> dict:
    """{stack key: (int8 weight, f32 qscale)} of a float GPT2Stack's dense
    layers, for ``prepare_stacked_params(gpt, quantized=...)``. Call before
    ``cast_for_inference``, so the scales come from the f32 weights as the
    JAX package's ``int8_decode`` computes them."""
    blk = gpt.h_scan.block
    return {key: quantize_rows(_dense_module(blk, path).weight.detach())
            for key, path in _DENSES.items()}


def quantize_stack(stacked: dict) -> dict:
    """The int8-weight stack of a bf16 one: weights quantized per output
    channel, f32 qscales and biases (kernel checks and profiles)."""
    out = dict(stacked)
    for key in _DENSES:
        out["w" + key], out["s" + key] = quantize_rows(stacked["w" + key])
        out["b" + key] = stacked["b" + key].float()
    return out


def quantize_cache(cache: dict, heads: int) -> dict:
    """An int8 cache holding a float cache's rows, quantized as the sampler
    writes them (kernel checks and profiles)."""
    out = {}
    for name in ("k", "v"):
        q, s = quantize_kv_rows(cache[name], heads)          # s: (L, B, T, H)
        out[name], out[f"{name}_scale"] = q, s.transpose(2, 3).contiguous()
    return out


def variant(stacked: dict, cache: dict) -> str:
    """The kernel variant a (stack, cache) pair runs: a key of ``launches_by_variant``."""
    return VARIANTS[(stacked["wqkv"].dtype, cache["k"].dtype)]


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))


def _layer_norm(x: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
    """bf16 (B, C) -> bf16, f32 statistics, eps 1e-5; ln is (2, C) bf16."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5) * ln[0].float()
            + ln[1].float()).to(torch.bfloat16)


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: torch.Tensor | None):
    """bf16 weights: f32 accumulate, round to bf16, then add the bf16 bias
    (rounds again). int8 weights: acc * qscale + f32 bias in f32, one rounding."""
    acc = h.float() @ w.float().t()
    if s is None:
        return acc.to(torch.bfloat16) + b
    return (acc * s + b).to(torch.bfloat16)


def _attention(q, k_cur, v_cur, k_prev, v_prev, heads, k_scale=None, v_scale=None):
    """Softmax over the prefix rows plus the current row, f32. The prefix
    weights (times the v scales with an int8 cache) are rounded to bf16
    before the weighted sum, the current row's weight stays f32 (the TPU
    kernel's order). k_scale/v_scale: (B, H, T) for int8 prefix rows; the
    sum of the weights runs over the unscaled ones."""
    b, c = q.shape
    t = k_prev.shape[1]
    dh = c // heads
    qf = q.float().reshape(b, heads, dh)
    cur = (qf * k_cur.float().reshape(b, heads, dh)).sum(-1) / dh ** 0.5   # (B, H)
    prev = torch.einsum("bhd,bthd->bht", qf,
                        k_prev.float().reshape(b, t, heads, dh)) / dh ** 0.5
    if k_scale is not None:
        prev = prev * k_scale
    m = torch.maximum(cur, prev.amax(-1)) if t else cur
    p_prev = torch.exp(prev - m[..., None])
    p_cur = torch.exp(cur - m)
    l = p_prev.sum(-1) + p_cur
    if v_scale is not None:
        p_prev = p_prev * v_scale
    num = torch.einsum("bht,bthd->bhd", p_prev.to(torch.bfloat16).float(),
                       v_prev.float().reshape(b, t, heads, dh))
    num = num + p_cur[..., None] * v_cur.float().reshape(b, heads, dh)
    return (num / l[..., None]).reshape(b, c).to(torch.bfloat16)


def fused_decode_step_plain(stacked: dict, x: torch.Tensor, cache: dict, pos: int,
                            heads: int, with_attention: bool = False):
    """Plain PyTorch K2 with the TPU kernel's rounding order, every variant.
    ``with_attention`` also returns the last layer's attention output (B, C)."""
    x = x.to(torch.bfloat16)
    s = stacked
    n_layers = s["wqkv"].shape[0]
    c = x.shape[-1]
    quant_c = "k_scale" in cache
    scale = lambda name, l: s[name][l] if name in s else None
    k_rows, v_rows = [], []
    for l in range(n_layers):
        h = _layer_norm(x, s["ln1"][l])
        qkv = _dense(h, s["wqkv"][l], s["bqkv"][l], scale("sqkv", l))
        q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]
        k_rows.append(k)
        v_rows.append(v)
        scales = ((cache["k_scale"][l, :, :, :pos], cache["v_scale"][l, :, :, :pos])
                  if quant_c else (None, None))
        attn = _attention(q, k, v, cache["k"][l, :, :pos], cache["v"][l, :, :pos], heads,
                          *scales)
        x = x + _dense(attn, s["wproj"][l], s["bproj"][l], scale("sproj", l))
        h2 = _layer_norm(x, s["ln2"][l])
        f = _gelu_new(_dense(h2, s["wfc"][l], s["bfc"][l], scale("sfc", l)).float())
        x = x + _dense(f.to(torch.bfloat16), s["wfc2"][l], s["bfc2"][l], scale("sfc2", l))
    out = (x, torch.stack(k_rows), torch.stack(v_rows))
    return out + (attn,) if with_attention else out


def _check_cuda_args(stacked, x, cache, pos, heads):
    """Every tensor the kernel reads, against the dtype and shape it takes:
    raises on the first mismatch."""
    lcount, b, t, c = cache["k"].shape
    if c != heads * HEAD_DIM:
        raise ValueError(f"decode kernel needs head dim {HEAD_DIM}: C={c}, heads={heads}")
    if x.shape != (b, c):
        raise ValueError(f"x {tuple(x.shape)} does not match cache batch/width {(b, c)}")
    if not 0 <= pos < t:
        raise ValueError(f"pos {pos} outside the cache length {t}")
    if (stacked["wqkv"].dtype, cache["k"].dtype) not in VARIANTS:
        raise ValueError(f"no kernel variant for wqkv of {stacked['wqkv'].dtype} and a cache "
                         f"k of {cache['k'].dtype}: weights bf16 or int8, cache bf16 or int8")
    quant_w = stacked["wqkv"].dtype == torch.int8
    quant_c = cache["k"].dtype == torch.int8
    wdt = torch.int8 if quant_w else torch.bfloat16
    bdt = torch.float32 if quant_w else torch.bfloat16
    cdt = cache["k"].dtype
    bf = torch.bfloat16
    expect = {"ln1": ((lcount, 2, c), bf), "ln2": ((lcount, 2, c), bf),
              "wqkv": ((lcount, 3 * c, c), wdt), "bqkv": ((lcount, 3 * c), bdt),
              "wproj": ((lcount, c, c), wdt), "bproj": ((lcount, c), bdt),
              "wfc": ((lcount, 4 * c, c), wdt), "bfc": ((lcount, 4 * c), bdt),
              "wfc2": ((lcount, c, 4 * c), wdt), "bfc2": ((lcount, c), bdt)}
    if quant_w:
        expect.update(sqkv=((lcount, 3 * c), torch.float32), sproj=((lcount, c), torch.float32),
                      sfc=((lcount, 4 * c), torch.float32), sfc2=((lcount, c), torch.float32))
    tensors = {n: stacked.get(n) for n in expect}
    tensors.update({"cache k": cache["k"], "cache v": cache["v"]})
    expect.update({"cache k": ((lcount, b, t, c), cdt), "cache v": ((lcount, b, t, c), cdt)})
    if quant_c:
        for n in ("k_scale", "v_scale"):
            tensors[n] = cache.get(n)
            expect[n] = ((lcount, b, heads, t), torch.float32)
    for name, (shape, dtype) in expect.items():
        t_ = tensors[name]
        if t_ is None:
            raise ValueError(f"{name}: missing")
        if t_.device != x.device or t_.dtype != dtype or not t_.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous {dtype} tensor on {x.device}, got "
                             f"{t_.dtype} on {t_.device} (contiguous={t_.is_contiguous()})")
        if tuple(t_.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t_.shape)} != {shape}")


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
    hidden = x.clone()
    qkv = torch.empty((b, 3 * c), dtype=torch.bfloat16, device=x.device)
    attn = torch.empty((b, c), dtype=torch.bfloat16, device=x.device)
    ffn = torch.empty((b, 4 * c), dtype=torch.bfloat16, device=x.device)
    k_rows = torch.empty((lcount, b, c), dtype=torch.bfloat16, device=x.device)
    v_rows = torch.empty_like(k_rows)
    ptr = lambda d, n: d[n].data_ptr() if n in d else None
    _KERNEL(
        x.get_device(), hidden.data_ptr(), qkv.data_ptr(), attn.data_ptr(), ffn.data_ptr(),
        *(stacked[n].data_ptr() for n in _WEIGHTS), *(ptr(stacked, n) for n in _QSCALES),
        cache["k"].data_ptr(), cache["v"].data_ptr(), ptr(cache, "k_scale"),
        ptr(cache, "v_scale"), k_rows.data_ptr(), v_rows.data_ptr(),
        lcount, b, t, c, int(pos))
    fused_decode_step.launches += 1
    fused_decode_step.launches_by_variant[variant(stacked, cache)] += 1
    return (hidden, k_rows, v_rows, attn) if with_attention else (hidden, k_rows, v_rows)


fused_decode_step.launches = 0
fused_decode_step.launches_by_variant = dict.fromkeys(VARIANTS.values(), 0)
