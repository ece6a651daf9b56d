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
The kernel is one persistent launch a step (up to ``MAX_ROWS`` batch rows; a
larger batch launches in parts): one block an SM walks the step's phases
between grid barriers. ``plan_step`` is its schedule, computed as the kernel
computes it: each product's tile steps cut into one contiguous share a block
(``product_pieces``), and the attention's prefix split so that its items
fill the grid (``attn_split``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tortoise_tpu_torch.models.gpt2 import quantize_kv_rows
from tortoise_tpu_torch.models.layers import QuantDense, quantize_rows
from tortoise_tpu_torch.ops import _build

HEAD_DIM = 64
_P = ctypes.c_void_p
_I = ctypes.c_int
_KERNEL = _build.Kernel("decode_step", "tt_decode_step", [_P] * 28 + [_I] * 11)
_GRID_KERNEL = _build.Kernel("decode_step", "tt_decode_step_blocks", [ctypes.POINTER(_I)])
# an H100's SMs: the plan's grid where no card is asked (the CPU tests); on a
# card the grid is its SMs times the blocks the occupancy API fits on one
SMS = 132
MAX_ROWS = 128       # batch rows one launch holds (csrc kMaxRows)
MAX_WIDTH = 1024     # C at most: a row pass gives each of 16 warps one 64-column tile
GEMM_TILE = 64       # output features of a product tile (csrc kTM)
GEMM_DEPTH = 64      # K depth of a tile step, one ring slot (csrc kBK)
ATTN_MIN_ROWS = 32   # prefix rows an attention split takes at least (a bf16 slot's rows)
ATTN_SPLIT_FLOATS = 68   # a split's (acc[64], m, l) in the workspace (csrc kSplitStride)
SYNC_HEADER = 64     # sync words before the tile counters (csrc kSyncHeader)
# a block's threads and shared memory (csrc kBlockThreads, kSmemBytes), and
# what an H100 SM has: 228 KB of shared memory, 1 KB of it kept a block, and
# 2048 threads
BLOCK_THREADS = 544
BLOCK_SMEM = 232448
SM_SMEM, SM_SMEM_RESERVED, SM_THREADS = 233472, 1024, 2048
# (N, K) of each product, in units of C
PRODUCTS = {"qkv": (3, 1), "proj": (1, 1), "fc": (4, 1), "fc2": (1, 4)}
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


def blocks_per_sm() -> int:
    """The blocks of the kernel one SM holds by shared memory and threads:
    the occupancy the plan's grid of ``SMS`` blocks a card assumes (on a card
    ``tt_decode_step_blocks`` asks the occupancy API)."""
    return min(SM_SMEM // (BLOCK_SMEM + SM_SMEM_RESERVED), SM_THREADS // BLOCK_THREADS)


def _share(g: int, blocks: int, units: int) -> int:
    """Block g's share of ``units`` starts here (csrc share_lo)."""
    return g * units // blocks


def product_pieces(n: int, k: int, blocks: int) -> list[list[tuple[int, int, int]]]:
    """Each block's pieces of an (n, k) product: its contiguous share of the
    n/64 x k/64 tile steps (tile-major), cut at tile ends into (tile, first K
    step, end K step). The steps go to the first min(blocks, steps) blocks,
    so every block of a tile's pieces holds some. A tile whose steps two
    blocks share is split in K, its pieces summed in block order."""
    steps = k // GEMM_DEPTH
    units = n // GEMM_TILE * steps
    used = min(blocks, units)
    out = []
    for g in range(blocks):
        u, hi, pieces = ((_share(g, used, units), _share(g + 1, used, units), [])
                         if g < used else (units, units, []))
        while u < hi:
            t = u // steps
            end = min(hi, (t + 1) * steps)
            pieces.append((t, u - t * steps, end - t * steps))
            u = end
        out.append(pieces)
    return out


@functools.lru_cache(maxsize=None)
def max_pieces(c: int, blocks: int) -> int:
    """The most tiles one block's share of any product touches: the
    workspace's pieces a block."""
    return max(len(p) for n, k in PRODUCTS.values()
               for p in product_pieces(n * c, k * c, blocks))


def attn_split(rows: int, heads: int, pos: int, blocks: int) -> tuple[int, int]:
    """(prefix rows of an attention split, splits): as many splits as keep
    rows x heads x splits items within the grid, ATTN_MIN_ROWS rows a split
    at least, whole multiples of them; (0, 1) at pos=0."""
    if pos == 0:
        return 0, 1
    want = max(1, min(blocks // (rows * heads), -(-pos // ATTN_MIN_ROWS)))
    per = -(-(-(-pos // want)) // ATTN_MIN_ROWS) * ATTN_MIN_ROWS
    return per, -(-pos // per)


def plan_step(b: int, c: int, pos: int, heads: int, blocks: int | None = None) -> dict:
    """The kernel's schedule for a step at batch b, width c, position pos on
    a grid of ``blocks`` (default: ``SMS`` x ``blocks_per_sm()``).

    "launches": one per ``MAX_ROWS`` batch rows, each (first row, rows,
    "attn_rows" prefix rows of an attention split, "attn_splits" their
    count); "max_pieces": the workspace's pieces a block of the products.
    Each product's pieces a block follow from ``product_pieces``; the
    attention's items, one a (batch row, head, split), go to the blocks in
    contiguous shares."""
    blocks = blocks or SMS * blocks_per_sm()
    launches = []
    for row0 in range(0, b, MAX_ROWS):
        rows = min(MAX_ROWS, b - row0)
        attn_rows, splits = attn_split(rows, heads, pos, blocks)
        launches.append({"row0": row0, "rows": rows, "attn_rows": attn_rows,
                         "attn_splits": splits})
    return {"blocks": blocks, "max_pieces": max_pieces(c, blocks), "launches": launches}


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
    if c > MAX_WIDTH:
        raise ValueError(f"decode kernel takes C <= {MAX_WIDTH}: C={c}")
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
    dev = x.get_device()
    blocks = _grid(dev)
    plan = plan_step(b, c, pos, heads, blocks)
    rows = plan["launches"][0]["rows"]
    splits = max(launch["attn_splits"] for launch in plan["launches"])
    f32 = dict(dtype=torch.float32, device=x.device)
    bf = dict(dtype=torch.bfloat16, device=x.device)
    hidden = x.clone()
    xn, attn, ffn = (torch.empty((b, n * c), **bf) for n in (1, 1, 4))
    k_rows = torch.empty((lcount, b, c), **bf)
    v_rows = torch.empty_like(k_rows)
    # a launch's workspace: the products' pieces, the attention's splits
    part = torch.empty((blocks, plan["max_pieces"], rows, GEMM_TILE), **f32)
    attn_part = (torch.empty((rows * heads * splits * ATTN_SPLIT_FLOATS,), **f32)
                 if splits > 1 else None)
    sync = _sync_words(dev, SYNC_HEADER + 4 * c // GEMM_TILE + rows * heads)
    trace = fused_decode_step.trace
    ptr = lambda d, n: d[n].data_ptr() if n in d else None
    args = (hidden.data_ptr(), xn.data_ptr(), attn.data_ptr(), ffn.data_ptr(),
            *(stacked[n].data_ptr() for n in _WEIGHTS), *(ptr(stacked, n) for n in _QSCALES),
            cache["k"].data_ptr(), cache["v"].data_ptr(), ptr(cache, "k_scale"),
            ptr(cache, "v_scale"), k_rows.data_ptr(), v_rows.data_ptr(), part.data_ptr(),
            attn_part.data_ptr() if attn_part is not None else None, sync.data_ptr(),
            trace.data_ptr() if trace is not None else None, lcount, b)
    for launch in plan["launches"]:
        _KERNEL(dev, *args, launch["row0"], launch["rows"], t, c, int(pos),
                launch["attn_rows"], launch["attn_splits"], plan["max_pieces"], blocks)
        fused_decode_step.device_launches += 1
    fused_decode_step.launches += 1
    fused_decode_step.launches_by_variant[variant(stacked, cache)] += 1
    return (hidden, k_rows, v_rows, attn) if with_attention else (hidden, k_rows, v_rows)


# the sync words of each device's steps (zero between calls) and its grid
_SYNC: dict[int, torch.Tensor] = {}
_GRID: dict[int, int] = {}


def _grid(device: int) -> int:
    """The kernel's grid on CUDA device ``device``: its SMs times the blocks
    the occupancy API fits on one (asked once)."""
    if device not in _GRID:
        n = _I(0)
        _GRID_KERNEL(device, ctypes.byref(n))
        _GRID[device] = n.value
    return _GRID[device]


def _sync_words(device: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed words for the kernel's barriers and counters,
    kept per device: the kernel leaves them zero."""
    buf = _SYNC.get(device)
    if buf is None or buf.numel() < n:
        buf = _SYNC[device] = torch.zeros(n, dtype=torch.int32, device=f"cuda:{device}")
    return buf


# steps (calls; the benchmark counts K2's steps here), steps by variant, and
# the kernels the steps put on the stream: one a step of up to MAX_ROWS rows
fused_decode_step.launches = 0
fused_decode_step.launches_by_variant = dict.fromkeys(VARIANTS.values(), 0)
fused_decode_step.device_launches = 0
# None, or an int64 CUDA tensor of (1 + 7 L, blocks, 4) that each launch
# fills with its blocks' ns stamps (csrc StepArgs.trace): utils/profiling.k2_phases reads it
fused_decode_step.trace = None
