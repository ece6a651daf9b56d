"""GPT-2 decoder stack with a preallocated KV cache.

Port of ``tortoise_tpu/models/gpt2.py``: pre-LN blocks (LayerNorm eps 1e-5
in float32), fused qkv, float32 softmax, gelu_new MLP and a final ``ln_f``.
Layer weights are stacked along a leading layer axis under ``h_scan.block``,
as the JAX package stacks them under ``nn.scan``; the decode kernel K2 reads
the same stack.

The cache is {"k", "v"} of (L, B, T_max, C), the JAX package's B-major
merged-channel layout; the int8 cache adds f32 "k_scale"/"v_scale" of
(L, B, H, T_max), one symmetric scale per (batch, head, position), T-minor as
the decode kernel reads them. Unlike the JAX functional cache, ``forward``
writes the new rows into the given cache tensors IN PLACE. A one-row decode
step over a bf16 or f32 cache attends through K1
(``ops/attn.py::decode_attention_merged``), which also writes the row; the
int8 cache keeps the plain chunked attention, as in the JAX package.

On a tp split (``parallel.sharding.shard_unified_voice``) the stack holds
this rank's H/tp heads: c_attn and mlp_fc give its C/tp and 4C/tp output
channels, c_proj and mlp_proj its float32 partial sums, which are
all-reduced before their bias is added once; the cache holds the rank's
C/tp channels.

``dtype`` is the compute dtype (None: the stored c_attn bias's, as the
serving models cast theirs), the residual stream's: the input is cast to
it once, ln_1, ln_2 and ln_f run in float32 and round to it, the
attention's logits and softmax are float32. ``remat`` recomputes each
block in the backward pass when there is no cache (the JAX package's
``nn.remat``, the reference's gradient checkpointing).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tortoise_tpu_torch.models.layers import Dense, LayerNorm, Norm, QuantDense, cast
from tortoise_tpu_torch.ops.attention import chunked_decode_attention_merged
from tortoise_tpu_torch.ops.attn import decode_attention_merged
from tortoise_tpu_torch.parallel.sharding import copy_to_tp, reduce_from_tp

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    n_layer: int = 30
    n_embd: int = 1024
    n_head: int = 16
    ln_eps: float = 1e-5
    # weight-only int8 block denses (QuantDense); see weights.resolve_gpt_quant
    quant_weights: bool = False


def gelu_new(x):
    """HF "gelu_new": the tanh approximation GPT-2 uses, rounded as the JAX
    package's: x^3 as two products and the Python constant in x's dtype,
    then the numpy constant promotes the tanh's argument, and so the result,
    to float32 (a type rule of JAX's, so the serving models follow it too)."""
    cubic = torch.tensor(0.044715, dtype=x.dtype) * (x * (x * x))
    return 0.5 * x * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (x + cubic).float()))


def _dense(cfg: GPT2Config, in_f: int, out_f: int, lead: tuple, dtype):
    return QuantDense(in_f, out_f, lead) if cfg.quant_weights else \
        Dense(in_f, out_f, lead=lead, dtype=dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, lead: tuple, dtype):
        super().__init__()
        c = cfg.n_embd
        self.c_attn = _dense(cfg, c, 3 * c, lead, dtype)
        self.c_proj = _dense(cfg, c, c, lead, dtype)


class _Block(nn.Module):
    """All layers' parameters, stacked: (L, ...)."""

    def __init__(self, cfg: GPT2Config, dtype):
        super().__init__()
        lead = (cfg.n_layer,)
        c = cfg.n_embd
        self.ln_1 = Norm(c, lead)
        self.attn = _Attention(cfg, lead, dtype)
        self.ln_2 = Norm(c, lead)
        self.mlp_fc = _dense(cfg, c, 4 * c, lead, dtype)
        self.mlp_proj = _dense(cfg, 4 * c, c, lead, dtype)


def init_kv_cache(config: GPT2Config, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None, sharding=None) -> dict[str, torch.Tensor]:
    """Zeroed (L, B, T_max, C) k and v buffers; ``dtype=torch.int8`` adds the
    zeroed f32 scale slabs (L, B, H, T_max). With ``sharding``
    (``parallel.sharding.KVCacheSharding``) each buffer is this rank's part
    of those global shapes."""
    shape = (config.n_layer, batch, max_len, config.n_embd)
    sshape = (config.n_layer, batch, config.n_head, max_len)
    if sharding is not None:
        shape, sshape = sharding.local_shape("k", shape), sharding.local_shape("k_scale", sshape)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return cache


def quantize_kv_rows(x: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows (..., C) -> (int8 (..., C), f32 scales (..., H)): symmetric per
    head, s = max(max|x| / 127, 1e-8), q = round(x / s), as the JAX
    package's int8 cache writes (``models/gpt2.py`` and ``ar_sampler._gpt_step``)."""
    *lead, c = x.shape
    r = x.float().reshape(*lead, heads, c // heads)
    s = torch.clamp_min(r.abs().amax(-1) / 127.0, 1e-8)
    return torch.round(r / s[..., None]).to(torch.int8).reshape(*lead, c), s


class GPT2Stack(nn.Module):
    # parallel.sharding.TensorParallel while the stack holds one rank's heads
    tp = None

    def __init__(self, cfg: GPT2Config, dtype: torch.dtype | None = None, remat: bool = False):
        super().__init__()
        self.config = cfg
        self.dtype, self.remat = dtype, remat
        self.h_scan = nn.Module()
        self.h_scan.block = _Block(cfg, dtype)
        self.ln_f = LayerNorm(cfg.n_embd, eps=cfg.ln_eps)

    def _ln(self, norm: Norm, x, l):
        w, b = norm.params(l)
        return F.layer_norm(x.float(), (x.shape[-1],), w, b, self.config.ln_eps)

    @property
    def local_heads(self) -> int:
        return self.config.n_head // (self.tp.size if self.tp else 1)

    def _column(self, dense, x, l):
        """A product split on its output: on a tp split, identity forward
        and its input's gradient all-reduced backward."""
        return dense(x if self.tp is None else copy_to_tp(x, self.tp), l)

    def _row(self, dense, x, l, dtype):
        """A product split on its input: on a tp split, each rank's float32
        partial product all-reduced, then the bias added once and the sum
        rounded once to the compute dtype ``dtype``."""
        if self.tp is None:
            return dense(x, l)
        y = reduce_from_tp(dense(x, l, bias=False), self.tp)
        return (y + cast(dense.bias[l], dtype).float()).to(dtype)

    def _attend(self, q, k, v, cache, l, cache_index):
        b, t, c = q.shape
        h = self.local_heads
        dh = c // h
        dtype = q.dtype
        if cache is not None:
            kc, vc = cache["k"], cache["v"]
            ks, vs = cache.get("k_scale"), cache.get("v_scale")
            decode = t == 1 and kc.shape[2] % 256 == 0
            if decode and ks is None:   # K1 writes the step's row itself
                return decode_attention_merged(q[:, 0], k[:, 0], v[:, 0], kc, vc, l,
                                               cache_index, heads=h)[:, None]
            rows = slice(cache_index, cache_index + t)
            if ks is not None:      # int8 cache: quantized rows, (B, H, t) scales
                kc[l, :, rows], k_s = quantize_kv_rows(k, h)
                vc[l, :, rows], v_s = quantize_kv_rows(v, h)
                ks[l, :, :, rows] = k_s.transpose(1, 2)
                vs[l, :, :, rows] = v_s.transpose(1, 2)
            else:
                kc[l, :, rows] = k.to(kc.dtype)
                vc[l, :, rows] = v.to(vc.dtype)
            if decode:              # the int8 cache: its scales stay outside K1
                return chunked_decode_attention_merged(q[:, 0], kc, vc, l, cache_index,
                                                       heads=h, k_scale=ks,
                                                       v_scale=vs)[:, None]
            n = cache_index + t     # keys past the last query are masked anyway

            def read(buf, scale):   # prefix rows, dequantized from the int8 cache
                x = buf[l, :, :n]
                if scale is not None:
                    x = (x.float().reshape(b, n, h, dh)
                         * scale[l, :, :, :n].transpose(1, 2)[..., None]).reshape(b, n, c)
                return x.to(dtype)

            k, v = read(kc, ks), read(vc, vs)
        n = k.shape[1]
        qh = q.reshape(b, t, h, dh).transpose(1, 2)
        kh = k.reshape(b, n, h, dh).transpose(1, 2)
        vh = v.reshape(b, n, h, dh).transpose(1, 2)
        logits = torch.einsum("bhtd,bhsd->bhts", qh.float(), kh.float()) / np.sqrt(dh)
        query_pos = (n - t) + torch.arange(t, device=q.device)[:, None]
        mask = torch.arange(n, device=q.device)[None, :] <= query_pos
        logits = logits.masked_fill(~mask, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(dtype)
        return torch.einsum("bhts,bhsd->bhtd", w, vh).transpose(1, 2).reshape(b, t, c)

    def _block(self, x, l: int, cache, cache_index: int, dtype, blk, c: int):
        """Layer ``l`` of the stacked layers ``blk`` over the residual stream
        ``x`` (compute dtype) of ``c`` channels."""
        h = self._ln(blk.ln_1, x, l).to(dtype)
        q, k, v = self._column(blk.attn.c_attn, h, l).split(c, dim=-1)
        x = x + self._row(blk.attn.c_proj, self._attend(q, k, v, cache, l, cache_index), l,
                          dtype)
        h = self._ln(blk.ln_2, x, l).to(dtype)
        return x + self._row(blk.mlp_proj, gelu_new(self._column(blk.mlp_fc, h, l)),
                             l, dtype)

    def forward(self, emb, cache=None, cache_index: int = 0):
        """emb: (B, T, C). With ``cache`` the new keys/values land at
        [cache_index, cache_index + T) (in place) and attention covers the
        cached prefix; otherwise plain causal attention, each block
        recomputed in the backward pass with ``remat``. Returns (ln_f(x) in
        the compute dtype, cache)."""
        blk = self.h_scan.block
        # the bias: the weight may be int8 (QuantDense)
        dtype = blk.attn.c_attn.bias.dtype if self.dtype is None else self.dtype
        c = blk.attn.c_attn.bias.shape[-1] // 3     # C, or C / tp on a tp split
        x = emb.to(dtype)
        for l in range(self.config.n_layer):
            if self.remat and cache is None:
                # a block draws no random numbers: no RNG state to stash
                x = checkpoint(self._block, x, l, None, cache_index, dtype, blk, c,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = self._block(x, l, cache, cache_index, dtype, blk, c)
        return self.ln_f(x).to(dtype), cache
