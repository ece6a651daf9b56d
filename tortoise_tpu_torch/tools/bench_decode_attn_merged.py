"""Decode attention over the per-head and the merged KV cache layouts, timed
on the GPU beside K1.

Counterpart of ``tools/bench_decode_attn_merged.py``, which chose the
merged (L, B, T, C) cache over the per-head (L, B, H, T, 64) one on a TPU.
Variants, each L layers a step in a Python loop, each layer's q fed from
the last output:

  chunked-bf16   per-head layout, ``ops.attention.chunked_decode_attention_layered``
  chunked-int8   the same over an int8 cache with (L, B, H, T, 1) scales
  merged-bf16    merged layout, ``merged_chunked`` (block-diagonal q, online softmax)
  merged-int8    the same over an int8 cache with (L, B, T, H) scales
  k1-merged      K1, ``ops.attn.decode_attention_merged`` (it also writes row
                 nvalid, as the decode does)

    python3 -m tortoise_tpu_torch.tools.bench_decode_attn_merged [--batch 16] \\
        [--tmax 768] [--layers 30] [--steps 32] [--nvalid 600]

Each variant prints its device ms a step (CUDA events over the steps) and
its host ms a step; ``--device cpu`` runs the plain versions only (for
tests).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from tortoise_tpu_torch.ops.attention import chunked_decode_attention_layered
from tortoise_tpu_torch.ops.attn import decode_attention_merged
from tortoise_tpu_torch.utils import measure

NEG_INF = -1e9
# merged vs per-head on the same data; K1 (bf16 output) vs merged
ABS_BOUND = 3e-2


def merged_chunked(q, ck, cv, layer_idx: int, cache_index: int, *, heads: int,
                   chunk: int = 256, k_scale=None, v_scale=None) -> torch.Tensor:
    """Flash-decode over the merged (L, B, T, C) cache, bf16 or int8 with
    (L, B, T, H) f32 scales. The per-head logits are one (t, C) x (C, H)
    product against a block-diagonal q a chunk; the weighted sum is the full
    (H, t) x (t, C) product, whose (h, h*dh) block diagonal is taken once at
    the end. Returns (B, C) in q's dtype."""
    _, b, _, c = ck.shape
    dh = c // heads
    n = cache_index + 1
    lane = torch.arange(c, device=q.device)[:, None]
    head = torch.arange(heads, device=q.device)[None, :]
    qbd = torch.where(lane // dh == head, q.float()[:, :, None], 0.0)         # (B, C, H)
    m = torch.full((b, heads), NEG_INF, device=q.device)
    l = torch.zeros((b, heads), device=q.device)
    acc = torch.zeros((b, heads, c), device=q.device)
    for start in range(0, n, chunk):
        blk = lambda buf: buf[layer_idx, :, start:start + chunk]
        k_blk, v_blk = blk(ck), blk(cv)
        logits = torch.bmm(k_blk.float(), qbd) * (1.0 / np.sqrt(dh))          # (B, t, H)
        if k_scale is not None:
            logits = logits * blk(k_scale)
        pos = start + torch.arange(k_blk.shape[1], device=q.device)
        logits = torch.where(pos[None, :, None] < n, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(1))
        p = torch.exp(logits - m_new[:, None, :])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(1)
        if v_scale is not None:
            p = p * blk(v_scale)
        acc = acc * alpha[..., None] + torch.bmm(p.transpose(1, 2), v_blk.float())
        m = m_new
    diag = torch.diagonal(acc.reshape(b, heads, heads, dh), dim1=1, dim2=2)   # (B, dh, H)
    return (diag.transpose(1, 2) / l[..., None]).reshape(b, c).to(q.dtype)


def quant_per_head(x):
    """(L, B, H, T, D) -> int8 and (L, B, H, T, 1) f32 scales."""
    s = torch.clamp_min(x.abs().amax(-1, keepdim=True).float() / 127.0, 1e-8)
    return torch.round(x.float() / s).to(torch.int8), s


def quant_merged(x, heads: int):
    """(L, B, T, C) -> int8 and (L, B, T, H) f32 scales."""
    lc, b, t, c = x.shape
    xs = x.reshape(lc, b, t, heads, c // heads)
    s = torch.clamp_min(xs.abs().amax(-1).float() / 127.0, 1e-8)
    return torch.round(xs.float() / s[..., None]).to(torch.int8).reshape(lc, b, t, c), s


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--tmax", type=int, default=768)
    parser.add_argument("--layers", type=int, default=30)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--nvalid", type=int, default=600)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = measure.cuda_device(args.device, "bench_decode_attn_merged")
    b, h, t, layers, steps, dh = args.batch, 16, args.tmax, args.layers, args.steps, 64
    c = h * dh
    nv = min(args.nvalid, t - 1)
    g = torch.Generator(device=dev).manual_seed(0)
    ckm, cvm = (torch.randn((layers, b, t, c), generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
    q = torch.randn((b, c), generator=g, device=dev).to(torch.bfloat16)
    # the per-head layout of the same data, and both int8 forms
    ckh, cvh = (x.reshape(layers, b, t, h, dh).permute(0, 1, 3, 2, 4).contiguous()
                for x in (ckm, cvm))
    qh = q.reshape(b, h, 1, dh)
    (ckh8, ksh), (cvh8, vsh) = quant_per_head(ckh), quant_per_head(cvh)
    (ckm8, ksm), (cvm8, vsm) = quant_merged(ckm, h), quant_merged(cvm, h)
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "B": b, "T": t, "layers": layers, "steps": steps, "nvalid": nv}

    ref = chunked_decode_attention_layered(qh.float(), ckh, cvh, 2, nv)
    got = merged_chunked(q.float(), ckm, cvm, 2, nv, heads=h)
    res["merged_vs_per_head_max_abs_err"] = (ref.reshape(b, c) - got).abs().max().item()
    # K1 writes row nv of the layer; given that row's own k/v it attends to
    # the same rows as the merged form
    k1 = decode_attention_merged(q, ckm[2, :, nv].clone(), cvm[2, :, nv].clone(), ckm, cvm, 2, nv,
                                 heads=h)
    res["k1_vs_merged_max_abs_err"] = (k1.float() - got).abs().max().item()
    print(f"numerics merged vs per-head: {res['merged_vs_per_head_max_abs_err']:.3e}")
    print(f"numerics k1 vs merged: {res['k1_vs_merged_max_abs_err']:.3e}")
    if max(res["merged_vs_per_head_max_abs_err"], res["k1_vs_merged_max_abs_err"]) > ABS_BOUND:
        raise AssertionError(f"the decode attention forms disagree beyond {ABS_BOUND}: {res}")

    def headed(ck, cv, ks, vs):
        def run(n):
            qq = qh.float()
            for _ in range(n):
                for l in range(layers):
                    o = chunked_decode_attention_layered(qq, ck, cv, l, nv, k_scale=ks, v_scale=vs)
                    qq = qq + o.float() * 1e-3
            return qq
        return run

    def merged(ck, cv, ks, vs):
        def run(n):
            qq = q.float()
            for _ in range(n):
                for l in range(layers):
                    o = merged_chunked(qq, ck, cv, l, nv, heads=h, k_scale=ks, v_scale=vs)
                    qq = qq + o.float() * 1e-3
            return qq
        return run

    def k1_merged(n):
        qq = q
        for _ in range(n):
            for l in range(layers):
                o = decode_attention_merged(qq, qq, qq, ckm, cvm, l, nv, heads=h)
                qq = (qq + o * 1e-3).to(q.dtype)
        return qq

    variants = {"chunked-bf16": headed(ckh, cvh, None, None),
                "chunked-int8": headed(ckh8, cvh8, ksh, vsh),
                "merged-bf16": merged(ckm, cvm, None, None),
                "merged-int8": merged(ckm8, cvm8, ksm, vsm),
                "k1-merged": k1_merged}
    res["variants"] = {}
    for name, run in variants.items():
        r = res["variants"][name] = measure.time_steps(run, steps, dev)
        print(f"{name:14s}: {measure.fmt(r['device_ms'], 3)}/step on the device, "
              f"{r['host_ms']:.3f} ms/step host ({layers} layers, T={t}, B={b}, nvalid={nv})")
    return res


if __name__ == "__main__":
    main()
