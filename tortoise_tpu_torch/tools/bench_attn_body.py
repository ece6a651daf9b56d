"""The fused decode step's attention body on the GPU, two formulations: K6.

Counterpart of ``tools/bench_attn_body_pallas.py``, which picked the
formulation of K2's attention inner loop on a TPU: a flash-decode over a
merged (B, T, C) k/v slab, rows 0..pos in chunks of ck, with an online
softmax, its per-head logits computed either

  a) against a bf16 block-diagonal q, summed in f32, or
  b) as bf16 products k * q, summed in f32 over each head's lanes.

``attn_body`` is that kernel (``csrc/attn_body.cu``, templated on the
variant), ``attn_body_plain`` the same chunked loop in plain PyTorch with
every rounding point of the TPU kernel. The rounding depends on ck, so both
take it. The tool checks each variant against its plain version and the
f32 reference, and times it beside the plain version and
``scaled_dot_product_attention`` of q (B, H, 1, 64) over the (B, n, H, 64)
views of k and v.

    python3 -m tortoise_tpu_torch.tools.bench_attn_body [--batch 128] [--t 768] \\
        [--fill 300] [--ck 64]

``--dtype int8`` is parsed, as by the JAX tool, and refused: that tool
builds bf16 k/v whatever the flag says. Times are CUDA-event medians on the
card; ``--device cpu`` runs the plain versions only (for tests).
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops import _build
from tortoise_tpu_torch.utils import measure

NEG = -1e30
HEADS = 16
VARIANTS = ("a", "b")
# bf16 output: one ulp (2^-8) of each (batch row, head)'s max|plain|, and a
# little more for f32 sums taken in another order
HEAD_REL_BOUND = 1e-2
_KERNEL = _build.Kernel("attn_body", "tt_attn_body", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6)
# the kernel's block (csrc/attn_body.cu): one (head, row), 64 threads, a ring
# of 3 stages of 32 rows
THREADS, STAGE_ROWS, STAGES = 64, 32, 3
SMEM_LIMIT = 227 * 1024


def smem_bytes(ck: int) -> int:
    """Shared memory of one block, as tt_attn_body sizes it: the ring of
    bf16 head rows and the chunk's f32 logits."""
    return STAGES * STAGE_ROWS * 64 * 2 + ck * 4


def _check_chunks(t: int, ck: int, pos: int):
    if ck < 1 or t % ck:
        raise ValueError(f"ck={ck} must divide T={t}: the TPU kernel DMAs whole chunks and "
                         "would read past T")
    if not 0 <= pos < t:
        raise ValueError(f"pos={pos} outside T={t}")


def attn_body_plain(q, k, v, pos: int, *, heads: int = HEADS, ck: int = 64,
                    variant: str = "a") -> torch.Tensor:
    """q (B, C), k / v (B, T, C) bf16. Rows 0..pos in chunks of ck, the TPU
    kernel's rounding points: logits f32 (variant b: each product k * q
    rounded to bf16 first), / 8, -1e30 past pos; online softmax with f32 m
    and l; bf16(bf16(p) * v) summed in f32; out = bf16(acc / l)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}: a or b")
    b, c = q.shape
    t = k.shape[1]
    _check_chunks(t, ck, pos)
    dh = c // heads
    n = pos + 1
    qf = q.float()
    m = torch.full((b, heads), NEG, device=q.device)
    l = torch.zeros((b, heads), device=q.device)
    acc = torch.zeros((b, c), device=q.device)
    bf = lambda x: x.to(torch.bfloat16).float()
    for start in range(0, n, ck):
        kb, vb = k[:, start:start + ck].float(), v[:, start:start + ck].float()
        prod = kb * qf[:, None, :]
        if variant == "b":
            prod = bf(prod)
        logits = prod.reshape(b, ck, heads, dh).sum(-1) * (1.0 / np.sqrt(dh))   # (B, ck, H)
        rows = start + torch.arange(ck, device=q.device)
        logits = torch.where(rows[None, :, None] < n, logits, torch.full_like(logits, NEG))
        m_new = torch.maximum(m, logits.amax(1))
        p = torch.exp(logits - m_new[:, None, :])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(1)
        m = m_new
        p_exp = bf(p).repeat_interleave(dh, dim=-1)                              # (B, ck, C)
        pv = bf(p_exp * vb).sum(1)
        acc = acc * alpha.repeat_interleave(dh, dim=-1) + pv
    return (acc / l.repeat_interleave(dh, dim=-1)).to(torch.bfloat16)


def attn_body(q, k, v, pos: int, *, heads: int = HEADS, ck: int = 64,
              variant: str = "a") -> torch.Tensor:
    """K6. q (B, C), k / v (B, T, C), bf16 and contiguous, C = heads x 64.
    Returns (B, C) bf16: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if not q.is_cuda:
        return attn_body_plain(q, k, v, pos, heads=heads, ck=ck, variant=variant)
    if q.shape[-1] != heads * 64:
        raise ValueError(f"attn_body kernel needs a head dim of 64: C={q.shape[-1]}, "
                         f"heads={heads}")
    check_launch(q, k, v, pos, ck, variant)
    out = torch.empty_like(q)
    _KERNEL(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], k.shape[1], q.shape[1], pos, ck, VARIANTS.index(variant))
    attn_body.launches += 1
    attn_body.launches_by_variant[variant] += 1
    return out


def check_launch(q, k, v, pos: int, ck: int, variant: str) -> None:
    """Raises ValueError for what tt_attn_body refuses."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}: a or b")
    b, c = q.shape
    if c % 64:
        raise ValueError(f"attn_body kernel needs C a multiple of 64: C={c}")
    for name, x, shape in (("q", q, (b, c)), ("k", k, (b, k.shape[1], c)),
                           ("v", v, (b, k.shape[1], c))):
        if tuple(x.shape) != shape or x.dtype != torch.bfloat16 or not x.is_contiguous() \
                or x.device != q.device or x.data_ptr() % 16:
            raise ValueError(f"{name}: needs a contiguous, 16-byte aligned bf16 {shape} tensor "
                             f"on {q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    _check_chunks(k.shape[1], ck, pos)
    if smem_bytes(ck) > SMEM_LIMIT:
        raise ValueError(f"ck={ck}: the ring and {ck} logits take {smem_bytes(ck)} bytes of "
                         f"shared memory, over {SMEM_LIMIT}")


attn_body.launches = 0
attn_body.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def reference(q, k, v, pos: int, heads: int = HEADS) -> torch.Tensor:
    """f32 softmax attention over rows 0..pos, the JAX tool's reference."""
    b, c = q.shape
    dh, n = c // heads, pos + 1
    kh = k[:, :n].float().reshape(b, n, heads, dh)
    vh = v[:, :n].float().reshape(b, n, heads, dh)
    logits = torch.einsum("bhd,bthd->bht", q.float().reshape(b, heads, dh), kh) / np.sqrt(dh)
    return torch.einsum("bht,bthd->bhd", torch.softmax(logits, -1), vh).reshape(b, c)


def sdpa(q, k, v, pos: int, heads: int = HEADS) -> torch.Tensor:
    """The library yardstick: SDPA of q (B, H, 1, 64) over the (B, n, H, 64)
    views of k and v, in bf16."""
    b, c = q.shape
    n = pos + 1
    view = lambda x: x[:, :n].view(b, n, heads, c // heads).transpose(1, 2)
    return F.scaled_dot_product_attention(q.view(b, heads, 1, c // heads), view(k),
                                          view(v)).reshape(b, c)


def head_rel_err(got, want, heads: int = HEADS) -> float:
    """Largest error over (batch row, head), each relative to that head's max|want|."""
    b, c = want.shape
    g = got.float().reshape(b, heads, c // heads)
    w = want.float().reshape(b, heads, c // heads)
    return ((g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-6)).max().item()


def check(q, k, v, pos: int, ck: int, variant: str, reps: int) -> dict:
    """One variant against its plain version (per head, HEAD_REL_BOUND) and
    the f32 reference; on CUDA timed beside the plain version and SDPA, the
    kernel's and SDPA's device time apart (device_ms, library_device_ms)."""
    got = attn_body(q, k, v, pos, ck=ck, variant=variant)
    if q.is_cuda:
        torch.cuda.synchronize(q.device)
    want = attn_body_plain(q, k, v, pos, ck=ck, variant=variant)
    b, c = q.shape
    n = pos + 1
    bound_ms, bound_by = measure.bound(2 * b * n * c * k.element_size() + measure.nbytes(q, got),
                                       4 * b * n * c, "f32")
    res = {"variant": variant, "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "head_rel_err": head_rel_err(got, want), "bound": HEAD_REL_BOUND,
           "ref_max_abs_err": (got.float() - reference(q, k, v, pos)).abs().max().item(),
           "ms": None, "plain_ms": None, "library_ms": None, "device_ms": None,
           "library_device_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    if q.is_cuda:
        kernel = lambda: attn_body(q, k, v, pos, ck=ck, variant=variant)
        library = lambda: sdpa(q, k, v, pos)
        res.update(
            ms=measure.time_ms(kernel, reps),
            plain_ms=measure.time_ms(
                lambda: attn_body_plain(q, k, v, pos, ck=ck, variant=variant), max(reps // 8, 3)),
            library_ms=measure.time_ms(library, reps),
            device_ms=measure.device_ms(kernel, reps),
            library_device_ms=measure.device_ms(library, reps))
    return res


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--t", type=int, default=768)
    parser.add_argument("--fill", type=int, default=300)
    parser.add_argument("--ck", type=int, default=64)
    parser.add_argument("--reps", type=int, default=64, help="timed calls per median")
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "int8"])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.dtype != "bf16":
        raise NotImplementedError("--dtype int8: the JAX tool parses it but always builds bf16 "
                                  "k/v, so no int8 body exists to port (ROADMAP.md, Queue 3)")
    dev = measure.cuda_device(args.device, "bench_attn_body")
    b, c, t = args.batch, HEADS * 64, args.t
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((b, c), (b, t, c), (b, t, c)))
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "B": b, "T": t, "pos": args.fill, "ck": args.ck, "variants": {}}
    for variant in VARIANTS:
        r = check(q, k, v, args.fill, args.ck, variant, args.reps)
        res["variants"][variant] = r
        print(f"variant {variant}: kernel {measure.fmt(r['ms'])}, plain {measure.fmt(r['plain_ms'])}"
              f", SDPA {measure.fmt(r['library_ms'])}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); max head rel err vs plain {r['head_rel_err']:.3g} (bound "
              f"{HEAD_REL_BOUND}), max_err vs f32 reference {r['ref_max_abs_err']:.4f} "
              f"(B={b}, fill={args.fill}, ck={args.ck})")
        if r["head_rel_err"] > HEAD_REL_BOUND:
            raise AssertionError(f"K6 variant {variant} disagrees with its plain version: {r}")
    return res


if __name__ == "__main__":
    main()
