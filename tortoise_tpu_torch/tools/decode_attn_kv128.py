"""Decode attention over an interleaved k|v cache on the GPU: K5.

Counterpart of ``tools/pallas_decode_attn.py``, the TPU prototype that
stored k and v together as (B*H, T, 128) (k in lanes 0-63, v in 64-127) so
that a 64-wide head fills a whole 128-lane tile, and computed

    logits = kv . [q | 0] / 8   over all 128 lanes (q's v lanes are zero)
    p      = softmax(logits where t < n_valid, else -1e9)
    out    = p . kv, lanes 64-127

per (batch row, head). ``decode_attention_kv128`` is that kernel
(``csrc/decode_attn_kv128.cu``), ``decode_attention_kv128_plain`` the same
function in plain PyTorch. The tool checks the kernel against the plain
version and times L layers a step (a Python loop, one call a layer) beside
the per-head einsum on the (B, H, T, 64) layout (the JAX tool's "XLA
baseline") and, per call, beside ``scaled_dot_product_attention`` over the
k and v halves.

    python3 -m tortoise_tpu_torch.tools.decode_attn_kv128 [--batch 16] [--tmax 256] \\
        [--layers 30] [--steps 64]

Times are CUDA events on the card, the one call's also device time alone
(``measure.device_ms``), repeated on one cache (which stays in L2) and
taken one call a layer over the L layers' caches (read from device
memory); ``--device cpu`` runs the plain versions only (for tests).
"""
from __future__ import annotations

import argparse
import ctypes
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops import _build
from tortoise_tpu_torch.utils import measure

HEADS = 16
NEG = -1e9
# f32 output: the same sums in another order, relative to max|plain|
REL_BOUND = 1e-5
REPS = 20  # timed calls per median
_KERNEL = _build.Kernel("decode_attn_kv128", "tt_decode_attn_kv128",
                        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def decode_attention_kv128_plain(kv, q, n_valid: int) -> torch.Tensor:
    """kv (BH, T, 128) interleaved k|v; q (BH, 64). Returns (BH, 64) f32:
    the TPU kernel's arithmetic, f32 throughout, the softmax weights
    normalized before the weighted sum."""
    bh, t, _ = kv.shape
    qp = F.pad(q.float(), (0, 64))
    kvf = kv.float()
    logits = (kvf * qp[:, None, :]).sum(-1) * (1.0 / np.sqrt(64.0))
    logits = torch.where(torch.arange(t, device=kv.device)[None] < n_valid, logits,
                         torch.full_like(logits, NEG))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return (kvf * p[:, :, None]).sum(1)[:, 64:]


def decode_attention_kv128(kv, q, n_valid: int) -> torch.Tensor:
    """K5. kv (BH, T, 128) bf16 contiguous; q (BH, 64) contiguous, bf16 or
    f32 (read as f32 by the kernel); n_valid a Python int (<= 0 masks every
    row). Returns (BH, 64) f32: the kernel (one launch) on CUDA tensors, the
    plain version on CPU tensors."""
    if not kv.is_cuda:
        return decode_attention_kv128_plain(kv, q, n_valid)
    if kv.dim() != 3 or kv.shape[2] != 128 or kv.dtype != torch.bfloat16 \
            or not kv.is_contiguous():
        raise ValueError(f"kv: needs a contiguous bf16 (BH, T, 128) tensor, got {kv.dtype} "
                         f"{tuple(kv.shape)}")
    bh, t, _ = kv.shape
    if q.shape != (bh, 64) or q.dtype not in (torch.bfloat16, torch.float32) \
            or not q.is_contiguous() or q.get_device() != kv.get_device():
        raise ValueError(f"q: needs a contiguous bf16 or f32 ({bh}, 64) tensor on {kv.device}, "
                         f"got {q.dtype} {tuple(q.shape)} on {q.device}")
    out = q.new_empty((bh, 64), dtype=torch.float32)
    # rows past T are masked as rows past n_valid are: min keeps it a C int
    _KERNEL(kv.get_device(), kv.data_ptr(), q.data_ptr(), q.dtype == torch.bfloat16, bh, t,
            min(int(n_valid), t), out.data_ptr())
    decode_attention_kv128.launches += 1
    return out


decode_attention_kv128.launches = 0


def sdpa_kv128(kv, q, n_valid: int) -> torch.Tensor:
    """The library yardstick: scaled_dot_product_attention of q over the k
    and v halves of rows 0..n_valid-1 (n_valid >= 1), in bf16."""
    k = kv[:, None, :n_valid, :64]
    v = kv[:, None, :n_valid, 64:]
    return F.scaled_dot_product_attention(q.to(kv.dtype)[:, None, None], k, v)[:, 0, 0]


def per_head_einsum(q, ck, cv, n_valid: int) -> torch.Tensor:
    """The JAX tool's XLA baseline on the (B, H, T, 64) layout: masked f32
    softmax attention over all T rows."""
    t = ck.shape[2]
    lg = torch.einsum("bhqd,bhkd->bhqk", q.float(), ck.float()) / np.sqrt(64.0)
    lg = torch.where(torch.arange(t, device=q.device) < n_valid, lg, torch.full_like(lg, NEG))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(lg, -1), cv.float())


def check(kv, q, n_valid: int) -> dict:
    """K5 against its plain version on one call, and on CUDA the call timed
    beside the plain version and SDPA, with its bound; the kernel's and
    SDPA's device time apart (device_ms, library_device_ms)."""
    got = decode_attention_kv128(kv, q, n_valid)
    if kv.is_cuda:
        torch.cuda.synchronize(kv.device)
    want = decode_attention_kv128_plain(kv, q, n_valid)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    bh, t, _ = kv.shape
    rows = min(n_valid, t) if n_valid >= 1 else t
    nb = bh * rows * 128 * kv.element_size() + measure.nbytes(q, got)
    bound_ms, bound_by = measure.bound(nb, 4 * bh * rows * 128, "f32")
    res = {"max_abs_err": err, "rel_err": err / scale, "bound": REL_BOUND, "ms": None,
           "plain_ms": None, "library_ms": None, "device_ms": None, "library_device_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if kv.is_cuda:
        kernel, library = (lambda: decode_attention_kv128(kv, q, n_valid),
                           lambda: sdpa_kv128(kv, q, n_valid))
        res.update(ms=measure.time_ms(kernel, REPS),
                   plain_ms=measure.time_ms(lambda: decode_attention_kv128_plain(kv, q, n_valid),
                                            REPS),
                   library_ms=measure.time_ms(library, REPS),
                   device_ms=measure.device_ms(kernel, REPS),
                   library_device_ms=measure.device_ms(library, REPS))
    return res


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--tmax", type=int, default=256)
    parser.add_argument("--layers", type=int, default=30)
    parser.add_argument("--steps", type=int, default=64)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = measure.cuda_device(args.device, "decode_attn_kv128")
    b, t, layers, steps = args.batch, args.tmax, args.layers, args.steps
    bh = b * HEADS
    n_valid = 200 if t >= 256 else t - 1
    g = torch.Generator(device=dev).manual_seed(0)
    kv = torch.randn((bh, t, 128), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((bh, 64), generator=g, device=dev).to(torch.bfloat16)

    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "BH": bh, "T": t, "n_valid": n_valid, "layers": layers, "steps": steps}
    res["call"] = check(kv, q, n_valid)
    c = res["call"]
    print(f"numerics: maxdiff={c['max_abs_err']:.3e} ({c['rel_err']:.3g} x max|plain|, bound "
          f"{REL_BOUND})")
    if c["rel_err"] > REL_BOUND:
        raise AssertionError(f"K5 disagrees with its plain version: {c}")
    print(f"one call (BH={bh}, T={t}, n={n_valid}): kernel {measure.fmt(c['ms'])} (device "
          f"{measure.fmt(c['device_ms'])}), plain {measure.fmt(c['plain_ms'])}, SDPA "
          f"{measure.fmt(c['library_ms'])} (device {measure.fmt(c['library_device_ms'])}), "
          f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")

    # L layers x N steps, each layer's q fed back from the last output
    kv_l = torch.randn((layers, bh, t, 128), generator=g, device=dev).to(torch.bfloat16)
    ck = kv_l[..., :64].reshape(layers, b, HEADS, t, 64).contiguous()
    cv = kv_l[..., 64:].reshape(layers, b, HEADS, t, 64).contiguous()

    def kernel_steps(n):
        acc = torch.zeros((bh, 64), dtype=torch.float32, device=dev)
        for _ in range(n):
            for l in range(layers):
                acc = acc + decode_attention_kv128(kv_l[l], (q + acc).to(torch.bfloat16), n_valid)
        return acc

    def baseline_steps(n):
        qa = q.reshape(b, HEADS, 1, 64)
        acc = torch.zeros_like(qa, dtype=torch.float32)
        for _ in range(n):
            for l in range(layers):
                acc = acc + per_head_einsum(qa + acc, ck[l], cv[l], n_valid).to(q.dtype)
        return acc

    if dev.type == "cuda":
        # one call a layer, the layers in turn: each call reads its cache from
        # device memory, as a decode step does (the L layers' caches exceed
        # the 50 MB L2), where the repeated call above finds it in L2
        turn = itertools.cycle(range(layers))
        r = res["layer_calls"] = {
            "device_ms": measure.device_ms(
                lambda: decode_attention_kv128(kv_l[next(turn)], q, n_valid), 2 * layers),
            "library_device_ms": measure.device_ms(
                lambda: sdpa_kv128(kv_l[next(turn)], q, n_valid), 2 * layers)}
        print(f"one call a layer over {layers} layers' caches: kernel device "
              f"{r['device_ms']:.4f} ms, SDPA device {r['library_device_ms']:.4f} ms")

    res["kernel_steps"] = measure.time_steps(kernel_steps, steps, dev)
    res["baseline_steps"] = measure.time_steps(baseline_steps, steps, dev)
    for name, key in (("kernel kv128", "kernel_steps"), ("einsum baseline", "baseline_steps")):
        r = res[key]
        print(f"{name:15s}: {measure.fmt(r['device_ms'], 3)}/step on the device, "
              f"{r['host_ms']:.3f} ms/step host ({layers} layers, T={t}, B={b})")
    return res


if __name__ == "__main__":
    main()
