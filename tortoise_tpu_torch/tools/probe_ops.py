"""Data-movement and contraction probes on the GPU: K7 and K8.

Counterpart of ``tools/probe_mosaic_ops.py``, which asked which Mosaic
lowerings compile on a TPU (reshapes, lane slices, transposes, a 3-D
contraction, a broadcast multiply) and timed four orientations of the fused
decode step's attention matmuls. Here each probe is a hand-written CUDA
kernel (``csrc/probe_ops.cu``) held against its plain PyTorch version:

* K7, ``probe``: the seven probes on the same arange/100 f32 inputs at the
  same shapes (B=64, ck=32, H=16, T=768, C=1024). ``OK`` means the kernel
  launched and matched its plain version bit for bit (the contraction, probe
  6: within 1e-6 of max|plain|).
* K8, ``contraction``: the four orientations (B=64, ck=128, C=1024, H=16),
  bf16 in, f32 out, on seeded random bf16 inputs (all-ones inputs would hide
  an index error), within 1e-5 of max|plain|, each timed beside one
  ``torch.bmm(a, b, out_dtype=torch.float32)`` of the same bf16 operands
  (the same function: bf16 in, f32 out) as the library yardstick, and the
  bf16-output ``torch.bmm`` (half the bytes written, rounded outputs) beside
  it.

    python3 -m tortoise_tpu_torch.tools.probe_ops

Times are CUDA-event medians on the card (host launch time included) and
device times alone (``measure.device_ms``). On the card the tool also
reads the host's path to a launch (``launch_costs``) on a null kernel.
``--device cpu`` runs the plain versions only (for tests). Exits 1 if any
probe fails.
"""
from __future__ import annotations

import argparse
import ctypes
import time

import torch

from tortoise_tpu_torch.ops import _build
from tortoise_tpu_torch.utils import measure

B, CK, H, T, C = 64, 32, 16, 768, 1024           # K7's shapes
O_B, O_CK, O_C, O_H = 64, 128, 1024, 16          # K8's shapes
DYN_START = 2 * 32                               # probe 4's column, known at run time
CONTRACT_REL_BOUND = 1e-6                        # probe 6: f32 sums of 16 products
ORIENT_REL_BOUND = 1e-5                          # K8: f32 sums of exact bf16 products
REPS = 20                                        # timed calls per median

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_PROBE = _build.Kernel("probe_ops", "tt_probe", [_I, _P, _P, _P] + [_I] * 6)
_CONTRACTION = _build.Kernel("probe_ops", "tt_contraction", [_P, _P, _P] + [_I] * 4 + [_L] * 6)
_NULL = _build.Kernel("probe_ops", "tt_null", [])
LAUNCH_CALLS = 2000                              # calls per host-cost reading

# (name as the JAX tool prints it, input shapes, output shape)
PROBES = (
    ("reshape (B,ck,H)->(B*ck,H)", [(B, CK, H)], (B * CK, H)),
    ("reshape (B,ck*H)->(B,ck,H)", [(B, CK * H)], (B, CK, H)),
    ("lane slice (B,H,T)[..,32:64]", [(B, H, T)], (B, H, 32)),
    ("dyn lane slice pl.ds(64,32)", [(B, H, T)], (B, H, 32)),
    ("transpose (B,H,ck)->(B,ck,H)", [(B, H, CK)], (B, CK, H)),
    ("dot (B,H,ck)x(C,H)->(B,ck,C)", [(B, H, CK), (C, H)], (B, CK, C)),
    ("bcast (B,1,ck)*(B,H,ck)", [(B, H, CK), (B, 1, CK)], (B, H, CK)),
)


def probe_inputs(i: int, device) -> list[torch.Tensor]:
    """Probe ``i`` (1-7)'s inputs: arange / 100 in f32, as the JAX tool makes them."""
    return [torch.arange(int(torch.Size(s).numel()), dtype=torch.float32, device=device)
            .reshape(s) / 100.0 for s in PROBES[i - 1][1]]


# probe i's input and output shapes as torch.Size, for the wrapper's checks
_IN_SIZES = tuple(tuple(torch.Size(s) for s in ins) for _, ins, _ in PROBES)
_OUT_SIZES = tuple(torch.Size(out) for _, _, out in PROBES)


def _contract_plain(p, m):
    """(B, H, ck) x (C, H) over H, the products rounded apart and summed
    over h in order: the kernel's own order, so the two agree bit for bit."""
    acc = torch.zeros((p.shape[0], p.shape[2], m.shape[0]), dtype=torch.float32, device=p.device)
    for h in range(p.shape[1]):
        acc = acc + p[:, h, :, None] * m[None, None, :, h]
    return acc


def probe_plain(i: int, x, y=None) -> torch.Tensor:
    """Probe ``i``'s function in plain PyTorch, the output a new tensor."""
    if i == 1:
        return x.reshape(-1, x.shape[-1]).clone()
    if i == 2:
        return x.reshape(x.shape[0], -1, H).clone()
    if i == 3:
        return x[..., 32:64].contiguous()
    if i == 4:
        return x[..., DYN_START:DYN_START + 32].contiguous()
    if i == 5:
        return x.transpose(1, 2).contiguous()
    if i == 6:
        return _contract_plain(x, y)
    if i == 7:
        return x * y
    raise ValueError(f"probe {i}: 1-7")


def probe_library(i: int, x, y=None) -> torch.Tensor:
    """One PyTorch call computing probe ``i``: the plain version, except the
    contraction, which goes to one einsum."""
    return torch.einsum("bhk,ch->bkc", x, y) if i == 6 else probe_plain(i, x, y)


def _check_probe_inputs(i: int, x, y) -> None:
    sizes = _IN_SIZES[i - 1]
    if x.shape != sizes[0] or x.dtype != torch.float32 or not x.is_contiguous() or (
            (y is None) != (len(sizes) == 1)) or y is not None and (
            y.shape != sizes[1] or y.dtype != torch.float32 or not y.is_contiguous()
            or y.get_device() != x.get_device()):
        raise ValueError(f"probe {i}: needs contiguous float32 inputs of shapes "
                         f"{PROBES[i - 1][1]} on one device, got "
                         f"{[(t.dtype, tuple(t.shape)) for t in (x, y) if t is not None]}")


def probe(i: int, x, y=None) -> torch.Tensor:
    """K7: probe ``i`` (1-7) on contiguous f32 inputs of its shapes
    (``PROBES``) on one device: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not x.is_cuda:
        return probe_plain(i, x, y)
    if not 1 <= i <= 7:
        raise ValueError(f"probe {i}: 1-7")
    _check_probe_inputs(i, x, y)
    out = x.new_empty(_OUT_SIZES[i - 1])
    _PROBE(x.get_device(), i, x.data_ptr(), None if y is None else y.data_ptr(), out.data_ptr(),
           B, CK, H, T, C, DYN_START)
    probe.launches += 1
    return out


probe.launches = 0


def contraction_plain(a, b) -> torch.Tensor:
    """(BT, I, R) x (BT, R, J) -> (BT, I, J) f32: the f32 products of the
    operands (exact for bf16), summed in f32."""
    return torch.bmm(a.float(), b.float())


def contraction(a, b) -> torch.Tensor:
    """K8: a (BT, I, R) and b (BT, R, J) bf16, any strides (a batch dim of
    size 1 may be an expanded view); returns (BT, I, J) f32. The kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if not a.is_cuda:
        return contraction_plain(a, b)
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1] \
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or b.device != a.device:
        raise ValueError(f"contraction: needs bf16 (BT, I, R) and (BT, R, J) on one device, got "
                         f"{a.dtype} {tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    bt, i, r = a.shape
    j = b.shape[2]
    out = torch.empty((bt, i, j), dtype=torch.float32, device=a.device)
    _CONTRACTION(a.get_device(), a.data_ptr(), b.data_ptr(), out.data_ptr(), bt, i, j, r,
                 *a.stride(), *b.stride())
    contraction.launches += 1
    return out


contraction.launches = 0


def orientation_operands(g: torch.Generator, device, b: int = O_B, ck: int = O_CK, c: int = O_C,
                         h: int = O_H) -> dict[str, tuple]:
    """Seeded random bf16 operands of the four orientations, as the JAX
    bodies take them, each with the (BT, I, R) and (BT, R, J) views
    ``contraction`` takes and the output's shape as the JAX body writes it:
    {name: (operands, A view, B view, output shape)}."""
    r = lambda *s: torch.randn(s, generator=g, device=device).to(torch.bfloat16)
    k, q = r(b, ck, c), r(b, c, h)
    qh, kk = r(b, h, c), r(b, ck, c)
    p, m = r(b, ck, h), r(h, c)
    pt, v = r(b, h, ck), r(b, ck, c)
    return {
        "logits o1 (B,ck,C)x(B,C,H)": ((k, q), k, q, (b, ck, h)),
        "logits o2 (B,H,C)x(B,ck,C)": ((qh, kk), qh, kk.transpose(1, 2), (b, h, ck)),
        "p_exp collapse (B*ck,H)x(H,C)": ((p, m), p.reshape(1, b * ck, h), m[None], (b, ck, c)),
        "pv batched (B,H,ck)x(B,ck,C)": ((pt, v), pt, v, (b, h, c)),
    }


def _err(got, want) -> tuple[float, float]:
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def run_probes(dev) -> list[dict]:
    """K7: each probe against its plain version; on CUDA each timed with its
    plain version and library call, the kernel's and the library call's
    device time apart (device_ms, library_device_ms). Prints OK / FAIL per
    probe."""
    cuda = dev.type == "cuda"
    out = []
    for i, (name, _, shape) in enumerate(PROBES, start=1):
        args = probe_inputs(i, dev)
        got = probe(i, *args)
        if cuda:
            torch.cuda.synchronize(dev)
        want = probe_plain(i, *args)
        err, rel = _err(got, want)
        exact = torch.equal(got, want)
        ok = got.shape == shape and (rel <= CONTRACT_REL_BOUND if i == 6 else exact)
        res = {"probe": i, "name": name, "ok": ok, "max_abs_err": err, "rel_err": rel,
               "bit_exact": exact}
        nb = measure.nbytes(*args) + 4 * int(torch.Size(shape).numel())
        flops = {6: 2 * B * CK * C * H, 7: B * H * CK}.get(i, 0)
        res["bound_ms"], res["bound_by"] = measure.bound(nb, flops, "f32")
        res.update(nbytes=nb, flops=flops, ms=None, plain_ms=None, library_ms=None,
                   device_ms=None, library_device_ms=None)
        if cuda and ok:
            kernel, library = lambda: probe(i, *args), lambda: probe_library(i, *args)
            res.update(ms=measure.time_ms(kernel, REPS),
                       plain_ms=measure.time_ms(lambda: probe_plain(i, *args), REPS),
                       library_ms=measure.time_ms(library, REPS),
                       device_ms=measure.device_ms(kernel, REPS),
                       library_device_ms=measure.device_ms(library, REPS))
        print(f"{'OK' if ok else 'FAIL':6s}{name}"
              + ("" if ok else f": max|err| {err:.3g} ({rel:.3g} x max|plain|)")
              + (f": kernel {measure.fmt(res['ms'])} (device {measure.fmt(res['device_ms'])}), "
                 f"torch {measure.fmt(res['library_ms'])} (device "
                 f"{measure.fmt(res['library_device_ms'])}), bound {res['bound_ms']:.4f} ms"
                 if cuda and ok else ""))
        out.append(res)
    return out


def launch_costs(dev) -> dict:
    """The host's path to a launch on the card, read on the null kernel
    (``csrc/probe_ops.cu`` ``tt_null``) through ``_build.Kernel``, the path
    every wrapper takes: ``host_us``, host microseconds a call over
    LAUNCH_CALLS calls back to back, then one synchronize (the null kernel
    takes the device less time than its launch takes the host, so the queue
    never holds the host back); ``ms`` and ``device_ms``, its event and
    device ms a call (``measure.time_ms``, ``measure.device_ms``)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    null = lambda: _NULL(index)
    null()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(LAUNCH_CALLS):
        null()
    res = {"host_us": (time.perf_counter() - t0) * 1e6 / LAUNCH_CALLS}
    torch.cuda.synchronize(dev)
    res.update(ms=measure.time_ms(null, REPS), device_ms=measure.device_ms(null, REPS))
    print(f"null kernel through _build.Kernel: host {res['host_us']:.2f} us, event "
          f"{res['ms']:.4f} ms, device {res['device_ms']:.4f} ms a call")
    return res


def timed_probes(dev) -> list[dict]:
    """K8: each orientation against its plain version and, on CUDA, timed
    beside its plain version, the f32-output torch.bmm of the bf16 operands
    (library_ms) and the bf16-output one (library_bf16_ms); the kernel's and
    the f32 bmm's device time apart (device_ms, library_device_ms)."""
    cuda = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for name, (_, a, b, shape) in orientation_operands(g, dev).items():
        got = contraction(a, b).reshape(shape)
        if cuda:
            torch.cuda.synchronize(dev)
        want = contraction_plain(a, b).reshape(shape)
        err, rel = _err(got, want)
        ok = rel <= ORIENT_REL_BOUND
        bt, i, r = a.shape
        nb = measure.nbytes(a, b) + 4 * got.numel()
        flops = 2 * bt * i * r * b.shape[2]
        bound_ms, bound_by = measure.bound(nb, flops, "bf16")
        res = {"name": name, "ok": ok, "max_abs_err": err, "rel_err": rel, "nbytes": nb,
               "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by, "ms": None,
               "plain_ms": None, "library_ms": None, "library_bf16_ms": None,
               "device_ms": None, "library_device_ms": None}
        if cuda:
            # bmm's out_dtype has no CPU kernel: timed on the card only
            kernel = lambda: contraction(a, b)
            library = lambda: torch.bmm(a, b, out_dtype=torch.float32)
            res.update(ms=measure.time_ms(kernel, REPS),
                       plain_ms=measure.time_ms(lambda: contraction_plain(a, b), REPS),
                       library_ms=measure.time_ms(library, REPS),
                       library_bf16_ms=measure.time_ms(lambda: torch.bmm(a, b), REPS),
                       device_ms=measure.device_ms(kernel, REPS),
                       library_device_ms=measure.device_ms(library, REPS))
        print(f"{'TIME' if ok else 'FAIL':6s}{name}: kernel {measure.fmt(res['ms'])} "
              f"(device {measure.fmt(res['device_ms'])}), plain "
              f"{measure.fmt(res['plain_ms'])}, torch.bmm f32 out "
              f"{measure.fmt(res['library_ms'])} (device "
              f"{measure.fmt(res['library_device_ms'])}; bf16 out "
              f"{measure.fmt(res['library_bf16_ms'])}), "
              f"bound {bound_ms:.4f} ms ({bound_by}); max|err| {err:.3g} "
              f"({rel:.3g} x max|plain|, bound {ORIENT_REL_BOUND})")
        out.append(res)
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = measure.cuda_device(args.device, "probe_ops")
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "probes": run_probes(dev), "orientations": timed_probes(dev)}
    res["ok"] = all(p["ok"] for p in res["probes"] + res["orientations"])
    if dev.type == "cuda":
        res["launch_costs"] = launch_costs(dev)
    return res


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
