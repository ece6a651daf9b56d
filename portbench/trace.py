"""The reduction of a ``torch.profiler`` window to device time.

Only the profiler's device events are summed (the host ops list the time
of the kernels they launched as well, and adding those would count each
kernel twice). ``FAMILIES`` names a kernel's family by a fragment of its
name, the first match winning; the table is the benchmark's, frozen from
the port's ``utils/profiling.py`` of the port's first benchmark, so that a
renamed kernel shows as an unknown family rather than moving a metric.
"""
from __future__ import annotations

ANNOTATION = "portbench."   # the benchmark's own spans
FAMILIES = (
    ("tc_gemm_kernel<signed char", "K2 gemm int8"),
    ("tc_gemm_kernel", "K2 gemm"),
    ("split_attention_kernel<signed char", "K2 attention int8"),
    ("split_attention_kernel", "K2 attention"),
    ("row_stats_kernel", "K2 gemm"),
    ("flash_rel_attn_kernel", "K3"),
    ("decode_attn_merged_kernel", "K1"),
    ("lvc_kernel", "K4"),
    ("gemm", "cuBLAS/cuDNN"), ("cutlass", "cuBLAS/cuDNN"), ("xmma", "cuBLAS/cuDNN"),
    ("cudnn", "cuBLAS/cuDNN"), ("conv", "cuBLAS/cuDNN"), ("nvjet", "cuBLAS/cuDNN"),
)


def family(name: str) -> str:
    low = name.lower()
    for fragment, fam in FAMILIES:
        if fragment.lower() in low:
            return fam
    return "other"


def merge(spans):
    """Sorted, merged (start, end) intervals of ``spans``."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(spans) -> float:
    """The length of the union of the intervals."""
    return sum(e - s for s, e in merge(spans))


def events(prof):
    """(device events, host events) of a finished profiler session, each a
    list of (name, start_ns, end_ns). Raises when there is no device event:
    a window that ran work on the card and recorded none is a profiler that
    saw nothing, not an idle card."""
    import torch
    raw = [(e.name(), e.device_type(), e.start_ns(), e.end_ns(), e.is_user_annotation())
           for e in prof.profiler.kineto_results.events()]
    cuda = torch.autograd.DeviceType.CUDA
    # a host span (``record_function``) also shows on the device's timeline
    # as an annotation, which is no device work
    device = [(n, s, e) for n, d, s, e, note in raw
              if d == cuda and e > s and not note and not n.startswith(ANNOTATION)]
    host = [(n, s, e) for n, d, s, e, _ in raw if d != cuda and e > s]
    if not device:
        raise RuntimeError("torch.profiler recorded no CUDA device event in the traced window")
    return device, host


def reduce(device, host, window_ns: tuple[int, int], top: int = 10) -> dict:
    """Busy seconds, seconds by family (the union of the family's kernels'
    intervals) and by kernel (summed durations), and the longest idle gaps
    inside ``window_ns``, each named by the innermost host op running at
    its middle (none: the host was in Python or native code of its own)."""
    w0, w1 = window_ns
    spans = [(max(s, w0), min(e, w1)) for _, s, e in device if e > w0 and s < w1]
    merged = merge(spans)
    # a family's seconds are the union of its kernels' intervals: kernels
    # launched as programmatic dependents start before the one they wait
    # for ends, so the sum of their durations would count the wait twice
    spans_of, by_kernel = {}, {}
    for name, s, e in device:
        spans_of.setdefault(family(name), []).append((s, e))
        by_kernel[name] = by_kernel.get(name, 0.0) + (e - s) / 1e9
    by_family = {fam: busy(sp) / 1e9 for fam, sp in spans_of.items()}
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        covering = [(e - s, n) for n, s, e in host
                    if s <= mid <= e and not n.startswith(ANNOTATION)]
        named.append([min(covering)[1] if covering else "host outside any torch op",
                      length / 1e9])
    kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": sum(e - s for s, e in merged) / 1e9, "window_s": (w1 - w0) / 1e9,
            "by_family": by_family,
            "device_ops": [[n[:160], v] for n, v in kernels], "idle_gaps": named}
