"""Timing and roofline bounds on one NVIDIA GPU, shared by chip_smoke.py and
the port's tools (``tortoise_tpu_torch/tools``), so both reckon a kernel's
time and its bound one way.

A bound is the least time the card could take for a call: the larger of its
bytes (each input read once, each output written once) over the memory rate
and its operations over the peak rate for their type (NVIDIA's H100 SXM data
sheet, dense, at the full 700 W power limit).
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# device_ms's head start for the host: ~0.25 ms of sleep (at ~2 GHz) for
# each run it enqueues, against the few tens of microseconds a launch takes
SLEEP_CYCLES_PER_RUN = 500_000
# the same for a whole K2 decode step (one launch up to 128 rows, a few
# hundred microseconds of the wrapper's host work; more above 128 rows):
# ~0.5 ms: ~2 ms of sleep a run
STEP_SLEEP_CYCLES_PER_RUN = 4_000_000
# the card's clock, about: cycles of sleep a millisecond
CYCLES_PER_MS = 2_000_000


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_device(device: str, tool: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist. The tools
    measure the card: on the CPU they run the plain versions only when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: torch sees no CUDA device; it measures the GPU "
                           f"(--device cpu runs the plain versions, for tests)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{tool}: --device {device!r}: cuda or cpu")
    return dev


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, cycles_per_run: int = SLEEP_CYCLES_PER_RUN) -> float:
    """Device time of ``fn`` a run: after one warm-up, ``reps`` runs queued
    behind a kernel that sleeps while the host enqueues them, so CUDA events
    time the device working through them back to back. Unlike ``time_ms``
    it leaves out the host's time to reach each launch, which dominates a
    call of a few microseconds; ``cycles_per_run`` must outlast the host's
    time to enqueue one run. ``fn`` must not synchronise."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles_per_run * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sleep_cycles_for(host_ms: float) -> int:
    """``device_ms``'s head start a run for runs that take the host
    ``host_ms`` each to enqueue: twice that, and at least a K2 step's."""
    return max(STEP_SLEEP_CYCLES_PER_RUN, int(2 * host_ms * CYCLES_PER_MS))


def time_steps(run, steps: int, dev: torch.device) -> dict:
    """``run(k)`` drives k steps from the host. After a one-step warm-up, one
    run of ``steps``: host-clock ms a step (ending in a synchronize) and, on
    CUDA, the CUDA-event ms a step over the same window (None on the CPU)."""
    cuda = dev.type == "cuda"
    run(1)
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if cuda:
        start.record()
    run(steps)
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
    host = (time.perf_counter() - t0) * 1e3 / steps
    return {"host_ms": host, "device_ms": start.elapsed_time(end) / steps if cuda else None}


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) for moving ``nbytes`` and doing ``flops`` of type
    ``dtype`` on the card, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fmt(ms: float | None, digits: int = 4) -> str:
    """A time for printing; "not measured" where the run had no card."""
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"
