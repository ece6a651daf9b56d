"""Stage timing for the APIs (``StageTimer``) and a device-time breakdown of
TextToSpeech requests on one GPU.

    python3 -m tortoise_tpu_torch.utils.profiling [--out build/profile.json] [--k2]

Builds the full-width TextToSpeech (seeded random weights, voice
train_dotrice), answers one unprofiled warm-up request, then answers one
ultra_fast and one fast request (classifier-free guidance, 96 candidates)
under ``torch.profiler``. For each it reports the profiled wall seconds,
the device busy time (the union of the device events' intervals), the busy
share of the profiled wall, device time by kernel family and the stage
seconds. Only device events are summed: the profiler also lists every aten
op with the time of the kernels it launched, and adding those would count
each kernel twice. The profiler's own host cost stretches the wall, so the
busy share is a lower bound for an unprofiled request.

``--k2`` profiles K2's decode step alone instead, each weight x cache
variant at full width (L=30, C=1024, pos=500, T=768, B in {1, 16}): per
step the CUDA-event time of 10 back-to-back steps, the device busy time and
the device time by kernel family, so the launch gaps (event time minus busy
time) show beside the kernels' own time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch


class StageTimer:
    """Collects named stage timings; ``report()`` returns/prints a summary.
    A copy of ``tortoise_tpu/utils/profiling.py::StageTimer``."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def report(self, print_it: bool = False) -> dict[str, float]:
        summary: dict[str, float] = {}
        for name, dt in self.stages:
            summary[name] = summary.get(name, 0.0) + dt
        if print_it:
            total = sum(summary.values())
            for name, dt in sorted(summary.items(), key=lambda kv: -kv[1]):
                print(f"  {name:>28s}: {dt * 1000:8.1f} ms ({dt / total * 100:4.1f}%)")
        return summary

    def json(self) -> str:
        return json.dumps(self.report())


# kernel name fragment -> family, first match wins
FAMILIES = (
    ("rows_gemm_kernel<signed char", "K2 gemm int8"),
    ("rows_gemm_kernel", "K2 gemm"),
    ("decode_attention_kernel<signed char", "K2 attention int8"),
    ("decode_attention_kernel", "K2 attention"),
    ("flash_rel_attn_kernel", "K3"),
    ("decode_attn_merged_kernel", "K1"), ("merge_splits_kernel", "K1"),
    ("lvc_kernel", "K4"),
    ("gemm", "cuBLAS/cuDNN"), ("cutlass", "cuBLAS/cuDNN"), ("xmma", "cuBLAS/cuDNN"),
    ("cudnn", "cuBLAS/cuDNN"), ("conv", "cuBLAS/cuDNN"),
    ("nvjet", "cuBLAS/cuDNN"),   # cuBLAS's own Hopper GEMMs (CUDA 12.8)
)
REQUESTS = (
    ("ultra_fast", "The quick brown fox jumps over the lazy dog.", 11),
    ("fast", "This request runs classifier free guidance, so the diffusion "
             "batch holds two rows.", 13),
)


def family(name: str) -> str:
    low = name.lower()
    for fragment, fam in FAMILIES:
        if fragment.lower() in low:
            return fam
    return "other"


def device_breakdown(events) -> dict:
    """Device events (each with ``name``, ``start_us``, ``end_us``) -> busy
    milliseconds, first-to-last span and milliseconds by family."""
    spans = sorted((e["start_us"], e["end_us"]) for e in events)
    busy, cur_start, cur_end = 0.0, None, None
    for s, e in spans:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy += cur_end - cur_start
    by_family: dict[str, float] = {}
    for e in events:
        fam = family(e["name"])
        by_family[fam] = by_family.get(fam, 0.0) + (e["end_us"] - e["start_us"]) / 1000.0
    return {"device_busy_ms": busy / 1000.0,
            "device_span_ms": (max(e for _, e in spans) - spans[0][0]) / 1000.0 if spans else 0.0,
            "ms_by_family": by_family, "n_device_events": len(events)}


def device_events(prof) -> list[dict]:
    return [{"name": e.name, "start_us": e.time_range.start, "end_us": e.time_range.end}
            for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_requests(tts, clips) -> dict:
    from torch.profiler import ProfilerActivity, profile

    tts.tts_with_preset(REQUESTS[0][1], preset="ultra_fast", voice_samples=clips,
                        use_deterministic_seed=10, verbose=False)
    out = {}
    for preset, text, seed in REQUESTS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tts.tts_with_preset(text, preset=preset, voice_samples=clips,
                                use_deterministic_seed=seed, verbose=False)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000.0
        res = device_breakdown(device_events(prof))
        res.update(wall_ms_profiled=wall_ms,
                   busy_share_of_wall=res["device_busy_ms"] / wall_ms,
                   stages_s=tts.last_stage_timings)
        out[preset] = res
    return out


def profile_k2_variants(steps: int = 10) -> dict:
    """Per-step times of each K2 variant on random full-width inputs."""
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch.ops.decode_step import (fused_decode_step, quantize_cache,
                                                    quantize_stack, variant)

    L, C, H, T, pos = 30, 1024, 16, 768, 500
    g = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *s, std=1.0: (torch.randn(s, generator=g, device="cuda") * std).bfloat16()
    bf = {"ln1": torch.stack([1 + rand(L, C, std=0.1), rand(L, C, std=0.1)], 1).contiguous(),
          "ln2": torch.stack([1 + rand(L, C, std=0.1), rand(L, C, std=0.1)], 1).contiguous()}
    for key, (n, k) in {"qkv": (3 * C, C), "proj": (C, C), "fc": (4 * C, C),
                        "fc2": (C, 4 * C)}.items():
        bf["w" + key], bf["b" + key] = rand(L, n, k, std=k ** -0.5), rand(L, n, std=0.02)
    out = {}
    for b in (1, 16):
        bcache = {n: rand(L, b, T, C) for n in ("k", "v")}
        qcache = quantize_cache(bcache, H)
        x = rand(b, C)
        for stacked in (bf, quantize_stack(bf)):
            for cache in (bcache, qcache):
                run = lambda: fused_decode_step(stacked, x, cache, pos, H)
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    start.record()
                    for _ in range(steps):
                        run()
                    end.record()
                    torch.cuda.synchronize()
                res = device_breakdown(device_events(prof))
                out[f"{variant(stacked, cache)} B={b}"] = {
                    "step_ms": start.elapsed_time(end) / steps,
                    "device_busy_ms_per_step": res["device_busy_ms"] / steps,
                    "ms_by_family_per_step": {k: v / steps
                                              for k, v in res["ms_by_family"].items()},
                    "kernels_per_step": res["n_device_events"] / steps}
    return out


def main() -> int:
    import subprocess

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.utils.audio import load_voice

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join("build", "profile.json"))
    parser.add_argument("--k2", action="store_true",
                        help="profile K2's decode step per variant instead of requests")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling: torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    if args.k2:
        result = {"nvidia_smi": smi, **profile_k2_variants()}
    else:
        tts = TextToSpeech(device="cuda", enable_redaction=False)
        clips, _ = load_voice("train_dotrice")
        result = {"nvidia_smi": smi, **profile_requests(tts, clips)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
