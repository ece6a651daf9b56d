"""The program's spans (``span``, ``request``, ``spans``), stage timing
for the APIs (``StageTimer``), a timeline of any block of code (``trace``)
and a device-time breakdown of TextToSpeech requests on one GPU.

    from tortoise_tpu_torch.utils.profiling import trace
    with trace("build/trace"):
        ...

writes one Chrome trace, ``build/trace/<host>_<pid>.<ns>.pt.trace.json``:
the block's host ops and, on a GPU, its kernels, copies and launches on one
timeline. Open it in the Perfetto UI (ui.perfetto.dev) or in Chrome's
``chrome://tracing``. To see where a served request spends its time, wrap
the server's loop or one call in ``trace(dir)``: the file holds the
program's spans as host ranges above the aten ops and kernels they
launched, and ``spans()`` lists them after the block.

Spans. Every public entry point (``TextToSpeech.tts``, and
``TextToSpeechFast``'s ``tts``, ``tts_batch`` and ``tts_stream``) runs
inside a ``tts.request`` span, which gives its spans one request id; inside
it, the stages (``tts.prepare``, ``tts.autoregressive``,
``tts.latent_reextraction``, ``tts.hifigan``, and the quality API's
``StageTimer`` stages as ``tts.<stage>``), each ending at a copy to the
host or a sync the program makes anyway; inside those, the steps
(``tts.ar.prefill``, ``tts.ar.step``, ``tts.ar.finish_check``,
``tts.diffusion.step``). With no profiler running a span is one check and
a shared no-op: 0.83 us a span on the H100 machine's host (the check alone
0.16 us; ``record_function`` alone would cost 11.6 us). Under
``torch.profiler`` a span is a ``record_function`` range and a ``Span``
record on the profiler's clock: 15.0 us a span there, and a full-width
stream's wall under the profiler is the same with spans on and off (medians
0.867 and 0.869 s of six each). A span holds ints and strings only and
never syncs the device.

    python3 -m tortoise_tpu_torch.utils.profiling [--out build/profile.json] [--k2 | --k4k6 | --train]
        [--dtype f32|bf16]

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
variant at full width (L=30, C=1024, T=768) at the batches the paths run:
B=1 and B=16 at pos=500, B=96 at pos=566 (the fast request's last step).
Per step: the CUDA-event time of back-to-back steps, the device time
(``measure.device_ms``: no host time), and from one ``torch.profiler`` pass
the device busy time and the device time by kernel family, so the host's
gaps (event time minus busy time) show beside the kernel's own time. For
the bf16 rows also the step's split by phase (``k2_phases``: the
persistent kernel's own ns stamps a phase and block). Beside the bf16
rows, the yardstick of K2's products: the device time of the step's 120
dense products as ``torch.matmul`` (cuBLAS) at the same shapes, which the
port never calls. Every event and device time is taken before the first
profiler pass.

``--k4k6`` times K4 and K6 alone, event and device ms (no profiler). K4
at UnivNet c32's shapes (F=2186 frames, B=1, f32) per hop: on kernels laid
out as the predictor leaves them (frames innermost) and as each frame's
contiguous (Ci, Co, K) block (what ``.contiguous()`` of the predictor's
output gives), beside the einsum LVC; the time of that copy for one
block's four layers; one UnivNet forward (the full-width generator, seeded
random weights, 2176 mel frames), and the same forward with the copy put
back. K6 at the JAX tool's shapes (B=128, T=768, pos=300, ck=64), both
variants beside SDPA.

``--train`` profiles one full-width UnifiedVoice train step (B=4 over the
full 402 text and 604 mel tokens, float32 with TF32 off, seeded random
weights and batch) after three unprofiled steps: its wall, the device busy
time, device time by kernel family and the kernels that take the most.
``--dtype bf16`` computes it in bf16 over the float32 parameters
(``UnifiedVoice(dtype=torch.bfloat16)``).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import itertools
import json
import os
import tempfile
import threading
import time

import torch


REQUEST = "tts.request"
_profiler_enabled = torch.autograd._profiler_enabled
_spans: list[Span] = []
_local = threading.local()        # .stack: this thread's open spans, innermost last
_request_ids = itertools.count(1)


class Span:
    """One span of the program while a profiler runs: ``name``, ``attrs``
    (ints and strings), ``start_ns`` and ``end_ns`` on the profiler's clock
    (nanoseconds since the Unix epoch, as kineto stamps its host events;
    ``end_ns`` is None while it is open), the span it opened inside
    (``parent``, None at the top) and ``request``, the id of the
    ``tts.request`` span it belongs to (None outside one)."""

    __slots__ = ("name", "attrs", "parent", "request", "start_ns", "end_ns", "_range")

    def __init__(self, name: str, attrs: dict):
        for key, value in attrs.items():
            if not isinstance(value, (int, str)):
                raise TypeError(f"span {name!r}: attr {key}={type(value).__name__}; a span "
                                "holds Python ints and strings, so it never reads the device")
        self.name, self.attrs, self.end_ns = name, attrs, None

    def __enter__(self) -> Span:
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.request = next(_request_ids) if self.name == REQUEST else \
            (self.parent.request if self.parent is not None else None)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        _spans.append(self)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _stack().remove(self)
        return False


_NO_SPAN = contextlib.nullcontext()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def span(name: str, **attrs):
    """A context manager around one piece of the program's work. With no
    profiler running it is one shared no-op (one check, nothing recorded).
    Under ``torch.profiler`` it is a ``record_function`` range, so the span
    shows in the profiler's trace among the ops and kernels, and a ``Span``
    appended to ``spans()``."""
    if not _profiler_enabled():
        return _NO_SPAN
    return Span(name, attrs)


def spans() -> list[Span]:
    """The spans recorded since the last ``trace()`` began, in start order."""
    return _spans


def request(fn):
    """Runs a public entry point inside a ``tts.request`` span, which gives
    the spans opened under it a new request id. A generator's request span
    lasts from its first resume to its exhaustion or close; between resumes
    it is no parent, so the caller's spans stay out of the request."""
    entry = fn.__qualname__
    if not inspect.isgeneratorfunction(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(REQUEST, entry=entry):
                return fn(*args, **kwargs)
        return call

    @functools.wraps(fn)
    def stream(*args, **kwargs):
        items = fn(*args, **kwargs)
        try:
            with span(REQUEST, entry=entry) as rec:
                for item in items:
                    if rec is None:
                        yield item
                        continue
                    _stack().remove(rec)
                    try:
                        yield item
                    finally:
                        _stack().append(rec)
        finally:
            items.close()
    return stream


class StageTimer:
    """Collects named stage timings; ``report()`` returns/prints a summary.
    A copy of ``tortoise_tpu/utils/profiling.py::StageTimer``; each stage is
    also the span ``tts.<stage>``."""

    def __init__(self):
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span("tts." + name):
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


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "tortoise_tpu_torch_trace")):
    """Record a ``torch.profiler`` trace of a block into ``log_dir`` (made if
    missing) and yield ``log_dir``, as ``tortoise_tpu/utils/profiling.py::
    trace`` does with ``jax.profiler``. Host ops always; CUDA kernels and
    copies too where torch sees a GPU. The file is written when the block
    ends, also when it raises. A profiler session slows the process's later
    kernel launches: take timings before a trace or in another process."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    _spans.clear()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()   # the block's kernels end inside the window


# kernel name fragment -> family, first match wins
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


def device_events(prof, window: str) -> list[dict]:
    """The CUDA device events of a finished ``torch.profiler`` session, each
    with ``name``, ``start_us`` and ``end_us``. Raises if there are none: a
    window that ran work on the card and recorded no device event is a
    profiler that saw nothing, not an idle card, and would read 0 busy ms."""
    events = [{"name": e.name, "start_us": e.time_range.start, "end_us": e.time_range.end}
              for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError(f"torch.profiler recorded no CUDA device event in {window}")
    return events


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
        res = device_breakdown(device_events(prof, f"the {preset} request"))
        res.update(wall_ms_profiled=wall_ms,
                   busy_share_of_wall=res["device_busy_ms"] / wall_ms,
                   stages_s=tts.last_stage_timings)
        out[preset] = res
    return out


# (batch, pos) of K2's profile: the fast path's, ultra_fast's, the fast
# request's last step
K2_SHAPES = ((1, 500), (16, 500), (96, 566))


def _k2_stack(L: int, C: int, g: torch.Generator) -> dict:
    rand = lambda *s, std=1.0: (torch.randn(s, generator=g, device="cuda") * std).bfloat16()
    bf = {"ln1": torch.stack([1 + rand(L, C, std=0.1), rand(L, C, std=0.1)], 1).contiguous(),
          "ln2": torch.stack([1 + rand(L, C, std=0.1), rand(L, C, std=0.1)], 1).contiguous()}
    for key, (n, k) in {"qkv": (3 * C, C), "proj": (C, C), "fc": (4 * C, C),
                        "fc2": (C, 4 * C)}.items():
        bf["w" + key], bf["b" + key] = rand(L, n, k, std=k ** -0.5), rand(L, n, std=0.02)
    return bf


def products_matmul(stacked: dict, xs: dict):
    """The step's dense products (4 a layer) as torch.matmul at K2's shapes,
    ``xs`` = {key: its (B, K) input}: the yardstick of K2's GEMM family.
    bf16 stack only."""
    for l in range(stacked["wqkv"].shape[0]):
        for key, x in xs.items():
            torch.matmul(x, stacked["w" + key][l].t())


K2_PHASES = ("qkv", "attention", "proj", "row_proj", "fc", "fc2", "row_fc2")


def k2_phases(run, layers: int) -> dict:
    """One K2 step (``run()``) with the kernel's stamps on: per phase kind,
    the mean over layers of the time from the last block past the barrier
    before it to the last block done with it ("critical_us"), of the
    barrier after it ("barrier_us"), and of a block's own work
    ("mean_block_us"); "step_us" from the first block's start to the last
    block's end. One launch (B <= 128)."""
    from tortoise_tpu_torch.ops import decode_step as ds

    blocks = ds._grid(torch.cuda.current_device())
    stamps = torch.zeros((1 + 7 * layers, blocks, 4), dtype=torch.int64, device="cuda")
    ds.fused_decode_step.trace = stamps
    try:
        run()
        torch.cuda.synchronize()
    finally:
        ds.fused_decode_step.trace = None
    t = stamps.double().cpu() / 1e3
    out = {k: {"critical_us": 0.0, "barrier_us": 0.0, "mean_block_us": 0.0} for k in K2_PHASES}
    for ph in range(1, t.shape[0]):
        row = out[K2_PHASES[(ph - 1) % 7]]
        start = t[ph - 1, :, 2]
        row["critical_us"] += (t[ph, :, 1].max() - start.max()).item() / layers
        row["mean_block_us"] += (t[ph, :, 1] - start).mean().item() / layers
        if ph + 1 < t.shape[0]:
            row["barrier_us"] += (t[ph, :, 2].max() - t[ph, :, 1].max()).item() / layers
    return {"step_us": (t[-1, :, 1].max() - t[0, :, 2].min()).item(), "by_phase": out}


def profile_k2_variants(steps: int = 10) -> dict:
    """Per-step times of each K2 variant on random full-width inputs."""
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch.ops.decode_step import (fused_decode_step, quantize_cache,
                                                    quantize_stack, variant)
    from tortoise_tpu_torch.utils.measure import STEP_SLEEP_CYCLES_PER_RUN, device_ms, time_ms

    L, C, H, T = 30, 1024, 16, 768
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = _k2_stack(L, C, g)
    stacks = (bf, quantize_stack(bf))
    out, runs = {}, []
    for b, pos in K2_SHAPES:
        bcache = {n: (torch.randn((L, b, T, C), generator=g, device="cuda")).bfloat16()
                  for n in ("k", "v")}
        x = torch.randn((b, C), generator=g, device="cuda").bfloat16()
        for cache in (bcache, quantize_cache(bcache, H)):
            for stacked in stacks:
                key = f"{variant(stacked, cache)} B={b}"
                runs.append((key, lambda s=stacked, c=cache, x=x, p=pos:
                             fused_decode_step(s, x, c, p, H)))
                out[key] = {"B": b, "pos": pos}
        xs = {"qkv": x, "proj": x, "fc": x, "fc2": x.new_zeros((b, 4 * C))}
        runs.append((f"cublas_products B={b}", lambda xs=xs: products_matmul(bf, xs)))
        out[runs[-1][0]] = {"B": b}
    # every event and device time first: a profiler pass slows the
    # process's later launches
    for key, run in runs:
        out[key].update(step_ms=time_ms(run, steps),
                        device_ms=device_ms(run, steps, STEP_SLEEP_CYCLES_PER_RUN))
    for key, run in runs:
        if key.startswith("bf16 "):
            out[key]["phases"] = k2_phases(run, L)
    for key, run in runs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
        res = device_breakdown(device_events(prof, f"{steps} K2 steps, {key}"))
        out[key].update({
            "device_busy_ms_per_step": res["device_busy_ms"] / steps,
            "ms_by_family_per_step": {k: v / steps for k, v in res["ms_by_family"].items()},
            "kernels_per_step": res["n_device_events"] / steps})
    return out


K4_HOPS = (8, 64, 256)
K4_FRAMES = 2186   # a 500-token clip: 2176 mel frames and UnivNet's 10 padding frames


def _timed(run, reps: int, cycles_per_run: int | None = None) -> dict:
    from tortoise_tpu_torch.utils.measure import SLEEP_CYCLES_PER_RUN, device_ms, time_ms

    return {"event_ms": time_ms(run, reps),
            "device_ms": device_ms(run, reps, cycles_per_run or SLEEP_CYCLES_PER_RUN)}


def profile_k4_k6(reps: int = 20) -> dict:
    """K4 per hop and layout, the layout copy, one UnivNet forward with and
    without it, and K6 per variant, each beside its library yardstick."""
    from tortoise_tpu_torch.models.vocoder import (UnivNetConfig, UnivNetGenerator,
                                                   location_variable_convolution,
                                                   random_predictor_output)
    from tortoise_tpu_torch.ops import lvc
    from tortoise_tpu_torch.tools import bench_attn_body as k6
    from tortoise_tpu_torch.utils.measure import bound, nbytes
    from tortoise_tpu_torch.weights import float32_device, init_random

    float32_device("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, f, ci, co, k, layers = 1, K4_FRAMES, 32, 64, 3, 4
    out = {"k4": {}, "k6": {}}
    voc = UnivNetGenerator(UnivNetConfig(use_kernel=True)).cuda().eval()
    init_random(voc, 3)
    with torch.inference_mode():
        for hop in K4_HOPS:
            x = torch.randn((b, ci, f * hop), generator=g, device="cuda").transpose(1, 2)
            kp, bp = random_predictor_output(g, b, layers, f, ci, co, k)
            kc, bc = kp.contiguous(), bp.contiguous()
            runs = {"blocks": lambda: lvc.location_variable_convolution_lvc(x, kc[:, 2], bc[:, 2],
                                                                           hop),
                    "einsum": lambda: location_variable_convolution(x, kc[:, 2], bc[:, 2], hop),
                    "predictor": lambda: lvc.location_variable_convolution_lvc(
                        x, kp[:, 2], bp[:, 2], hop)}
            want = lvc.location_variable_convolution_lvc_plain(x, kc[:, 2], bc[:, 2], hop)
            row = {"bound_ms": bound(nbytes(x, kc[:, 2], bc[:, 2], want),
                                     2 * b * f * hop * co * ci * k, "f32")}
            for name, run in runs.items():
                row[name] = {"max_rel_err": ((run() - want).abs().max()
                                             / want.abs().max()).item(), **_timed(run, reps)}
            out["k4"][f"hop={hop}"] = row
            if hop == K4_HOPS[0]:
                out["k4"]["copy_one_block"] = _timed(lambda: (kp.contiguous(), bp.contiguous()),
                                                     reps)
            del x, kp, bp, kc, bc, want

        mel = torch.randn((1, K4_FRAMES - 10, 100), generator=g, device="cuda")
        z = torch.randn((1, K4_FRAMES, voc.config.noise_dim), generator=g, device="cuda")
        forward = lambda: voc.inference(mel, z)
        # the forward's ~200 launches take the host milliseconds: ~10 ms of sleep a run
        out["univnet_forward"] = _timed(forward, 5, 20_000_000)
        preds = [getattr(voc, f"lvc_{i}").kernel_predictor for i in range(3)]
        for p in preds:
            p.forward = lambda c, _f=p.forward: tuple(t.contiguous() for t in _f(c))
        out["univnet_forward_with_copy"] = _timed(forward, 5, 20_000_000)
        for p in preds:
            del p.forward
        del voc, mel, z

        bt, t, c, pos, ck = 128, 768, 1024, 300, 64
        q, kk, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
                    for s in ((bt, c), (bt, t, c), (bt, t, c)))
        out["k6"]["bound_ms"] = bound(2 * bt * (pos + 1) * c * 2 + 2 * nbytes(q), 4 * bt *
                                      (pos + 1) * c, "f32")
        out["k6"]["sdpa"] = _timed(lambda: k6.sdpa(q, kk, v, pos), reps)
        for variant in k6.VARIANTS:
            run = lambda: k6.attn_body(q, kk, v, pos, ck=ck, variant=variant)
            want = k6.attn_body_plain(q, kk, v, pos, ck=ck, variant=variant)
            out["k6"][variant] = {"head_rel_err": k6.head_rel_err(run(), want),
                                  **_timed(run, reps)}
    return out


def train_batch(cfg, b: int, t_text: int, t_mel: int, device, seed: int) -> dict:
    """A seeded UnifiedVoice train batch of ``b`` rows, ``t_text`` text and
    ``t_mel`` mel tokens; the last row's wav_length pads the last quarter of
    its mel codes with the stop token."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.full((b,), t_mel * cfg.mel_length_compression, dtype=torch.long)
    lens[-1] = (t_mel * 3 // 4) * cfg.mel_length_compression
    batch = {"cond_latent": torch.randn((b, cfg.model_dim), generator=g),
             "text_tokens": torch.randint(1, cfg.number_text_tokens, (b, t_text), generator=g),
             "mel_codes": torch.randint(0, cfg.number_mel_codes - 2, (b, t_mel), generator=g),
             "wav_lengths": lens}
    return {k: v.to(device) for k, v in batch.items()}


def profile_train_step(dtype: torch.dtype | None = None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch import weights
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice
    from tortoise_tpu_torch.training import train_step as ts

    dev = weights.float32_device("cuda")
    model = UnifiedVoice(dtype=dtype).to(dev)
    weights.init_random(model, 0)
    shape = (4, 402, 604)
    batch = train_batch(model.config, *shape, dev, seed=5)
    opt = ts.make_optimizer()
    step = ts.make_train_step(model, opt)
    state = ts.init_train_state(model, opt)
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    events = device_events(prof, "one UnifiedVoice train step")
    res = device_breakdown(events)
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (e["end_us"] - e["start_us"]) / 1e3
    res.update(batch=list(shape), dtype=str(dtype or torch.float32), wall_ms_profiled=wall_ms,
               busy_share_of_wall=res["device_busy_ms"] / wall_ms,
               top_kernels_ms=sorted(by_name.items(), key=lambda kv: -kv[1])[:15])
    return res


def main() -> int:
    import subprocess

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.utils.audio import load_voice

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join("build", "profile.json"))
    what = parser.add_mutually_exclusive_group()
    what.add_argument("--k2", action="store_true",
                      help="profile K2's decode step per variant instead of requests")
    what.add_argument("--k4k6", action="store_true",
                      help="time K4 (per hop and layout, UnivNet's forward) and K6 instead")
    what.add_argument("--train", action="store_true",
                      help="profile one full-width UnifiedVoice train step instead")
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                        help="--train's compute dtype (the parameters stay float32)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling: torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    if args.k2:
        result = {"nvidia_smi": smi, **profile_k2_variants()}
    elif args.k4k6:
        result = {"nvidia_smi": smi, **profile_k4_k6()}
    elif args.train:
        result = {"nvidia_smi": smi, **profile_train_step(
            torch.bfloat16 if args.dtype == "bf16" else None)}
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
