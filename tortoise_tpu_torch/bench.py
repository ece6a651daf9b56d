"""Benchmark: single-sentence synthesis RTF on one GPU.

Port of the root ``bench.py`` (the JAX package's benchmark), flag for flag.
Headline metric = the reference's published fast-path number (reference
README.md:34: "0.25-0.3 RTF on a 4 GB GPU" for the fast/HiFi path):
wall-clock per second of generated audio for the full fast pipeline
(conditioning -> AR decode -> latent re-extraction -> HiFi-GAN), median of
N runs after a warm one.

Prints the JSON line {"metric", "value", "unit", "vs_baseline", "detail"}
REPEATEDLY: once as soon as the headline measurement exists, then again
after every section, so the last parseable line holds the most. A
wall-clock budget (``BENCH_BUDGET_S`` or ``--budget``, default 2200 s)
skips the sections whose cost no longer fits; skips are recorded in
``detail.sections_skipped``. A section that raises records
``detail.<name>_error`` and the run goes on.

Sections, in the JAX order: the quality ladder (ultra_fast / fast /
standard, reference api.py:320-331), the ``fast_int8_decode`` quality row,
high_quality over the int8 KV cache and the long-form loop of read.py on
the same instance, first audio of ``tts_stream`` (bf16 and int8_decode
weights) with the int8_decode fast path, 64-utterance ``tts_batch``, the
fused-step A/B rows, and 8-utterance ``tts_batch``. Each section is a
function of the instances it uses (``SECTIONS``); ``run_sections`` builds
them, runs the section and drops them before the next. Without a
checkpoint every model has seeded random weights, which never emit the
stop token: every request decodes ``--tokens`` tokens (the long-form
chunks their 500).

What differs from the JAX bench:
- dropped: the subprocess probe of the accelerator and the ``os._exit(0)``
  watchdog (a hang is not turned into exit 0); without CUDA the bench
  raises unless ``--device cpu`` is given, and never falls back to the CPU;
- dropped: ``enable_compilation_cache`` and ``latent_bucket`` (PyTorch runs
  eagerly and decodes at the exact length);
- changed: the section costs of the budget come from a run on the H100
  (``SECTIONS``), not from the TPU;
- changed: the fused-step rows mark as ``"default": true`` the setting the
  instance uses (K2 on, on CUDA), where the JAX ``tts_batch`` defaults it
  off: ``serving_64`` measures the default, ``fused_ab`` the other;
- added: ``--device`` (cuda, the default, or cpu for tests); per section
  on CUDA the memory still allocated after it (``memory_allocated_gb``)
  and its peak (``peak_memory_gb``); per quality row ``ar_batch`` and
  ``stages_s``.

    python3 -m tortoise_tpu_torch.bench [--smoke] [--runs N] [--tokens N]
        [--budget S] [--preset P | --fast-only] [--ladder-runs N]
        [--kv-cache bf16|int8] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import time
from typing import Callable

import torch

from tortoise_tpu_torch.presets import QUALITY_PRESETS
from tortoise_tpu_torch.utils import measure

REFERENCE_RTF = 0.25  # reference README.md:34 (best published)
# reference quality path: "a medium sized sentence every 2 minutes" on a K80
# (README.md:31-32); medium sentence ~= 8 s of audio -> RTF ~= 15
REFERENCE_QUALITY_RTF = 15.0
SENTENCE = ("Thanks for reading this article. I hope you found it informative "
            "and that it made you curious about the world of speech synthesis.")
LADDER = ("ultra_fast", "fast", "standard")
# long-form paragraph that splits into 2 chunks at (200, 300): the read.py
# chunk loop over clips of different lengths
PARAGRAPH = (
    "The field of speech synthesis has advanced remarkably over the past "
    "decade, moving from robotic concatenative systems to neural models that "
    "capture the rhythm and timbre of a human speaker. Autoregressive "
    "transformers first predict a sequence of acoustic tokens from text, "
    "conditioned on short reference clips of the target voice.")
FIRST_AUDIO_TEXT = "Thanks for asking, I would love to tell you more about that topic."
LONG_FORM_VOICE = "demo_alto"
SERVE_UTTERANCES = 64
SAMPLE_RATE = 24000


@dataclasses.dataclass(frozen=True)
class Runs:
    """Timed runs of each measurement, after its warm-up: the JAX bench's
    counts (``headline`` is ``--runs``, ``quality`` ``--ladder-runs``: every
    quality-preset row)."""
    headline: int = 5
    quality: int = 3
    long_form: int = 3
    first_audio: int = 5
    fast_int8_decode: int = 3
    serving_64: int = 2
    fused_ab: int = 2
    serving_8: int = 3


@dataclasses.dataclass
class Context:
    """What every section may read: the resident headline instance, its
    headline numbers, the device, the run counts, and ``emit``, which
    prints the line so far (a section calls it between its rows)."""
    tts: object                     # TextToSpeechFast
    device: str
    tokens: int
    runs: Runs
    headline_rtf: float = float("nan")
    headline_p50_s: float = float("nan")
    emit: Callable[[], None] = lambda: None


def _measure(fn, runs):
    """``fn(seed) -> (wall s, audio s)``: one warm call, then ``runs`` timed.
    Returns (median RTF, median wall, the first run's audio s)."""
    fn(0)
    results = [fn(i + 1) for i in range(runs)]
    rtf = statistics.median(w / a for w, a in results)
    walls = sorted(w for w, _ in results)
    return rtf, walls[len(walls) // 2], results[0][1]


def _audio_s(wav) -> float:
    return wav.shape[-1] / SAMPLE_RATE


def quality_runner(qtts, preset, tokens):
    """``fn(seed)`` for ``_measure``: one quality request of SENTENCE."""
    def run(seed):
        t0 = time.perf_counter()
        wav = qtts.tts_with_preset(SENTENCE, preset=preset, use_deterministic_seed=seed,
                                   max_mel_tokens=tokens, verbose=False)
        return time.perf_counter() - t0, _audio_s(wav)
    return run


def fast_runner(tts, tokens, **kwargs):
    """``fn(seed)`` for ``_measure``: one fast-path ``tts`` of SENTENCE."""
    def run(seed):
        t0 = time.perf_counter()
        wav = tts.tts(SENTENCE, use_deterministic_seed=seed, max_mel_tokens=tokens,
                      verbose=False, **kwargs)
        return time.perf_counter() - t0, _audio_s(wav)
    return run


def serve_runner(tts, n, tokens, **kwargs):
    """``fn(seed)`` for ``_measure``: ``tts_batch`` of n utterances; audio s summed."""
    texts = [f"{SENTENCE} Utterance number {i}." for i in range(n)]

    def run(seed):
        t0 = time.perf_counter()
        wavs = tts.tts_batch(texts, use_deterministic_seed=seed, max_mel_tokens=tokens,
                             verbose=False, **kwargs)
        return time.perf_counter() - t0, sum(_audio_s(w) for w in wavs)
    return run


def effective_candidates(qtts, preset) -> int:
    """Candidates actually sampled: the batch loop floors to whole
    micro-batches (reference api.py:407 parity quirk, warned at runtime),
    e.g. the 96-candidate `fast` preset samples 64 at a batch of 64.
    Recorded per row so the artifact states the measured work."""
    s = QUALITY_PRESETS[preset]["num_autoregressive_samples"]
    b = qtts.autoregressive_batch_size
    return max(1, s // b) * min(s, b)


def quality_row(qtts, preset, tokens, runs, **extra) -> dict:
    """The JAX bench's row of a quality preset, with ``ar_batch`` (the
    candidates decoded at once, which the batch picker takes from the free
    device memory) and ``stages_s`` (the last run's seconds by stage,
    ``TextToSpeech.last_stage_timings``)."""
    q_rtf, q_p50, q_audio = _measure(quality_runner(qtts, preset, tokens), runs)
    return {"rtf": round(q_rtf, 4), "p50_latency_s": round(q_p50, 3),
            "audio_s_per_run": round(q_audio, 2), **extra,
            "candidates": effective_candidates(qtts, preset),
            "ar_batch": qtts.autoregressive_batch_size,
            "vs_k80_baseline": round(REFERENCE_QUALITY_RTF / q_rtf, 2),
            "stages_s": {k: round(v, 3) for k, v in qtts.last_stage_timings.items()}}


def _long_form(qtts, n_runs=3):
    """read.py's long-form synthesis (reference read.py:55-85): split a
    paragraph into chunks, compute voice latents once, synthesize every
    chunk at high_quality, concatenate. RTF over the whole paragraph; the
    timed seeds are warmed once (each seed gives other clip lengths)."""
    from tortoise_tpu_torch.utils.audio import load_voices
    from tortoise_tpu_torch.utils.text import split_and_recombine_text

    chunks = split_and_recombine_text(PARAGRAPH, 200, 300)
    voice_samples, _ = load_voices([LONG_FORM_VOICE])
    latents = qtts.get_conditioning_latents(voice_samples)

    def run(seed):
        t0, audio_s = time.perf_counter(), 0.0
        for j, sentence in enumerate(chunks):
            wav = qtts.tts_with_preset(
                sentence, conditioning_latents=latents, preset="high_quality",
                use_deterministic_seed=seed * 131 + j, verbose=False)
            audio_s += _audio_s(wav)
        return time.perf_counter() - t0, audio_s

    for i in range(n_runs):
        run(i + 1)
    results = [run(i + 1) for i in range(n_runs)]
    rtfs = sorted(w / a for w, a in results)
    walls = sorted(w for w, _ in results)
    rtf = rtfs[len(rtfs) // 2]
    return {"rtf": round(rtf, 4), "rtf_min": round(rtfs[0], 4),
            "rtf_max": round(rtfs[-1], 4), "runs": n_runs,
            "p50_wall_s": round(walls[len(walls) // 2], 3),
            "audio_s_per_run": round(results[0][1], 2), "chunks": len(chunks),
            "preset": "high_quality", "kv_cache": "int8",
            "vs_k80_baseline": round(REFERENCE_QUALITY_RTF / rtf, 2)}


def _first_audio(tts, runs=5, first=16, chunk=40):
    """Streaming time to the first chunk (reference README.md:34 claims
    "< 500 ms"): prefill + ``first`` decode steps + one windowed HiFi-GAN
    decode, median over ``runs`` after a warm pass."""
    def one(seed):
        t0 = time.perf_counter()
        stream = tts.tts_stream(FIRST_AUDIO_TEXT, use_deterministic_seed=seed,
                                first_chunk_size=first, stream_chunk_size=chunk,
                                verbose=False)
        first_chunk = next(stream)
        lat = time.perf_counter() - t0
        for _ in stream:  # drain so the generator finishes cleanly
            pass
        return lat, len(first_chunk) / SAMPLE_RATE

    one(0)
    rows = [one(i + 1) for i in range(runs)]
    lats = sorted(r[0] for r in rows)
    return {"median_ms": round(lats[len(lats) // 2] * 1e3, 1),
            "min_ms": round(lats[0] * 1e3, 1),
            "first_chunk_audio_s": round(rows[0][1], 3),
            "first_chunk_tokens": first, "runs": runs}


# --- the sections: each fills ``detail`` from the context and its instances

def section_quality_ladder(detail, ctx: Context, qtts):
    """``TextToSpeech(half=True)`` at each preset of LADDER."""
    detail["quality_ladder"] = {p: quality_row(qtts, p, ctx.tokens, ctx.runs.quality)
                                for p in LADDER}
    detail["quality_ladder_runs"] = ctx.runs.quality


def section_fast_int8_decode(detail, ctx: Context, qtts):
    """Quality `fast` (96 candidates, 80 steps with CFG) with
    ``gpt_weights="int8_decode"``: exact bf16 prefill and re-extraction,
    int8 weights in the fused decode step only."""
    detail.setdefault("quality_ladder", {})["fast_int8_decode"] = quality_row(
        qtts, "fast", ctx.tokens, ctx.runs.quality, gpt_weights="int8_decode")


def section_long_form(detail, ctx: Context, qtts8):
    """The int8 KV cache at the most expensive preset (256 candidates, 400
    steps, reference api.py:328-331), then the long-form loop on the same
    instance."""
    detail.setdefault("quality_ladder", {})["high_quality_int8kv"] = quality_row(
        qtts8, "high_quality", ctx.tokens, ctx.runs.quality)
    ctx.emit()
    detail["long_form_high_quality"] = _long_form(qtts8, ctx.runs.long_form)


def section_first_audio(detail, ctx: Context, tts8d):
    """First audio of ``tts_stream`` with bf16 weights (the resident
    instance) and int8_decode ones, then the int8_decode fast path."""
    detail["first_audio_ms"] = {"bf16_weights": _first_audio(ctx.tts, ctx.runs.first_audio)}
    ctx.emit()
    detail["first_audio_ms"]["int8_decode"] = _first_audio(tts8d, ctx.runs.first_audio)
    q_rtf, q_p50, _ = _measure(fast_runner(tts8d, ctx.tokens), ctx.runs.fast_int8_decode)
    detail["fast_int8_decode"] = {"rtf": round(q_rtf, 4), "p50_latency_s": round(q_p50, 3)}


def section_serving_64(detail, ctx: Context):
    """SERVE_UTTERANCES concurrent utterances through one ``tts_batch``,
    the fused step at the instance's default; throughput = audio s / wall s."""
    s_rtf, s_p50, s_audio = _measure(serve_runner(ctx.tts, SERVE_UTTERANCES, ctx.tokens),
                                     ctx.runs.serving_64)
    detail["batched_serving"] = {
        "utterances": SERVE_UTTERANCES,
        "throughput_audio_s_per_s": round(1.0 / s_rtf, 2),
        "p50_wall_s": round(s_p50, 3),
        "audio_s_per_run": round(s_audio, 2),
        "gpt_fused_step": bool(ctx.tts.gpt_fused_step)}


def section_fused_ab(detail, ctx: Context):
    """The fused step's other setting beside the default's numbers: the fast
    path at B=1 (the default is the headline) and, after serving_64,
    ``tts_batch`` of SERVE_UTTERANCES (the default is batched_serving)."""
    default = bool(ctx.tts.gpt_fused_step)
    key = {True: "on", False: "off"}
    ab_rtf, ab_p50, _ = _measure(fast_runner(ctx.tts, ctx.tokens, gpt_fused_step=not default),
                                 ctx.runs.fused_ab)
    detail["fused_ab"] = {"fast_b1": {
        key[default]: {"rtf": round(ctx.headline_rtf, 4),
                       "p50_latency_s": round(ctx.headline_p50_s, 3), "default": True},
        key[not default]: {"rtf": round(ab_rtf, 4), "p50_latency_s": round(ab_p50, 3)}}}
    serving = detail.get("batched_serving")
    if serving is None:
        return
    ctx.emit()
    o_rtf, o_p50, _ = _measure(serve_runner(ctx.tts, SERVE_UTTERANCES, ctx.tokens,
                                            gpt_fused_step=not default), ctx.runs.fused_ab)
    detail["fused_ab"][f"batch{SERVE_UTTERANCES}"] = {
        key[default]: {"p50_wall_s": serving["p50_wall_s"],
                       "throughput_audio_s_per_s": serving["throughput_audio_s_per_s"],
                       "default": True},
        key[not default]: {"p50_wall_s": round(o_p50, 3),
                           "throughput_audio_s_per_s": round(1.0 / o_rtf, 2)}}


def section_serving_8(detail, ctx: Context):
    """Eight utterances through ``tts_batch``: the continuity row."""
    s_rtf, s_p50, s_audio = _measure(serve_runner(ctx.tts, 8, ctx.tokens), ctx.runs.serving_8)
    detail["batched_serving_8"] = {
        "utterances": 8,
        "throughput_audio_s_per_s": round(1.0 / s_rtf, 2),
        "p50_wall_s": round(s_p50, 3),
        "audio_s_per_run": round(s_audio, 2)}


def _quality(**kwargs):
    def build(ctx: Context):
        from tortoise_tpu_torch.api import TextToSpeech

        return (TextToSpeech(half=True, device=ctx.device, **kwargs),)
    return build


def _int8_decode_fast(ctx: Context):
    from tortoise_tpu_torch.api_fast import TextToSpeechFast

    return (TextToSpeechFast(dtype=torch.bfloat16, gpt_weights="int8_decode",
                             device=ctx.device),)


# (name, est_cost_s, build(ctx) -> the section's own instances, section).
# est_cost_s: the section's section_times_s in the first full run (every
# flag at its default) on an NVIDIA H100 80GB HBM3 at 700.00 W, instances'
# set-up included, rounded up (45.8, 11.8, 227.6, 12.3, 7.0, 21.4, 2.3 s);
# only the skip-when-over-budget decision reads it.
SECTIONS = (
    ("quality_ladder", 50, _quality(), section_quality_ladder),
    ("fast_int8_decode_preset", 15, _quality(gpt_weights="int8_decode"),
     section_fast_int8_decode),
    ("long_form", 230, _quality(kv_cache_dtype="int8"), section_long_form),
    ("first_audio", 15, _int8_decode_fast, section_first_audio),
    ("serving_64", 10, lambda ctx: (), section_serving_64),
    ("fused_ab", 25, lambda ctx: (), section_fused_ab),
    ("serving_8", 5, lambda ctx: (), section_serving_8),
)


def _free(device: str) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_section(detail, ctx: Context, name: str, build, section) -> None:
    """One section: its instances built, the section run, the instances
    dropped and the cache emptied before the next. A section that raises
    records ``<name>_error`` (the headline must survive). Records its
    seconds and, on CUDA, the memory left allocated and its peak."""
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        instances = build(ctx)
        section(detail, ctx, *instances)
    except Exception as e:  # keep the headline even if a section fails
        detail[f"{name}_error"] = f"{type(e).__name__}: {e}"
    instances = None
    _free(ctx.device)
    detail.setdefault("section_times_s", {})[name] = round(time.perf_counter() - t0, 1)
    if cuda:
        detail.setdefault("memory_allocated_gb", {})[name] = round(
            torch.cuda.memory_allocated() / 1e9, 3)
        detail.setdefault("peak_memory_gb", {})[name] = round(
            torch.cuda.max_memory_allocated() / 1e9, 3)


def run_sections(detail, ctx: Context, remaining=lambda: float("inf"),
                 sections=SECTIONS) -> None:
    """Every section in order, skipping those whose cost exceeds what
    ``remaining()`` reports; ``ctx.emit`` after each."""
    detail.setdefault("sections_skipped", [])
    detail.setdefault("section_times_s", {})
    for name, est_cost, build, section in sections:
        if remaining() < est_cost:
            detail["sections_skipped"].append(
                {"section": name, "est_cost_s": est_cost,
                 "budget_left_s": round(remaining(), 1)})
            continue
        run_section(detail, ctx, name, build, section)
        ctx.emit()


def measure_headline(ctx: Context, t_start: float) -> dict:
    """The headline: the fast path's RTF over ``ctx.runs.headline`` runs,
    kept in ``ctx``. Sets ``ctx.emit`` to print the line (``elapsed_s``
    counted from ``t_start``), prints it, and returns its detail."""
    ctx.headline_rtf, ctx.headline_p50_s, audio_s = _measure(fast_runner(ctx.tts, ctx.tokens),
                                                             ctx.runs.headline)
    detail = {
        "p50_latency_s": round(ctx.headline_p50_s, 3),
        "audio_s_per_run": round(audio_s, 2),
        "runs": ctx.runs.headline,
        "ar_tokens": ctx.tokens,
        "weights": ctx.tts.ar_source,
        "device": _device_name(ctx.device),
        "sections_skipped": [],
    }
    if torch.device(ctx.device).type == "cuda":
        detail["memory_allocated_gb"] = {"headline": round(torch.cuda.memory_allocated() / 1e9,
                                                           3)}

    def emit():
        detail["elapsed_s"] = round(time.perf_counter() - t_start, 1)
        _line("fast_preset_rtf", ctx.headline_rtf, REFERENCE_RTF, detail)

    ctx.emit = emit
    emit()  # the headline exists from here on, whatever happens after
    return detail


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny UnifiedVoice, 32 tokens (with --device cpu on the CPU)")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--tokens", type=int, default=200,
                    help="AR tokens per run (~46.4 ms of audio each)")
    ap.add_argument("--preset", default=None,
                    choices=["ultra_fast", "fast", "standard", "high_quality"],
                    help="bench ONLY the quality pipeline at this preset")
    ap.add_argument("--fast-only", action="store_true",
                    help="skip the quality-preset ladder")
    ap.add_argument("--ladder-runs", type=int, default=3,
                    help="timed runs per quality preset in the ladder")
    ap.add_argument("--kv-cache", default="bf16", choices=["bf16", "int8"],
                    help="KV cache dtype for --preset mode")
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("BENCH_BUDGET_S", "2200")),
                    help="wall-clock budget in seconds; optional sections are "
                         "skipped once the estimated cost no longer fits")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def _device_name(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    return measure.nvidia_smi() if torch.device(device).type == "cuda" else "cpu"


def _line(metric: str, value: float, baseline: float, detail: dict) -> dict:
    line = {"metric": metric, "value": round(value, 4), "unit": "wall_sec_per_audio_sec",
            "vs_baseline": round(baseline / value, 3), "detail": detail}
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> dict:
    """Runs the bench; prints its lines and returns the last line's detail."""
    args = build_parser().parse_args(argv)
    measure.cuda_device(args.device, "bench")
    t_start = time.perf_counter()

    def remaining():
        return args.budget - (time.perf_counter() - t_start)

    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig

    if args.preset is not None:
        from tortoise_tpu_torch.api import TextToSpeech

        qtts = TextToSpeech(half=not args.smoke, kv_cache_dtype=args.kv_cache,
                            device=args.device)
        rtf, p50, audio_s = _measure(quality_runner(qtts, args.preset, args.tokens), args.runs)
        detail = {"p50_latency_s": round(p50, 3), "audio_s_per_run": round(audio_s, 2),
                  "runs": args.runs, "ar_tokens": args.tokens, "kv_cache": args.kv_cache,
                  "candidates": effective_candidates(qtts, args.preset),
                  "weights": qtts.ar_source, "device": _device_name(args.device)}
        _line(f"quality_{args.preset}_rtf", rtf, REFERENCE_QUALITY_RTF, detail)
        return detail

    if args.smoke:
        cfg = UnifiedVoiceConfig(layers=2, model_dim=128, heads=4, max_text_tokens=120,
                                 max_mel_tokens=80)
        tokens = 32
        tts = TextToSpeechFast(dtype=torch.float32, ar_config=cfg, device=args.device)
    else:
        tokens = args.tokens
        tts = TextToSpeechFast(dtype=torch.bfloat16, device=args.device)
    ctx = Context(tts, args.device, tokens, Runs(headline=args.runs, quality=args.ladder_runs))
    detail = measure_headline(ctx, t_start)
    if args.smoke or args.fast_only:
        return detail
    run_sections(detail, ctx, remaining)
    ctx.emit()
    return detail


if __name__ == "__main__":
    main()
