#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tortoise_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing falls back):
  1. refuse to run without CUDA; print the card and its power limit;
  2. build the hand-written kernels from tortoise_tpu_torch/csrc with nvcc;
  3. K2 (whole GPT-2 decode step) against its plain PyTorch version at full
     width: L=30, C=1024, H=16, B in {1, 16}, pos in {0, 37, 500}, T=768;
  4. K3 (relative-position attention) against its plain version at B=2,
     H=16, D=64, T in {256, 2229}, per-row valid lengths below T;
  5. the full-width TextToSpeech (seeded random weights, voice
     train_dotrice): K2 at the fast request's shapes (96 candidates, a cache
     from a real prefill, the last decode position) layer by layer and whole,
     with planted one-row-off cache reads that the check must catch; one
     diffusion forward with and without K3; then three requests (ultra_fast,
     ultra_fast, fast with classifier-free guidance) with the kernels' launch
     counters reset just before them.

The last lines are the card's name and power limit, one JSON object with a
row per kernel, and {"ok": true, "device": {...}}. The full record also goes
to build/chip_smoke.json.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# K2: the hidden state and rows after 30 bf16 layers, against the plain
# version with the TPU kernel's rounding order. Both round at the same
# places but sum in different orders, so one-ulp bf16 flips compound over
# the layers: 0.05 x max|plain| (the JAX package bounds its 3-layer test of
# this kernel at 0.03, tests/test_fused_decode_step.py)
K2_REL_BOUND = 0.05
# K2 one layer at a time on the main path's shapes, each layer given the
# plain version's input, so nothing compounds: every (candidate, head)
# attention output relative to its own max|plain|, and every hidden row
# relative to its own max|plain|
K2_HEAD_REL_BOUND = 0.02
K2_ROW_REL_BOUND = 0.02
# K3: bf16 output of a softmax-weighted mean of O(1) values; the plain
# version rounds the weights to bf16, the kernel keeps them f32
K3_ABS_BOUND = 0.02
# fused vs unfused decode step / flash vs einsum diffusion forward at full
# width, bf16 model: relative to max|unfused|
MODEL_REL_BOUND = 0.05

# (preset, text, seed) of the three requests; the fast one decodes its
# preset's 96 candidates in one batch and runs classifier-free guidance
REQUESTS = [
    ("ultra_fast", "The quick brown fox jumps over the lazy dog.", 11),
    ("ultra_fast", "Tortoise is a text to speech program built with a focus on "
                   "multi-voice capabilities.", 12),
    ("fast", "This request runs classifier free guidance, so the diffusion "
             "batch holds two rows.", 13),
]
FAST_TEXT = REQUESTS[2][1]
FAST_CANDIDATES = 96


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one warm-up."""
    import torch

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


def check_decode_step(record: dict) -> dict:
    import torch

    from tortoise_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_plain

    L, C, H, T = 30, 1024, 16, 768
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, std=1.0, base=0.0):
        return (base + std * torch.randn(shape, generator=g, device="cuda")) \
            .to(torch.bfloat16).contiguous()

    stacked = {
        "ln1": torch.stack([rand(L, C, std=0.1, base=1.0), rand(L, C, std=0.1)], 1).contiguous(),
        "ln2": torch.stack([rand(L, C, std=0.1, base=1.0), rand(L, C, std=0.1)], 1).contiguous(),
        "wqkv": rand(L, 3 * C, C, std=C ** -0.5), "bqkv": rand(L, 3 * C, std=0.02),
        "wproj": rand(L, C, C, std=C ** -0.5), "bproj": rand(L, C, std=0.02),
        "wfc": rand(L, 4 * C, C, std=C ** -0.5), "bfc": rand(L, 4 * C, std=0.02),
        "wfc2": rand(L, C, 4 * C, std=(4 * C) ** -0.5), "bfc2": rand(L, C, std=0.02),
    }
    cases, worst = [], 0.0
    for b in (1, 16):
        cache = {"k": rand(L, b, T, C), "v": rand(L, b, T, C)}
        x = rand(b, C)
        for pos in (0, 37, 500):
            got = fused_decode_step(stacked, x, cache, pos, H)
            torch.cuda.synchronize()
            want = fused_decode_step_plain(stacked, x, cache, pos, H)
            errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
            bounds = [K2_REL_BOUND * w.float().abs().max().item() for w in want]
            case = {"B": b, "pos": pos, "err_hidden_rows": errs, "bound": bounds}
            cases.append(case)
            print(f"K2 B={b:2d} pos={pos:3d} max|err| hidden/k/v = "
                  f"{errs[0]:.4g}/{errs[1]:.4g}/{errs[2]:.4g}  bounds "
                  f"{bounds[0]:.4g}/{bounds[1]:.4g}/{bounds[2]:.4g}")
            if any(e > bd for e, bd in zip(errs, bounds)):
                raise AssertionError(f"K2 disagrees with its plain version: {case}")
            worst = max(worst, max(errs))
            if pos == 500:
                ms = _time_ms(lambda: fused_decode_step(stacked, x, cache, pos, H), 20)
                plain_ms = _time_ms(lambda: fused_decode_step_plain(stacked, x, cache, pos, H), 5)
                case.update(ms=ms, plain_ms=plain_ms)
                print(f"K2 B={b:2d} pos=500: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    record["k2"] = cases
    # ms and plain_ms come from check_decode_main_path
    return {"name": "fused_decode_step", "route": "cuda",
            "source": "tortoise_tpu_torch/csrc/decode_step.cu",
            "replaces": "tortoise_tpu/ops/decode_step_pallas.py:267", "max_abs_err": worst}


def check_flash_attention(record: dict) -> dict:
    import torch

    from tortoise_tpu_torch.ops.attn import flash_rel_attention, flash_rel_attention_plain

    B, H, D = 2, 16, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    cases, worst, timing = [], 0.0, None
    for t in (256, 2229):
        q, k, v = (torch.randn((B, H, t, D), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        bias = torch.randn((H, 2 * t - 1), generator=g, device="cuda").to(torch.bfloat16).float()
        valid = torch.tensor([t - 5, (3 * t) // 4], dtype=torch.int32, device="cuda")
        got = flash_rel_attention(q, k, v, bias, valid)
        torch.cuda.synchronize()
        want = flash_rel_attention_plain(q, k, v, bias, valid)
        err = max((got[b, :, :n] - want[b, :, :n]).float().abs().max().item()
                  for b, n in enumerate(valid.tolist()))
        ms = _time_ms(lambda: flash_rel_attention(q, k, v, bias, valid), 20)
        plain_ms = _time_ms(lambda: flash_rel_attention_plain(q, k, v, bias, valid), 5)
        cases.append({"T": t, "valid_len": valid.tolist(), "err": err, "bound": K3_ABS_BOUND,
                      "ms": ms, "plain_ms": plain_ms})
        print(f"K3 B={B} H={H} T={t} valid={valid.tolist()}: max|err| {err:.4g} "
              f"(bound {K3_ABS_BOUND}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if err > K3_ABS_BOUND:
            raise AssertionError(f"K3 disagrees with its plain version at T={t}: {err}")
        worst, timing = max(worst, err), (ms, plain_ms)
    record["k3"] = cases
    return {"name": "flash_rel_attention", "route": "cuda",
            "source": "tortoise_tpu_torch/csrc/flash_rel_attn.cu",
            "replaces": "tortoise_tpu/ops/attn_pallas.py:89",
            "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def _head_rel_err(got, want, heads: int) -> float:
    """Largest error over (batch row, head) of a (B, C) attention output,
    each relative to that head's max|want|."""
    b, c = want.shape
    g = got.float().reshape(b, heads, c // heads)
    w = want.float().reshape(b, heads, c // heads)
    err = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-6)
    return err.max().item()


def _row_rel_err(got, want) -> float:
    """Largest error over rows (the last dim) relative to that row's max|want|."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-6)).max().item()


def check_decode_main_path(tts, clips, record: dict) -> dict:
    """K2 at the fast request's shapes: 96 candidates, a cache filled by a
    real prefill of the request's prompt plus 498 teacher-forced mel tokens,
    padded to a multiple of 256 as the sampler pads it, and the last decode
    step's position. Layer by layer (each layer gets the plain version's
    input), every head's attention output is held to K2_HEAD_REL_BOUND; the
    same comparison against the plain version reading the cache one row
    short or long (pos -/+ 1) or one prefix row wrong must exceed it. Then the
    whole 30-layer step, per row, and the fused against the unfused sampler
    step."""
    import random

    import numpy as np
    import torch

    from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, _gpt_step
    from tortoise_tpu_torch.models.gpt2 import init_kv_cache
    from tortoise_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_plain

    ar, cfg = tts.autoregressive, tts.autoregressive.config
    heads, max_gen = cfg.heads, 500
    b = min(FAST_CANDIDATES, tts.autoregressive_batch_size)
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = np.pad(np.asarray(tts.tokenizer.encode(FAST_TEXT))[None], ((0, 0), (0, 1)))
    tb = -(-ids.shape[1] // tts.text_bucket) * tts.text_bucket
    text = torch.as_tensor(np.pad(ids, ((0, 0), (0, tb - ids.shape[1]))), device="cuda")
    stacked = tts._ar_stacked
    with torch.inference_mode():
        latent, _ = tts.get_conditioning_latents(clips, crop_rng=random.Random(0))
        prompt = ar.compute_prompt(latent, text).expand(b, -1, -1)
        p_len = prompt.shape[1]
        steps = max_gen - 2                      # the last step the sampler takes
        pos = p_len + steps
        t_cache = -(-(p_len + max_gen) // 256) * 256
        toks = torch.randint(0, cfg.start_mel_token, (b, steps + 1), generator=g, device="cuda")
        mel = torch.cat([ar.decode_embed(toks[:, s:s + 1], s) for s in range(steps)], dim=1)
        cache = init_kv_cache(cfg.gpt_config, b, t_cache, device="cuda")
        ar.gpt(torch.cat([prompt, mel], dim=1), cache=cache, cache_index=0)
        emb = ar.decode_embed(toks[:, steps:], steps)
        print(f"K2 main path: B={b} prompt {p_len} rows, cache T={t_cache}, pos={pos}")

        x = emb[:, 0].to(torch.bfloat16)
        r = p_len + steps // 2                   # the prefix row read wrongly
        attn_err, hidden_err = 0.0, 0.0
        planted = {"pos-1": 0.0, "pos+1": 0.0, "row": 0.0}
        for l in range(cfg.layers):
            st = {n: t_[l:l + 1] for n, t_ in stacked.items()}
            ca = {n: t_[l:l + 1] for n, t_ in cache.items()}
            got = fused_decode_step(st, x, ca, pos, heads, with_attention=True)
            want = fused_decode_step_plain(st, x, ca, pos, heads, with_attention=True)
            attn_err = max(attn_err, _head_rel_err(got[3], want[3], heads))
            hidden_err = max(hidden_err, _row_rel_err(got[0], want[0]))
            # the faults: one row short; one row long, that row holding the
            # step's own k/v as if written before the step; row r read as r + 1
            ahead = {n: t_.clone() for n, t_ in ca.items()}
            ahead["k"][0, :, pos], ahead["v"][0, :, pos] = got[1][0], got[2][0]
            wrong_row = {n: t_.clone() for n, t_ in ca.items()}
            for t_ in wrong_row.values():
                t_[0, :, r] = t_[0, :, r + 1]
            for name, p, c in (("pos-1", pos - 1, ca), ("pos+1", pos + 1, ahead),
                               ("row", pos, wrong_row)):
                wrong = fused_decode_step_plain(st, x, c, p, heads, with_attention=True)[3]
                planted[name] = max(planted[name], _head_rel_err(got[3], wrong, heads))
            x = want[0]
        print(f"K2 per layer, attention heads: max rel err {attn_err:.4g} (bound "
              f"{K2_HEAD_REL_BOUND}); hidden rows {hidden_err:.4g}; planted faults "
              + ", ".join(f"{k} {v:.4g}" for k, v in planted.items()))
        if attn_err > K2_HEAD_REL_BOUND:
            raise AssertionError(f"K2 attention disagrees with its plain version: {attn_err}")
        if hidden_err > K2_ROW_REL_BOUND:
            raise AssertionError(f"K2 layer output disagrees with its plain version: "
                                 f"{hidden_err}")
        if min(planted.values()) <= K2_HEAD_REL_BOUND:
            raise AssertionError(f"the attention check cannot see a planted cache fault: "
                                 f"{planted}")

        x = emb[:, 0].to(torch.bfloat16)
        got = fused_decode_step(stacked, x, cache, pos, heads)
        want = fused_decode_step_plain(stacked, x, cache, pos, heads)
        step_errs = [_row_rel_err(a, w) for a, w in zip(got, want)]
        print("K2 30 layers: max per-row rel err hidden/k/v = "
              + "/".join(f"{e:.4g}" for e in step_errs) + f" (bound {K2_REL_BOUND})")
        if max(step_errs) > K2_REL_BOUND:
            raise AssertionError(f"K2 disagrees with its plain version: {step_errs}")
        ms = _time_ms(lambda: fused_decode_step(stacked, x, cache, pos, heads), 20)
        plain_ms = _time_ms(lambda: fused_decode_step_plain(stacked, x, cache, pos, heads), 5)
        print(f"K2 B={b} pos={pos} T={t_cache}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

        # last: both sampler steps write the step's rows into the cache
        fused = _gpt_step(ar, SamplerSettings(fused_step=True), stacked, emb, cache, pos)
        plain = _gpt_step(ar, SamplerSettings(fused_step=False), None, emb, cache, pos)
        sampler_err = _row_rel_err(fused, plain)
        print(f"UnifiedVoice decode step, K2 vs layer stack: max per-row rel err "
              f"{sampler_err:.4g} (bound {MODEL_REL_BOUND})")
        if sampler_err > MODEL_REL_BOUND:
            raise AssertionError("K2 decode step disagrees with the layer stack")
    record["k2_main_path"] = {
        "B": b, "pos": pos, "T": t_cache, "attn_head_rel_err": attn_err,
        "layer_hidden_rel_err": hidden_err, "planted": planted,
        "step_row_rel_err": step_errs, "sampler_row_rel_err": sampler_err,
        "ms": ms, "plain_ms": plain_ms}
    return {"ms": ms, "plain_ms": plain_ms}


def check_diffusion(tts, record: dict) -> None:
    """The diffusion forward with K3 against the einsum attention, full width."""
    import torch

    dm = tts.diffusion
    g = torch.Generator(device="cuda").manual_seed(3)
    with torch.inference_mode():
        t, n = 320, 300
        x = torch.randn((2, t, 100), generator=g, device="cuda")
        pre = torch.randn((2, t, dm.config.model_channels), generator=g, device="cuda") \
            .to(tts.dtype)
        steps = torch.tensor([10, 900], device="cuda")
        valid = torch.tensor([n, n], device="cuda")
        biases = dm.rel_bias_vectors(t)
        out_flash = dm(x, steps, pre, valid_len=valid, rel_biases=biases, flash=True)
        out_plain = dm(x, steps, pre, valid_len=valid, rel_biases=biases, flash=False)
        err = (out_flash[:, :n] - out_plain[:, :n]).abs().max().item()
        bound = MODEL_REL_BOUND * out_plain[:, :n].abs().max().item()
        print(f"DiffusionTts forward, K3 vs einsum attention: max|err| {err:.4g} "
              f"(bound {bound:.4g})")
        if err > bound:
            raise AssertionError("K3 diffusion forward disagrees with the einsum path")
    record["diffusion_check"] = [err, bound]


def run_pipeline(tts, clips, record: dict) -> dict:
    import torch

    from tortoise_tpu_torch.ops.attn import flash_rel_attention
    from tortoise_tpu_torch.ops.decode_step import fused_decode_step

    counters = (fused_decode_step, flash_rel_attention)
    for fn in counters:
        fn.launches = 0
    results = []
    for preset, text, seed in REQUESTS:
        before = [fn.launches for fn in counters]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = tts.tts_with_preset(text, preset=preset, voice_samples=clips,
                                  use_deterministic_seed=seed, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = [fn.launches - b for fn, b in zip(counters, before)]
        ok = (wav.dtype == torch.float32 and wav.ndim == 3 and wav.shape[:2] == (1, 1)
              and wav.shape[2] > 0 and wav.shape[2] % 256 == 0
              and bool(torch.isfinite(wav).all()) and float(wav.abs().max()) <= 1.0)
        res = {"preset": preset, "text": text, "wall_s": wall,
               "audio_s": wav.shape[2] / 24000.0, "stages_s": tts.last_stage_timings,
               "k2_launches": grew[0], "k3_launches": grew[1], "finite_wav": ok,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "batch": tts.autoregressive_batch_size}
        results.append(res)
        print("request", json.dumps(res))
        if not ok:
            raise AssertionError(f"bad wav from {preset!r}: shape {tuple(wav.shape)}")
        if min(grew) <= 0:
            raise AssertionError(f"{preset!r} request did not launch both kernels: {grew}")
    record["requests"] = results
    return {"fused_decode_step": fused_decode_step.launches,
            "flash_rel_attention": flash_rel_attention.launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs only on the GPU")
    sys.path.insert(0, ROOT)
    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.ops import _build
    from tortoise_tpu_torch.utils.audio import load_voice

    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    record = {"device": kind, "nvidia_smi": smi}

    t0 = time.perf_counter()
    for name in ("decode_step", "flash_rel_attn"):
        _build.build(name)
    record["build_s"] = time.perf_counter() - t0
    print(f"built kernels in {record['build_s']:.1f} s")

    rows = [check_decode_step(record), check_flash_attention(record)]

    t0 = time.perf_counter()
    tts = TextToSpeech(device="cuda", enable_redaction=False)
    record["init_s"] = time.perf_counter() - t0
    print(f"TextToSpeech (full width, random weights) ready in {record['init_s']:.1f} s; "
          f"AR batch {tts.autoregressive_batch_size}")
    clips, _ = load_voice("train_dotrice")
    rows[0].update(check_decode_main_path(tts, clips, record))
    check_diffusion(tts, record)
    launches = run_pipeline(tts, clips, record)
    for row in rows:
        row["launches"] = launches[row["name"]]
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    record["kernels"] = rows

    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(json.dumps({"kernels": [{k: row[k] for k in ("name", "route", "source", "replaces",
                                                       "launches", "max_abs_err", "ms",
                                                       "plain_ms")} for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
