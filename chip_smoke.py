#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tortoise_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing falls back):
  1. refuse to run without CUDA; print the card and its power limit;
  2. build the hand-written kernels from tortoise_tpu_torch/csrc, one nvcc
     per source, all at once;
  3. K2 (whole GPT-2 decode step), each of its four variants (bf16 or int8
     weights x bf16 or int8 cache), against its plain PyTorch version at
     full width: L=30, C=1024, H=16, B in {1, 16}, pos in {0, 37, 500},
     T=768;
  4. K3 (relative-position attention) against its plain version at B=2,
     H=16, D=64, T in {256, 2229}, per-row valid lengths below T;
  5. the full-width TextToSpeech (seeded random weights, voice
     train_dotrice): K2 at the fast request's shapes (96 candidates, the
     last decode position) over a bf16 cache and over an int8 cache, each
     filled by a real prefill, layer by layer and whole, with planted
     faults the checks must catch (cache rows read one off; int8 scales
     read one position off); one diffusion forward with and without K3;
     then three requests (ultra_fast, ultra_fast, fast with
     classifier-free guidance);
  6. the fast path, TextToSpeechFast with bf16 and with int8_decode GPT
     weights: a warm-up tts and short stream, a timed tts, a tts_stream of
     the same text and seed (its codes equal tts's, its chunks equal the
     full decode of its own latents, its wav is near tts's), and on the
     bf16 instance a tts_batch of three texts with a random voice;
  7. one quality ultra_fast request with the int8 KV cache for each of
     gpt_weights "int8_decode" and "bf16", with the cache's bytes beside the
     bf16 cache's.
Before each path of phases 5-7 every launch counter is set to 0, and read
after it: the "launches" of the kernels line sum those runs only.

The last lines are the card's name and power limit, one JSON object with a
row per kernel and K2 variant, and {"ok": true, "device": {...}}. The full
record also goes to build/chip_smoke.json.
"""
from __future__ import annotations

import concurrent.futures
import gc
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
# the layers: 0.05 x max|plain| of each row (the JAX package bounds its
# 3-layer test of this kernel at 0.03, tests/test_fused_decode_step.py)
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
# width, bf16 model: relative to max|unfused|. With the int8 cache the
# fused step attends to its own row unquantized and the layer stack to the
# quantized row, a difference of at most that row's quantization error
MODEL_REL_BOUND = 0.05
# tts_stream's chunks against one full-length HiFi-GAN decode of the same
# latents: float32 convolutions over other lengths, so other cuDNN
# algorithms and summation orders; the wav is in [-1, 1]
STREAM_ABS_BOUND = 1e-3
# tts_stream's wav against tts's, same codes: the stream decodes the
# sampler's own latents (K2's steps over a bf16 cache), tts re-extracts them
# teacher-forced (the bf16 layer stack); those differ by ~2.6% per row
# (the sampler-step check of phase 5), which the random-weight HiFi-GAN
# carries into the wav. Relative L2 over the clip
STREAM_TTS_REL_L2_BOUND = 0.25

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
# the fast/streaming requests (text, seed) and tts_batch's texts
STREAM_REQUEST = ("The quick brown fox jumps over the lazy dog.", 21)
BATCH_TEXTS = ["One sentence of a batch.", "A second, longer sentence of the same batch.",
               "And a third."]
K2_VARIANTS = ("bf16", "int8_weights", "int8_cache", "int8_weights_int8_cache")
K2_SOURCE = "tortoise_tpu_torch/csrc/decode_step.cu"
K2_REPLACES = "tortoise_tpu/ops/decode_step_pallas.py:267"


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


def _k2_row_name(variant: str) -> str:
    return "fused_decode_step" if variant == "bf16" else f"fused_decode_step[{variant}]"


def check_decode_step(record: dict) -> dict:
    """Every K2 variant against its plain version on synthetic inputs at full
    width. Returns {variant: kernel row} with the worst abs error and, at
    pos=500, the times at B=1 (the fast path's batch)."""
    import torch

    from tortoise_tpu_torch.ops.decode_step import (fused_decode_step,
                                                    fused_decode_step_plain, quantize_cache,
                                                    quantize_stack, variant)

    L, C, H, T = 30, 1024, 16, 768
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, std=1.0, base=0.0):
        return (base + std * torch.randn(shape, generator=g, device="cuda")) \
            .to(torch.bfloat16).contiguous()

    bf16_stack = {
        "ln1": torch.stack([rand(L, C, std=0.1, base=1.0), rand(L, C, std=0.1)], 1).contiguous(),
        "ln2": torch.stack([rand(L, C, std=0.1, base=1.0), rand(L, C, std=0.1)], 1).contiguous(),
        "wqkv": rand(L, 3 * C, C, std=C ** -0.5), "bqkv": rand(L, 3 * C, std=0.02),
        "wproj": rand(L, C, C, std=C ** -0.5), "bproj": rand(L, C, std=0.02),
        "wfc": rand(L, 4 * C, C, std=C ** -0.5), "bfc": rand(L, 4 * C, std=0.02),
        "wfc2": rand(L, C, 4 * C, std=(4 * C) ** -0.5), "bfc2": rand(L, C, std=0.02),
    }
    stacks = {"bf16": bf16_stack, "int8": quantize_stack(bf16_stack)}
    rows = {v: {"name": _k2_row_name(v), "route": "cuda", "source": K2_SOURCE,
                "replaces": K2_REPLACES, "max_abs_err": 0.0} for v in K2_VARIANTS}
    cases = []
    for b in (1, 16):
        bf16_cache = {"k": rand(L, b, T, C), "v": rand(L, b, T, C)}
        caches = {"bf16": bf16_cache, "int8": quantize_cache(bf16_cache, H)}
        x = rand(b, C)
        for wname, stacked in stacks.items():
            for cname, cache in caches.items():
                var = variant(stacked, cache)
                for pos in (0, 37, 500):
                    got = fused_decode_step(stacked, x, cache, pos, H)
                    torch.cuda.synchronize()
                    want = fused_decode_step_plain(stacked, x, cache, pos, H)
                    errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
                    rel = [_row_rel_err(a, w) for a, w in zip(got, want)]
                    case = {"variant": var, "B": b, "pos": pos, "abs_err_hidden_k_v": errs,
                            "row_rel_err_hidden_k_v": rel, "bound": K2_REL_BOUND}
                    cases.append(case)
                    print(f"K2 {var:24s} B={b:2d} pos={pos:3d} max|err| hidden/k/v "
                          f"{errs[0]:.4g}/{errs[1]:.4g}/{errs[2]:.4g}, per-row rel "
                          f"{rel[0]:.4g}/{rel[1]:.4g}/{rel[2]:.4g} (bound {K2_REL_BOUND})")
                    if max(rel) > K2_REL_BOUND:
                        raise AssertionError(f"K2 disagrees with its plain version: {case}")
                    rows[var]["max_abs_err"] = max(rows[var]["max_abs_err"], max(errs))
                    if pos == 500:
                        ms = _time_ms(lambda: fused_decode_step(stacked, x, cache, pos, H), 20)
                        plain_ms = _time_ms(
                            lambda: fused_decode_step_plain(stacked, x, cache, pos, H), 5)
                        case.update(ms=ms, plain_ms=plain_ms)
                        print(f"K2 {var:24s} B={b:2d} pos=500: kernel {ms:.3f} ms, "
                              f"plain {plain_ms:.3f} ms")
                        if b == 1:
                            rows[var].update(ms=ms, plain_ms=plain_ms, timed_at="B=1 pos=500")
    record["k2"] = cases
    return rows


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


def _prefilled_main_path(tts, clips, cache_dtype):
    """The fast request's last decode step: 96 candidates, a cache of
    ``cache_dtype`` filled by a real prefill of the request's prompt plus
    498 teacher-forced mel tokens through the layer stack (which quantizes
    the rows into an int8 cache), padded to a multiple of 256 as the sampler
    pads it. Returns (cache, the step's embedding (B, 1, C), pos, prompt rows)."""
    import random

    import numpy as np
    import torch

    from tortoise_tpu_torch.models.gpt2 import init_kv_cache

    ar, cfg = tts.autoregressive, tts.autoregressive.config
    max_gen = 500
    b = min(FAST_CANDIDATES, tts.autoregressive_batch_size)
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = np.pad(np.asarray(tts.tokenizer.encode(FAST_TEXT))[None], ((0, 0), (0, 1)))
    tb = -(-ids.shape[1] // tts.text_bucket) * tts.text_bucket
    text = torch.as_tensor(np.pad(ids, ((0, 0), (0, tb - ids.shape[1]))), device="cuda")
    latent, _ = tts.get_conditioning_latents(clips, crop_rng=random.Random(0))
    prompt = ar.compute_prompt(latent, text).expand(b, -1, -1)
    p_len = prompt.shape[1]
    steps = max_gen - 2                      # the last step the sampler takes
    pos = p_len + steps
    t_cache = -(-(p_len + max_gen) // 256) * 256
    toks = torch.randint(0, cfg.start_mel_token, (b, steps + 1), generator=g, device="cuda")
    mel = torch.cat([ar.decode_embed(toks[:, s:s + 1], s) for s in range(steps)], dim=1)
    cache = init_kv_cache(cfg.gpt_config, b, t_cache, dtype=cache_dtype, device="cuda")
    ar.gpt(torch.cat([prompt, mel], dim=1), cache=cache, cache_index=0)
    print(f"K2 main path: B={b} prompt {p_len} rows, {cache['k'].dtype} cache T={t_cache}, "
          f"pos={pos}")
    return cache, ar.decode_embed(toks[:, steps:], steps), pos, p_len


def _layerwise(stacked, cache, x, pos, heads, layers, faults):
    """K2 one layer at a time against the plain version, each layer given the
    plain version's input. ``faults``: {name: fn(layer cache, kernel output)
    -> (faulty layer cache, pos)} read by the plain version, whose attention
    must move past the bound. Returns (attention head rel err, hidden row rel
    err, {fault: head rel err})."""
    from tortoise_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_plain

    attn_err, hidden_err = 0.0, 0.0
    planted = dict.fromkeys(faults, 0.0)
    for l in range(layers):
        st = {n: t_[l:l + 1] for n, t_ in stacked.items()}
        ca = {n: t_[l:l + 1] for n, t_ in cache.items()}
        got = fused_decode_step(st, x, ca, pos, heads, with_attention=True)
        want = fused_decode_step_plain(st, x, ca, pos, heads, with_attention=True)
        attn_err = max(attn_err, _head_rel_err(got[3], want[3], heads))
        hidden_err = max(hidden_err, _row_rel_err(got[0], want[0]))
        for name, fault in faults.items():
            bad, p = fault(ca, got)
            wrong = fused_decode_step_plain(st, x, bad, p, heads, with_attention=True)[3]
            planted[name] = max(planted[name], _head_rel_err(got[3], wrong, heads))
        x = want[0]
    return attn_err, hidden_err, planted


def _check_layerwise(what, attn_err, hidden_err, planted):
    print(f"K2 per layer ({what}), attention heads: max rel err {attn_err:.4g} (bound "
          f"{K2_HEAD_REL_BOUND}); hidden rows {hidden_err:.4g}; planted faults "
          + ", ".join(f"{k} {v:.4g}" for k, v in planted.items()))
    if attn_err > K2_HEAD_REL_BOUND:
        raise AssertionError(f"K2 attention disagrees with its plain version ({what}): "
                             f"{attn_err}")
    if hidden_err > K2_ROW_REL_BOUND:
        raise AssertionError(f"K2 layer output disagrees with its plain version ({what}): "
                             f"{hidden_err}")
    if min(planted.values()) <= K2_HEAD_REL_BOUND:
        raise AssertionError(f"the attention check cannot see a planted cache fault ({what}): "
                             f"{planted}")


def _whole_step(stacked, cache, x, pos, heads, what):
    """The whole 30-layer step against the plain version per row; both timed."""
    from tortoise_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_plain

    got = fused_decode_step(stacked, x, cache, pos, heads)
    want = fused_decode_step_plain(stacked, x, cache, pos, heads)
    errs = [_row_rel_err(a, w) for a, w in zip(got, want)]
    abs_err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
    print(f"K2 30 layers ({what}): max per-row rel err hidden/k/v = "
          + "/".join(f"{e:.4g}" for e in errs) + f" (bound {K2_REL_BOUND})")
    if max(errs) > K2_REL_BOUND:
        raise AssertionError(f"K2 disagrees with its plain version ({what}): {errs}")
    ms = _time_ms(lambda: fused_decode_step(stacked, x, cache, pos, heads), 20)
    plain_ms = _time_ms(lambda: fused_decode_step_plain(stacked, x, cache, pos, heads), 5)
    b, t = cache["k"].shape[1], cache["k"].shape[2]
    print(f"K2 ({what}) B={b} pos={pos} T={t}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"row_rel_err": errs, "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}


def _sampler_step(tts, stacked, emb, cache, pos, what):
    """The sampler's K2 step against its layer-stack step (each writes the
    step's rows into the cache)."""
    from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, _gpt_step

    ar = tts.autoregressive
    fused = _gpt_step(ar, SamplerSettings(fused_step=True), stacked, emb, cache, pos)
    plain = _gpt_step(ar, SamplerSettings(fused_step=False), None, emb, cache, pos)
    err = _row_rel_err(fused, plain)
    print(f"UnifiedVoice decode step ({what}), K2 vs layer stack: max per-row rel err "
          f"{err:.4g} (bound {MODEL_REL_BOUND})")
    if err > MODEL_REL_BOUND:
        raise AssertionError(f"K2 decode step disagrees with the layer stack ({what})")
    return err


def check_decode_main_path(tts, clips, record: dict) -> dict:
    """K2 over a bf16 cache at the fast request's shapes. Layer by layer,
    every head's attention output is held to K2_HEAD_REL_BOUND; the same
    comparison against the plain version reading the cache one row short or
    long (pos -/+ 1) or one prefix row wrong must exceed it. Then the whole
    30-layer step, per row, and the fused against the unfused sampler step."""
    import torch

    heads, layers = tts.autoregressive.config.heads, tts.autoregressive.config.layers
    stacked = tts._ar_stacked
    with torch.inference_mode():
        cache, emb, pos, p_len = _prefilled_main_path(tts, clips, torch.bfloat16)
        r = p_len + (pos - p_len) // 2           # the prefix row read wrongly

        def ahead(ca, got):      # one row long, that row holding the step's own k/v
            c = {n: t_.clone() for n, t_ in ca.items()}
            c["k"][0, :, pos], c["v"][0, :, pos] = got[1][0], got[2][0]
            return c, pos + 1

        def wrong_row(ca, got):  # row r read as r + 1
            c = {n: t_.clone() for n, t_ in ca.items()}
            for t_ in c.values():
                t_[0, :, r] = t_[0, :, r + 1]
            return c, pos

        faults = {"pos-1": lambda ca, got: (ca, pos - 1), "pos+1": ahead, "row": wrong_row}
        attn_err, hidden_err, planted = _layerwise(stacked, cache, emb[:, 0].to(torch.bfloat16),
                                                   pos, heads, layers, faults)
        _check_layerwise("bf16 cache", attn_err, hidden_err, planted)
        whole = _whole_step(stacked, cache, emb[:, 0].to(torch.bfloat16), pos, heads,
                            "bf16 cache")
        sampler_err = _sampler_step(tts, stacked, emb, cache, pos, "bf16 cache")
    record["k2_main_path"] = {
        "B": cache["k"].shape[1], "pos": pos, "T": cache["k"].shape[2],
        "attn_head_rel_err": attn_err, "layer_hidden_rel_err": hidden_err,
        "planted": planted, "step": whole, "sampler_row_rel_err": sampler_err}
    return {"ms": whole["ms"], "plain_ms": whole["plain_ms"], "timed_at": "B=96 pos=566"}


def check_decode_main_path_int8(tts, clips, record: dict) -> dict:
    """K2 over an int8 cache at the fast request's shapes, the cache filled
    by a real prefill through the layer stack. Layer by layer (bf16
    weights), every head held to K2_HEAD_REL_BOUND; the plain version
    reading every k scale one position off (ks[t + 1] for ks[t]), or one
    prefix k row as its neighbour, must exceed it. Then the whole step of
    both int8-cache variants, per row, and the sampler's K2 step against
    its layer stack. Returns {variant: timing}."""
    import torch

    from tortoise_tpu_torch.ops.decode_step import quantize_stack

    heads, layers = tts.autoregressive.config.heads, tts.autoregressive.config.layers
    stacked = tts._ar_stacked
    out = {}
    with torch.inference_mode():
        cache, emb, pos, p_len = _prefilled_main_path(tts, clips, torch.int8)
        r = p_len + (pos - p_len) // 2
        x = emb[:, 0].to(torch.bfloat16)

        def scale_shift(ca, got):
            c = dict(ca)
            c["k_scale"] = torch.cat([ca["k_scale"][..., 1:], ca["k_scale"][..., -1:]], -1)
            return c, pos

        def k_row(ca, got):
            c = dict(ca)
            c["k"] = ca["k"].clone()
            c["k"][0, :, r] = ca["k"][0, :, r + 1]
            return c, pos

        attn_err, hidden_err, planted = _layerwise(
            stacked, cache, x, pos, heads, layers, {"k_scale[t+1]": scale_shift, "k row": k_row})
        _check_layerwise("int8 cache", attn_err, hidden_err, planted)
        steps = {}
        for var, st in (("int8_cache", stacked), ("int8_weights_int8_cache",
                                                  quantize_stack(stacked))):
            steps[var] = _whole_step(st, cache, x, pos, heads, var)
            out[var] = {"ms": steps[var]["ms"], "plain_ms": steps[var]["plain_ms"],
                        "timed_at": "B=96 pos=566"}
        sampler_err = _sampler_step(tts, stacked, emb, cache, pos, "int8 cache")
    record["k2_main_path_int8_cache"] = {
        "B": cache["k"].shape[1], "pos": pos, "T": cache["k"].shape[2],
        "attn_head_rel_err": attn_err, "layer_hidden_rel_err": hidden_err,
        "planted": planted, "steps": steps, "sampler_row_rel_err": sampler_err}
    return out


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


class Launches:
    """Every kernel wrapper's launch counter: ``reset`` sets all to 0 before
    a path runs, ``read`` returns them after it, ``total`` sums the runs."""

    def __init__(self):
        from tortoise_tpu_torch.ops.attn import flash_rel_attention
        from tortoise_tpu_torch.ops.decode_step import fused_decode_step

        self.k2, self.k3 = fused_decode_step, flash_rel_attention
        self.total = {_k2_row_name(v): 0 for v in K2_VARIANTS}
        self.total["flash_rel_attention"] = 0

    def reset(self):
        self.k2.launches = 0
        self.k2.launches_by_variant.update(dict.fromkeys(self.k2.launches_by_variant, 0))
        self.k3.launches = 0

    def read(self) -> dict:
        counts = {_k2_row_name(v): n for v, n in self.k2.launches_by_variant.items()}
        counts["flash_rel_attention"] = self.k3.launches
        return counts

    def add(self, counts: dict):
        for k, n in counts.items():
            self.total[k] += n


def _wav_ok(wav) -> bool:
    import torch

    return (wav.dtype == torch.float32 and wav.ndim == 3 and wav.shape[:2] == (1, 1)
            and wav.shape[2] > 0 and wav.shape[2] % 256 == 0
            and bool(torch.isfinite(wav).all()) and float(wav.abs().max()) <= 1.0)


def _quality_request(tts, clips, preset, text, seed, launches: Launches) -> dict:
    import torch

    before = launches.read()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = tts.tts_with_preset(text, preset=preset, voice_samples=clips,
                              use_deterministic_seed=seed, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = {k: n - before[k] for k, n in launches.read().items() if n > before[k]}
    ok = _wav_ok(wav)
    res = {"preset": preset, "text": text, "wall_s": wall, "audio_s": wav.shape[2] / 24000.0,
           "stages_s": tts.last_stage_timings, "launches": grew, "finite_wav": ok,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "batch": tts.autoregressive_batch_size}
    print("request", json.dumps(res))
    if not ok:
        raise AssertionError(f"bad wav from {preset!r}: shape {tuple(wav.shape)}")
    return res


def run_pipeline(tts, clips, record: dict, launches: Launches) -> None:
    """The three quality requests, bf16 cache and weights."""
    launches.reset()
    results = []
    for preset, text, seed in REQUESTS:
        res = _quality_request(tts, clips, preset, text, seed, launches)
        if {"fused_decode_step", "flash_rel_attention"} - set(res["launches"]):
            raise AssertionError(f"{preset!r} request did not launch both kernels: "
                                 f"{res['launches']}")
        results.append(res)
    launches.add(launches.read())
    record["requests"] = results


def _stream_against_own_latents(tts, clips, text, seed):
    """The stream's latents, reproduced with stream_speech from the same
    seed (same kernels, same draws), decoded in one full-length HiFi-GAN
    call: the wav the stream's chunks must equal."""
    import torch

    from tortoise_tpu_torch.models import ar_sampler

    with torch.inference_mode():
        _, text_t, cond = tts._prepare(text, clips, None, seed)
        settings = tts._settings(500, tts._fused(None), True)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for codes, latents in ar_sampler.stream_speech(
                tts.autoregressive, cond, text_t, gen, settings, seg_len=40, first_seg_len=16,
                stacked=tts._ar_stacked):
            pass
        n = tts._trim_codes(codes[0].cpu().numpy())
        return tts._decode(latents.float(), n, cond)[0, 0]


def run_fast_path(clips, record: dict, launches: Launches) -> dict:
    """TextToSpeechFast with bf16 and with int8_decode GPT weights: a
    warm-up tts, a timed tts, a tts_stream of the same text and seed, and
    (bf16) a tts_batch of three texts with a random voice. Each request must
    grow its K2 variant's counter."""
    import numpy as np
    import torch

    from tortoise_tpu_torch.api_fast import TextToSpeechFast

    text, seed = STREAM_REQUEST
    out = []
    for gw, var in (("bf16", "bf16"), ("int8_decode", "int8_weights")):
        name = _k2_row_name(var)
        t0 = time.perf_counter()
        tts = TextToSpeechFast(device="cuda", gpt_weights=gw)
        init_s = time.perf_counter() - t0
        res = {"gpt_weights": gw, "init_s": init_s}
        launches.reset()

        def grew_by(before):
            n = launches.read()[name] - before
            if n <= 0:
                raise AssertionError(f"fast path ({gw}): a request launched no {name}")
            return n

        before = launches.read()[name]
        tts.tts(text, voice_samples=clips, use_deterministic_seed=seed + 1, verbose=False)
        res["warmup_launches"] = grew_by(before)
        # a short stream as well: the window decode's first cuDNN calls
        # would otherwise land in the timed stream's first chunk
        before = launches.read()[name]
        list(tts.tts_stream(text, voice_samples=clips, use_deterministic_seed=seed + 1,
                            max_mel_tokens=24, verbose=False))
        res["warmup_stream_launches"] = grew_by(before)

        before = launches.read()[name]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = tts.tts(text, voice_samples=clips, use_deterministic_seed=seed, verbose=False)
        wall = time.perf_counter() - t0
        tts_codes = tts.last_codes
        if not _wav_ok(wav):
            raise AssertionError(f"fast path ({gw}): bad tts wav {tuple(wav.shape)}")
        res["tts"] = {"wall_s": wall, "audio_s": wav.shape[2] / 24000.0,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "codes": len(tts_codes), "launches": grew_by(before)}

        before = launches.read()[name]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        chunks, first_s = [], None
        t0 = time.perf_counter()
        for chunk in tts.tts_stream(text, voice_samples=clips, use_deterministic_seed=seed,
                                    verbose=False):
            if first_s is None:
                first_s = time.perf_counter() - t0
            chunks.append(chunk)
        total_s = time.perf_counter() - t0
        stream = torch.cat(chunks)
        same_codes = bool(np.array_equal(tts.last_codes, tts_codes))
        res["stream"] = {"first_chunk_s": first_s, "total_s": total_s, "chunks": len(chunks),
                         "audio_s": stream.shape[0] / 24000.0,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "codes_equal_tts": same_codes, "launches": grew_by(before)}
        if not same_codes or stream.shape[0] != wav.shape[2] or not torch.isfinite(stream).all():
            raise AssertionError(f"fast path ({gw}): the stream's codes or length differ from "
                                 f"tts's: {res['stream']}, tts {wav.shape[2]} samples")

        if gw == "bf16":
            before = launches.read()[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wavs = tts.tts_batch(BATCH_TEXTS, use_deterministic_seed=seed, verbose=False)
            wall_b = time.perf_counter() - t0
            if len(wavs) != len(BATCH_TEXTS) or not all(_wav_ok(w) for w in wavs):
                raise AssertionError("fast path: bad tts_batch wavs")
            res["tts_batch"] = {"wall_s": wall_b, "texts": len(wavs),
                                "audio_s": [w.shape[2] / 24000.0 for w in wavs],
                                "launches": grew_by(before)}
        counts = launches.read()
        launches.add(counts)
        res["path_launches"] = counts

        # outside the counted run: the stream's chunks against the full
        # decode of its own latents, and against tts's (teacher-forced) wav
        full = _stream_against_own_latents(tts, clips, text, seed)
        res["stream"]["max_abs_err_vs_own_full_decode"] = (stream - full).abs().max().item()
        diff = stream - wav[0, 0]
        res["stream"]["vs_tts_wav"] = {"max_abs_err": diff.abs().max().item(),
                                       "rel_l2": (diff.norm() / wav.norm()).item()}
        print("fast path", json.dumps(res))
        if res["stream"]["max_abs_err_vs_own_full_decode"] > STREAM_ABS_BOUND:
            raise AssertionError(f"fast path ({gw}): the stream's chunks are not slices of the "
                                 f"full decode: {res['stream']}")
        if res["stream"]["vs_tts_wav"]["rel_l2"] > STREAM_TTS_REL_L2_BOUND:
            raise AssertionError(f"fast path ({gw}): the stream's wav is far from tts's: "
                                 f"{res['stream']}")
        out.append(res)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
    record["fast_path"] = out


def _prompt_rows(tts, text) -> int:
    """Rows of the decode prompt of ``text``: [cond | start, text, stop pad,
    bucket, stop | start_mel]."""
    ids = len(tts.tokenizer.encode(text)) + 1
    return 1 + -(-ids // tts.text_bucket) * tts.text_bucket + 2 + 1


def run_quality_int8(clips, record: dict, launches: Launches) -> None:
    """One ultra_fast request with the int8 KV cache per gpt_weights, and the
    bytes of the request's cache beside a bf16 cache of the same shape."""
    import torch

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.models.gpt2 import init_kv_cache

    preset, text, seed = REQUESTS[0]
    out = []
    for gw, var in (("int8_decode", "int8_weights_int8_cache"), ("bf16", "int8_cache")):
        t0 = time.perf_counter()
        tts = TextToSpeech(device="cuda", enable_redaction=False, kv_cache_dtype="int8",
                           gpt_weights=gw)
        init_s = time.perf_counter() - t0
        launches.reset()
        res = _quality_request(tts, clips, preset, text, seed, launches)
        counts = launches.read()
        launches.add(counts)
        if counts[_k2_row_name(var)] <= 0 or counts["flash_rel_attention"] <= 0:
            raise AssertionError(f"int8-cache request ({gw}) did not launch {var} and K3: "
                                 f"{counts}")
        b = min(16, tts.autoregressive_batch_size)
        t_cache = -(-(_prompt_rows(tts, text) + 500) // 256) * 256
        sizes = {}
        for name, dt in (("int8", torch.int8), ("bf16", torch.bfloat16)):
            c = init_kv_cache(tts.ar_cfg.gpt_config, b, t_cache, dtype=dt, device="cuda")
            sizes[name] = sum(t_.numel() * t_.element_size() for t_ in c.values())
            del c
        res.update(gpt_weights=gw, kv_cache_dtype="int8", init_s=init_s,
                   kv_cache_bytes={"B": b, "T": t_cache, **sizes,
                                   "ratio": sizes["int8"] / sizes["bf16"]})
        print("int8-cache request", json.dumps({k: res[k] for k in (
            "gpt_weights", "wall_s", "stages_s", "peak_mem_bytes", "kv_cache_bytes")}))
        out.append(res)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
    record["quality_int8_cache"] = out


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
    t_start = time.perf_counter()

    sources = ("decode_step", "flash_rel_attn")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    record["build_s"] = time.perf_counter() - t_start
    print(f"built kernels in {record['build_s']:.1f} s")

    k2_rows = check_decode_step(record)
    k3_row = check_flash_attention(record)

    t0 = time.perf_counter()
    tts = TextToSpeech(device="cuda", enable_redaction=False)
    record["init_s"] = time.perf_counter() - t0
    print(f"TextToSpeech (full width, random weights) ready in {record['init_s']:.1f} s; "
          f"AR batch {tts.autoregressive_batch_size}")
    clips, _ = load_voice("train_dotrice")
    k2_rows["bf16"].update(check_decode_main_path(tts, clips, record))
    for var, timing in check_decode_main_path_int8(tts, clips, record).items():
        k2_rows[var].update(timing)
    check_diffusion(tts, record)
    launches = Launches()
    run_pipeline(tts, clips, record, launches)
    # each instance's peak memory is its own
    del tts
    gc.collect()
    torch.cuda.empty_cache()
    run_fast_path(clips, record, launches)
    run_quality_int8(clips, record, launches)

    rows = [k2_rows[v] for v in K2_VARIANTS] + [k3_row]
    for row in rows:
        row["launches"] = launches.total[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched by the main paths")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    record["kernels"] = rows
    record["total_s"] = time.perf_counter() - t_start

    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"total {record['total_s']:.1f} s")
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(json.dumps({"kernels": [{k: row[k] for k in ("name", "route", "source", "replaces",
                                                       "launches", "max_abs_err", "ms",
                                                       "plain_ms")} for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
