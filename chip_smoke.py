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
  4. K3 (relative-position attention) against its plain version at B in
     {2, 1} (the fast preset's CFG batch, ultra_fast's), H=16, D=64, T in
     {256, 2229}, per-row valid lengths below T, timed beside
     scaled_dot_product_attention with the bias as a float mask;
  5. K4 (UnivNet's location-variable convolution) against its plain
     version and the shifted-reshape einsum form at F=2186 frames (a
     500-token clip), hop in {8, 64, 256}, B=1, f32, its kernels in the
     predictor's frames-innermost layout and with each frame's block
     contiguous; a line per hop with its share of its bound;
  6. K1 (one layer's decode attention with the row write) against its
     plain version and scaled_dot_product_attention at L=30, C=1024, H=16,
     T=768, B in {1, 16, 96}, pos in {0, 37, 500, 767}, over bf16 and f32
     caches: the row write bit-exact, every other row untouched;
  7. the full-width TextToSpeech (seeded random weights, voice
     train_dotrice): K2 at the fast request's shapes (96 candidates, the
     last decode position) over a bf16 cache and over an int8 cache, and
     K1 over an f32 cache, each filled by a real prefill, layer by layer,
     with planted faults the checks must catch (cache rows read one off;
     int8 scales read one position off); one diffusion forward with and
     without K3; one UnivNet forward with and without K4; then three
     requests (ultra_fast, ultra_fast, fast with classifier-free guidance);
  8. the fast path, TextToSpeechFast with bf16 and with int8_decode GPT
     weights: a warm-up tts and short stream, a timed tts, a tts_stream of
     the same text and seed (its codes equal tts's, its chunks equal the
     full decode of its own latents, its wav is near tts's), and on the
     bf16 instance a tts_batch of three texts with a random voice;
  9. one quality ultra_fast request with the int8 KV cache for each of
     gpt_weights "int8_decode" and "bf16", with the cache's bytes beside the
     bf16 cache's, and one with the f32 cache and gpt_fused_step=False: K1
     in every layer of every decode step;
 10. the full-knob CLI (tortoise_tpu_torch.apps.main) in this process,
     writing a 24 kHz wav;
 11. the tools path: K5 (decode attention over an interleaved k|v cache,
     BH=256, T=256, n_valid=200), K6 (the decode attention body, variants a
     and b, B=128, T=768, pos=300, ck=64), K7 (seven data-movement probes)
     and K8 (four contraction orientations) against their plain versions
     at the tools' reference shapes, timed with and without the host's
     launch time; then, counted, the five tools' main() in this process:
     probe_ops (with the host's launch costs), decode_attn_kv128 (B=16,
     L=30), bench_attn_body, bench_decode_attn_merged (its defaults: B=16,
     T=768, L=30, nvalid=600, 32 steps) and, last, profile_ar_step (B=16, 8
     tokens a section; its per-layer decode runs K1), whose torch.profiler
     passes come after every timing of the process, each tool checking its
     kernels again.
Before each path of phases 7-11 every launch counter is set to 0, and read
after it: the "launches" of the kernels line sum those runs only. Every
UnivNet forward of those paths launches K4 12 times, and K4's plain version
never runs on the card there.

The last lines are the card's name and power limit, one JSON object with a
row per kernel and K2 variant, and {"ok": true, "device": {...}}. The full
record also goes to build/chip_smoke.json. A row's bound_ms is the least
time the card could take for the row's timed call: the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
operations over the peak rate for their type (bf16 989 TFLOP/s, f32
without tensor cores 67 TFLOP/s; NVIDIA's H100 SXM data sheet), reckoned
by tortoise_tpu_torch/utils/measure.py as the tools reckon theirs.
"""
from __future__ import annotations

import concurrent.futures
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the bounds and timings of the port's tools, one reckoning for both
from tortoise_tpu_torch.utils.measure import bound as _bound  # noqa: E402
from tortoise_tpu_torch.utils.measure import device_ms as _device_ms  # noqa: E402
from tortoise_tpu_torch.utils.measure import nbytes as _nbytes  # noqa: E402
from tortoise_tpu_torch.utils.measure import nvidia_smi as _nvidia_smi  # noqa: E402
from tortoise_tpu_torch.utils.measure import time_ms as _time_ms  # noqa: E402
from tortoise_tpu_torch.utils.measure import STEP_SLEEP_CYCLES_PER_RUN  # noqa: E402
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
# K3: bf16 output of a softmax-weighted mean of O(1) values; both round the
# weights to bf16, the kernel before normalising them, the plain version after
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
# K4: f32 sums of the same products in another order, relative to the
# call's max|plain|
K4_REL_BOUND = 1e-5
# UnivNet's wav (in [-1, 1]) with K4 against the einsum LVC, contractive
# weights: the f32 tolerance of the JAX package's vocoder tests
UNIVNET_ABS_BOUND = 1e-4
# K1, every (batch row, head) relative to its own max|plain|: a bf16 output
# rounds once (one bf16 ulp, 2^-8); an f32 one differs in summation order
K1_BF16_BOUND = 1e-2
K1_F32_BOUND = 1e-5
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
K1_NAME, K3_NAME, K4_NAME = ("decode_attention_merged", "flash_rel_attention",
                             "location_variable_convolution_lvc")
K5_NAME, K7_NAME, K8_NAME = "decode_attention_kv128", "probe_ops", "probe_orient"
# phase 11: each tool's arguments (the K5-K8 tools at their reference shapes,
# K5 at B=16 so BH=256; the profiler with few tokens a section)
TOOL_RUNS = (
    ("probe_ops", []),
    ("decode_attn_kv128", ["--batch", "16", "--tmax", "256", "--layers", "30", "--steps", "8"]),
    ("bench_attn_body", ["--batch", "128", "--t", "768", "--fill", "300", "--ck", "64",
                         "--reps", "5"]),
    ("bench_decode_attn_merged", []),
    # last: its busy passes run torch.profiler, which slows every launch after it
    ("profile_ar_step", ["--batch", "16", "--tokens", "8"]),
)
# UnivNet c32: three LVC blocks (hop 8, 64, 256), four LVC calls each
LVC_HOPS = (8, 64, 256)
LVC_CALLS_PER_FORWARD = 12
# frames of a 500-token clip: 2176 mel frames plus UnivNet's 10 padding frames
LVC_FRAMES = 2186


def _step_device_ms(run) -> float:
    """Device ms of a whole K2 step, queued behind a sleep that outlasts the
    host's ~150 launches a step."""
    return _device_ms(run, 20, STEP_SLEEP_CYCLES_PER_RUN)


def _k2_row_name(variant: str) -> str:
    return "fused_decode_step" if variant == "bf16" else f"fused_decode_step[{variant}]"


def _k6_row_name(variant: str) -> str:
    return f"attn_body[{variant}]"


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
                        run = lambda: fused_decode_step(stacked, x, cache, pos, H)
                        ms, device_ms = _time_ms(run, 20), _step_device_ms(run)
                        plain_ms = _time_ms(
                            lambda: fused_decode_step_plain(stacked, x, cache, pos, H), 5)
                        bound_ms, bound_by = _k2_bound(stacked, x, cache, pos, L, C)
                        case.update(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms)
                        print(f"K2 {var:24s} B={b:2d} pos=500: kernel {ms:.3f} ms (device "
                              f"{device_ms:.3f}), plain {plain_ms:.3f} ms, bound "
                              f"{bound_ms:.4f} ms")
                        # the batches of the fast path and ultra_fast beside the
                        # row's own time (the main path's B=96 where it runs)
                        rows[var].update({f"b{b}_ms": ms, f"b{b}_device_ms": device_ms,
                                          f"b{b}_bound_ms": bound_ms})
                        if b == 1:
                            rows[var].update(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                             timed_at="B=1 pos=500", library_ms=None,
                                             library_device_ms=None, bound_ms=bound_ms,
                                             bound_by=bound_by)
    record["k2"] = cases
    return rows


def _k2_bound(stacked, x, cache, pos, layers, c):
    """K2's least time for one step: every weight once, the cache's rows
    0..pos-1 (and their scales), x in and out, the step's k/v rows out; two
    operations per weight and row, four per cached value attended."""
    b = x.shape[0]
    read = sum(_nbytes(t_[..., :pos] if "scale" in n else t_[:, :, :pos])
               for n, t_ in cache.items())
    nbytes = _nbytes(*stacked.values()) + 2 * _nbytes(x) + read + 2 * layers * b * c * 2
    flops = 2 * b * layers * 12 * c * c + 4 * b * layers * (pos + 1) * c
    return _bound(nbytes, flops, "bf16")


def check_flash_attention(record: dict) -> dict:
    """K3 against its plain version at B in {2, 1} and T in {256, 2229},
    each timed beside its plain version and SDPA with the bias and key mask
    as one float mask. The row's numbers are B=2, T=2229 (the fast preset's
    CFG batch); B=1, T=2229 (ultra_fast's) goes beside them as b1_*."""
    import torch

    import torch.nn.functional as F

    from tortoise_tpu_torch.ops.attn import (expand_rel_bias, flash_rel_attention,
                                             flash_rel_attention_plain)

    H, D = 16, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    cases, worst, row = [], 0.0, {}
    for B, t in ((2, 256), (2, 2229), (1, 256), (1, 2229)):
        q, k, v = (torch.randn((B, H, t, D), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        bias = torch.randn((H, 2 * t - 1), generator=g, device="cuda").to(torch.bfloat16).float()
        valid = torch.tensor([t - 5, (3 * t) // 4][:B], dtype=torch.int32, device="cuda")
        got = flash_rel_attention(q, k, v, bias, valid)
        torch.cuda.synchronize()
        want = flash_rel_attention_plain(q, k, v, bias, valid)
        err = max((got[b, :, :n] - want[b, :, :n]).float().abs().max().item()
                  for b, n in enumerate(valid.tolist()))
        ms = _time_ms(lambda: flash_rel_attention(q, k, v, bias, valid), 20)
        plain_ms = _time_ms(lambda: flash_rel_attention_plain(q, k, v, bias, valid), 5)
        # the library call: the bias and the key mask as one float mask
        keys = torch.arange(t, device="cuda")[None, :] < valid[:, None]
        mask = (expand_rel_bias(bias, t)[None]
                + torch.where(keys, 0.0, float("-inf"))[:, None, None, :]).to(torch.bfloat16)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        sdpa_err = max((sdpa()[b, :, :n] - want[b, :, :n]).float().abs().max().item()
                       for b, n in enumerate(valid.tolist()))
        library_ms = _time_ms(sdpa, 20)
        device_ms = _device_ms(lambda: flash_rel_attention(q, k, v, bias, valid), 20)
        library_device_ms = _device_ms(sdpa, 20)
        del mask
        n_valid = sum(valid.tolist())
        bound_ms, bound_by = _bound(
            2 * H * D * 2 * (B * t + n_valid) + _nbytes(bias, valid), 4 * H * D * t * n_valid,
            "bf16")
        cases.append({"B": B, "T": t, "valid_len": valid.tolist(), "err": err,
                      "bound": K3_ABS_BOUND, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "library_max_abs_err": sdpa_err,
                      "device_ms": device_ms, "library_device_ms": library_device_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"K3 B={B} H={H} T={t} valid={valid.tolist()}: max|err| {err:.4g} "
              f"(bound {K3_ABS_BOUND}); kernel {ms:.3f} ms (device {device_ms:.3f}), plain "
              f"{plain_ms:.3f} ms, SDPA {library_ms:.3f} ms (device {library_device_ms:.3f}, "
              f"max|err| {sdpa_err:.4g}), bound {bound_ms:.4f} ms ({bound_by})")
        if err > K3_ABS_BOUND:
            raise AssertionError(f"K3 disagrees with its plain version at B={B} T={t}: {err}")
        worst = max(worst, err)
        if t == 2229:
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "device_ms": device_ms, "library_device_ms": library_device_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
            row.update(timing if B == 2 else {f"b1_{k_}": x for k_, x in timing.items()})
    record["k3"] = cases
    return {"name": K3_NAME, "route": "cuda",
            "source": "tortoise_tpu_torch/csrc/flash_rel_attn.cu",
            "replaces": "tortoise_tpu/ops/attn_pallas.py:89",
            "max_abs_err": worst, "timed_at": "B=2 T=2229 (b1_*: B=1 T=2229)", **row}


def check_lvc(record: dict) -> dict:
    """K4 against its plain version at the main path's shapes (UnivNet c32,
    F=2186, B=1, f32), x as UnivNet hands it over, the kernels and bias both
    in the predictor's frames-innermost layout (what UnivNet passes) and
    with each frame's block contiguous; timed on the predictor's layout
    beside the plain version and the shifted-reshape einsum form (the JAX
    package's production LVC), and on the contiguous blocks. Each hop's row
    prints with its share of its bound. The returned row's times are the
    sums over one UnivNet forward's 12 calls (4 per hop), its bound that of
    their bytes and operations together."""
    import torch

    from tortoise_tpu_torch.models.vocoder import (location_variable_convolution,
                                                   random_predictor_output)
    from tortoise_tpu_torch.ops.lvc import (location_variable_convolution_lvc,
                                            location_variable_convolution_lvc_plain, plan_lvc)

    b, f, ci, co, k, layers = 1, LVC_FRAMES, 32, 64, 3, 4
    g = torch.Generator(device="cuda").manual_seed(4)
    cases, worst = [], 0.0
    per_forward = dict.fromkeys(("ms", "plain_ms", "library_ms", "device_ms",
                                 "library_device_ms", "blocks_device_ms"), 0.0)
    work = [0, 0]   # bytes, operations of one forward's calls
    for hop in LVC_HOPS:
        # x as UnivNet hands it over: the (B, T, Ci) view of a channels-first conv output
        x = torch.randn((b, ci, f * hop), generator=g, device="cuda").transpose(1, 2)
        # kernels and bias as the predictor leaves them: slices [:, l] of
        # (B, L, F, ...) views, frames innermost; and each frame's block contiguous
        kern_all, bias_all = random_predictor_output(g, b, layers, f, ci, co, k)
        kern, bias = kern_all[:, 2], bias_all[:, 2]
        kern_blocks, bias_blocks = kern.contiguous(), bias.contiguous()
        got = location_variable_convolution_lvc(x, kern, bias, hop)
        got_blocks = location_variable_convolution_lvc(x, kern_blocks, bias_blocks, hop)
        torch.cuda.synchronize()
        want = location_variable_convolution_lvc_plain(x, kern_blocks, bias_blocks, hop)
        scale = want.abs().max().item()
        err = max((got - want).abs().max().item(), (got_blocks - want).abs().max().item())
        einsum_err = (location_variable_convolution(x, kern, bias, hop) - want).abs().max().item()
        kernel = lambda: location_variable_convolution_lvc(x, kern, bias, hop)
        blocks = lambda: location_variable_convolution_lvc(x, kern_blocks, bias_blocks, hop)
        library = lambda: location_variable_convolution(x, kern, bias, hop)
        ms, library_ms = _time_ms(kernel, 20), _time_ms(library, 20)
        plain_ms = _time_ms(lambda: location_variable_convolution_lvc_plain(x, kern, bias, hop), 5)
        device_ms, library_device_ms = _device_ms(kernel, 20), _device_ms(library, 20)
        blocks_device_ms = _device_ms(blocks, 20)
        nbytes, flops = _nbytes(x, kern, bias, got), 2 * b * f * hop * co * ci * k
        bound_ms, bound_by = _bound(nbytes, flops, "f32")
        case = {"hop": hop, "F": f, "plan": plan_lvc(b, f, hop, ci, co, k, True),
                "max_abs_err": err, "rel_err": err / scale, "bound": K4_REL_BOUND,
                "einsum_rel_err": einsum_err / scale,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "device_ms": device_ms,
                "library_device_ms": library_device_ms, "blocks_device_ms": blocks_device_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / device_ms}
        cases.append(case)
        print(f"K4 hop={hop:3d} F={f}: max|err| {err:.4g} = {err / scale:.3g} x max|plain| "
              f"(bound {K4_REL_BOUND}, both layouts); kernel {ms:.4f} ms (device "
              f"{device_ms:.4f}; contiguous blocks {blocks_device_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, einsum {library_ms:.4f} ms (device {library_device_ms:.4f}), "
              f"bound {bound_ms:.4f} ms ({bound_by}): {bound_ms / device_ms:.0%} of the bound "
              f"on the device")
        if err > K4_REL_BOUND * scale:
            raise AssertionError(f"K4 disagrees with its plain version: {case}")
        worst = max(worst, err)
        calls = LVC_CALLS_PER_FORWARD // len(LVC_HOPS)
        for key in per_forward:
            per_forward[key] += case[key] * calls
        work[0] += nbytes * calls
        work[1] += flops * calls
        del x, kern_all, bias_all, kern, bias, kern_blocks, bias_blocks, got, got_blocks, want
    record["k4"] = cases
    bound_ms, bound_by = _bound(*work, "f32")
    print(f"K4, one forward's 12 calls: device {per_forward['device_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}): {bound_ms / per_forward['device_ms']:.0%} of the "
          f"bound")
    return {"name": K4_NAME, "route": "cuda", "source": "tortoise_tpu_torch/csrc/lvc.cu",
            "replaces": "tortoise_tpu/ops/lvc_pallas.py:52", "max_abs_err": worst,
            "timed_at": f"one UnivNet forward's 12 calls, F={f}", **per_forward,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _k1_inputs(g, b, c, q_dtype):
    import torch

    qkv = torch.randn((b, 3 * c), generator=g, device="cuda").to(q_dtype)
    return qkv.split(c, dim=-1)   # q, k_new, v_new: views, rows 3C apart


def check_decode_attention_merged(record: dict) -> dict:
    """K1 against its plain version at full width over bf16 and f32 caches:
    every (batch row, head) within its bound, the row write bit-exact and
    every other row untouched (the whole cache equals the plain version's
    after each call). Timed at pos=500 beside the plain version and the row
    write plus scaled_dot_product_attention over the strided prefix views;
    the row's numbers are B=16, pos=500, bf16 cache."""
    import torch
    import torch.nn.functional as F

    from tortoise_tpu_torch.ops.attn import decode_attention_merged, decode_attention_merged_plain

    L, C, H, T, layer, dh = 30, 1024, 16, 768, 7, 64
    g = torch.Generator(device="cuda").manual_seed(5)
    cases, row, worst = [], None, 0.0
    for q_dtype, c_dtype, bound in ((torch.bfloat16, torch.bfloat16, K1_BF16_BOUND),
                                    (torch.float32, torch.float32, K1_F32_BOUND),
                                    (torch.bfloat16, torch.float32, K1_BF16_BOUND)):
        what = f"q {str(q_dtype)[6:]}, cache {str(c_dtype)[6:]}"
        for b in (1, 16, 96):
            cache = {n: torch.randn((L, b, T, C), generator=g, device="cuda").to(c_dtype)
                     for n in "kv"}
            plain = {n: t_.clone() for n, t_ in cache.items()}
            for pos in (0, 37, 500, 767):
                q, kn, vn = _k1_inputs(g, b, C, q_dtype)
                got = decode_attention_merged(q, kn, vn, cache["k"], cache["v"], layer, pos,
                                              heads=H)
                torch.cuda.synchronize()
                want = decode_attention_merged_plain(q, kn, vn, plain["k"], plain["v"], layer,
                                                     pos, heads=H)
                exact = torch.equal(cache["k"], plain["k"]) and torch.equal(cache["v"], plain["v"])
                err = _head_rel_err(got, want, H)
                abs_err = (got.float() - want.float()).abs().max().item()
                case = {"q": str(q_dtype), "cache": str(c_dtype), "B": b, "pos": pos,
                        "head_rel_err": err, "max_abs_err": abs_err, "bound": bound,
                        "cache_equal": exact}
                if pos == 500:
                    def sdpa():
                        kc, vc = cache["k"][layer], cache["v"][layer]
                        kc[:, pos], vc[:, pos] = kn.to(c_dtype), vn.to(c_dtype)
                        view = lambda t_: t_[:, :pos + 1].view(b, pos + 1, H, dh).transpose(1, 2)
                        return F.scaled_dot_product_attention(
                            q.to(c_dtype).reshape(b, H, 1, dh), view(kc), view(vc))
                    case["ms"] = _time_ms(lambda: decode_attention_merged(
                        q, kn, vn, cache["k"], cache["v"], layer, pos, heads=H), 20)
                    case["plain_ms"] = _time_ms(lambda: decode_attention_merged_plain(
                        q, kn, vn, plain["k"], plain["v"], layer, pos, heads=H), 5)
                    case["library_ms"] = _time_ms(sdpa, 20)
                    case["device_ms"] = _device_ms(lambda: decode_attention_merged(
                        q, kn, vn, cache["k"], cache["v"], layer, pos, heads=H), 20)
                    case["library_device_ms"] = _device_ms(sdpa, 20)
                    case["bound_ms"], case["bound_by"] = _bound(
                        _nbytes(q, kn, vn, got) + 2 * b * (pos + 1) * C * cache["k"].element_size(),
                        4 * b * (pos + 1) * C, "f32")
                    print(f"K1 {what} B={b:2d} pos=500: kernel {case['ms']:.4f} ms (device "
                          f"{case['device_ms']:.4f}), plain {case['plain_ms']:.4f} ms, row write "
                          f"+ SDPA {case['library_ms']:.4f} ms (device "
                          f"{case['library_device_ms']:.4f}), bound {case['bound_ms']:.4f} ms "
                          f"({case['bound_by']})")
                    if b == 16 and c_dtype == torch.bfloat16:
                        row = {k_: case[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                                        "device_ms", "library_device_ms",
                                                        "bound_ms", "bound_by")}
                cases.append(case)
                print(f"K1 {what} B={b:2d} pos={pos:3d}: max head rel err {err:.4g} (bound "
                      f"{bound}), max|err| {abs_err:.4g}, cache equal to plain's: {exact}")
                if err > bound or not exact:
                    raise AssertionError(f"K1 disagrees with its plain version: {case}")
                worst = max(worst, abs_err)
            del cache, plain
            torch.cuda.empty_cache()
    record["k1"] = cases
    return {"name": K1_NAME, "route": "cuda",
            "source": "tortoise_tpu_torch/csrc/decode_attn_merged.cu",
            "replaces": "tortoise_tpu/ops/attn_pallas.py:215", "max_abs_err": worst,
            "timed_at": "B=16 pos=500 T=768 bf16 cache", **row}


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
    print(f"decode main path: B={b} prompt {p_len} rows, {cache['k'].dtype} cache T={t_cache}, "
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
    run = lambda: fused_decode_step(stacked, x, cache, pos, heads)
    ms, device_ms = _time_ms(run, 20), _step_device_ms(run)
    plain_ms = _time_ms(lambda: fused_decode_step_plain(stacked, x, cache, pos, heads), 5)
    b, t = cache["k"].shape[1], cache["k"].shape[2]
    bound_ms, bound_by = _k2_bound(stacked, x, cache, pos, cache["k"].shape[0], x.shape[1])
    print(f"K2 ({what}) B={b} pos={pos} T={t}: kernel {ms:.3f} ms (device {device_ms:.3f}), "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"row_rel_err": errs, "max_abs_err": abs_err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


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
    return {k: whole[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")} | \
        {"timed_at": "B=96 pos=566"}


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
            out[var] = {k: steps[var][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                   "bound_by")} | {"timed_at": "B=96 pos=566"}
        sampler_err = _sampler_step(tts, stacked, emb, cache, pos, "int8 cache")
    record["k2_main_path_int8_cache"] = {
        "B": cache["k"].shape[1], "pos": pos, "T": cache["k"].shape[2],
        "attn_head_rel_err": attn_err, "layer_hidden_rel_err": hidden_err,
        "planted": planted, "steps": steps, "sampler_row_rel_err": sampler_err}
    return out


def check_k1_main_path(tts, clips, record: dict) -> None:
    """K1 over an f32 cache at the fast request's shapes (96 candidates, the
    last decode step), the cache filled by a real prefill through the layer
    stack. One decode step through the stack must launch K1 once per layer;
    then, layer by layer on that step's q/k/v, every head held to
    K1_BF16_BOUND (the bf16 model's q) against the plain version, whose row
    write must equal K1's; the plain version reading the cache one row
    short or long (pos -/+ 1) or one prefix row as its neighbour must move
    past the bound."""
    import torch

    from tortoise_tpu_torch.ops.attn import decode_attention_merged, decode_attention_merged_plain

    gpt = tts.autoregressive.gpt
    heads, layers = gpt.config.n_head, gpt.config.n_layer
    with torch.inference_mode():
        cache, emb, pos, p_len = _prefilled_main_path(tts, clips, torch.float32)
        r = p_len + (pos - p_len) // 2
        step = []
        attend = gpt._attend

        def spy(q, k, v, cache_, layer, index):
            step.append((q[:, 0], k[:, 0], v[:, 0]))
            return attend(q, k, v, cache_, layer, index)

        gpt._attend = spy
        before = decode_attention_merged.launches
        try:
            gpt(emb, cache=cache, cache_index=pos)
        finally:
            del gpt._attend
        step_launches = decode_attention_merged.launches - before
        if step_launches != layers:
            raise AssertionError(f"a decode step through the layer stack launched K1 "
                                 f"{step_launches} times, not {layers}")
        attn_err, planted, writes_equal = 0.0, {"pos-1": 0.0, "pos+1": 0.0, "row": 0.0}, True
        for l, (q, kn, vn) in enumerate(step):
            ca = {n: t_[l:l + 1] for n, t_ in cache.items()}
            copy = lambda: {n: t_.clone() for n, t_ in ca.items()}
            got = decode_attention_merged(q, kn, vn, ca["k"], ca["v"], 0, pos, heads=heads)
            plain = copy()
            want = decode_attention_merged_plain(q, kn, vn, plain["k"], plain["v"], 0, pos,
                                                 heads=heads)
            writes_equal &= torch.equal(plain["k"], ca["k"]) and torch.equal(plain["v"], ca["v"])
            attn_err = max(attn_err, _head_rel_err(got, want, heads))
            for name, p_ in (("pos-1", pos - 1), ("pos+1", pos + 1)):
                bad = copy()
                wrong = decode_attention_merged_plain(q, kn, vn, bad["k"], bad["v"], 0, p_,
                                                      heads=heads)
                planted[name] = max(planted[name], _head_rel_err(got, wrong, heads))
            bad = copy()
            for t_ in bad.values():
                t_[0, :, r] = t_[0, :, r + 1]
            wrong = decode_attention_merged_plain(q, kn, vn, bad["k"], bad["v"], 0, pos,
                                                  heads=heads)
            planted["row"] = max(planted["row"], _head_rel_err(got, wrong, heads))
    print(f"K1 per layer (f32 cache, B={cache['k'].shape[1]}, pos={pos}): attention heads max "
          f"rel err {attn_err:.4g} (bound {K1_BF16_BOUND}); row writes equal: {writes_equal}; "
          f"planted faults " + ", ".join(f"{k} {v:.4g}" for k, v in planted.items()))
    record["k1_main_path"] = {"B": cache["k"].shape[1], "pos": pos, "T": cache["k"].shape[2],
                              "step_launches": step_launches, "attn_head_rel_err": attn_err,
                              "row_writes_equal": writes_equal, "planted": planted}
    if attn_err > K1_BF16_BOUND or not writes_equal:
        raise AssertionError(f"K1 disagrees with its plain version on the main path: "
                             f"{record['k1_main_path']}")
    if min(planted.values()) <= K1_BF16_BOUND:
        raise AssertionError(f"the K1 check cannot see a planted cache fault: {planted}")
    del cache


def check_univnet(tts, record: dict) -> None:
    """One UnivNet forward at F=2186 frames (a 500-token clip) with K4 and
    with the einsum LVC in the same blocks, both timed. The seeded random
    weights make the gated stack chaotic (the last bits of one LVC flip
    samples of the wav), so the two paths are held to each other on a copy
    whose weights are scaled by 0.15, which makes it contractive (as
    tests/test_torch_modules.py does): within UNIVNET_ABS_BOUND."""
    import copy

    import torch

    voc = tts.vocoder
    blocks = [getattr(voc, f"lvc_{i}") for i in range(len(voc.config.strides))]
    g = torch.Generator(device="cuda").manual_seed(6)
    frames = LVC_FRAMES - 10
    mel = torch.randn((1, frames, voc.config.n_mel_channels), generator=g, device="cuda")
    z = torch.randn((1, LVC_FRAMES, voc.config.noise_dim), generator=g, device="cuda")
    with torch.inference_mode():
        kernel_ms = _time_ms(lambda: voc.inference(mel, z), 5)
        with_kernel = voc.inference(mel, z)
        for blk in blocks:
            blk.use_kernel = False
        try:
            einsum_ms = _time_ms(lambda: voc.inference(mel, z), 5)
            with_einsum = voc.inference(mel, z)
        finally:
            for blk in blocks:
                blk.use_kernel = True
    diff = (with_kernel - with_einsum).abs().max().item()
    calm = copy.deepcopy(voc)
    with torch.inference_mode():
        for prm in calm.parameters():
            prm.mul_(0.15)
        calm_kernel = calm.inference(mel, z)
        for blk in (getattr(calm, f"lvc_{i}") for i in range(len(calm.config.strides))):
            blk.use_kernel = False
        calm_diff = (calm_kernel - calm.inference(mel, z)).abs().max().item()
    del calm
    record["univnet_forward"] = {"frames": frames, "k4_ms": kernel_ms, "einsum_ms": einsum_ms,
                                 "max_abs_diff_random_weights": diff,
                                 "max_abs_diff_contractive": calm_diff,
                                 "bound": UNIVNET_ABS_BOUND}
    print(f"UnivNet forward, {frames} mel frames: with K4 {kernel_ms:.3f} ms, with the einsum "
          f"LVC {einsum_ms:.3f} ms; max|diff| of the wavs {diff:.4g} (random weights), "
          f"{calm_diff:.4g} (contractive weights, bound {UNIVNET_ABS_BOUND})")
    if calm_diff > UNIVNET_ABS_BOUND:
        raise AssertionError(f"UnivNet with K4 disagrees with the einsum LVC: {calm_diff}")


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
    a path runs, ``read`` returns them after it, ``total`` sums the runs.
    It also counts K4's plain version called on CUDA tensors ("lvc plain on
    cuda"), which no path may do."""

    def __init__(self):
        from tortoise_tpu_torch.ops import lvc
        from tortoise_tpu_torch.ops.attn import decode_attention_merged, flash_rel_attention
        from tortoise_tpu_torch.ops.decode_step import fused_decode_step
        from tortoise_tpu_torch.tools.bench_attn_body import attn_body
        from tortoise_tpu_torch.tools.decode_attn_kv128 import decode_attention_kv128
        from tortoise_tpu_torch.tools.probe_ops import contraction, probe

        # wrappers that count each variant apart: {wrapper: row name of a variant}
        self.by_variant = {fused_decode_step: _k2_row_name, attn_body: _k6_row_name}
        self.single = {K1_NAME: decode_attention_merged, K3_NAME: flash_rel_attention,
                       K4_NAME: lvc.location_variable_convolution_lvc,
                       K5_NAME: decode_attention_kv128, K7_NAME: probe, K8_NAME: contraction}
        self.total = {name(v): 0 for fn, name in self.by_variant.items()
                      for v in fn.launches_by_variant}
        self.total.update(dict.fromkeys(self.single, 0))
        self.lvc_plain_on_cuda = 0
        plain = lvc.location_variable_convolution_lvc_plain

        def counted(x, *args, **kwargs):
            self.lvc_plain_on_cuda += int(x.is_cuda)
            return plain(x, *args, **kwargs)

        lvc.location_variable_convolution_lvc_plain = counted

    def reset(self):
        for fn in self.by_variant:
            fn.launches = 0
            fn.launches_by_variant.update(dict.fromkeys(fn.launches_by_variant, 0))
        for fn in self.single.values():
            fn.launches = 0
        self.lvc_plain_on_cuda = 0

    def read(self) -> dict:
        counts = {name(v): n for fn, name in self.by_variant.items()
                  for v, n in fn.launches_by_variant.items()}
        counts.update({name: fn.launches for name, fn in self.single.items()})
        if self.lvc_plain_on_cuda:
            raise AssertionError(f"K4's plain version ran on CUDA tensors "
                                 f"{self.lvc_plain_on_cuda} times on a main path")
        return counts

    def add(self, counts: dict):
        for k, n in counts.items():
            self.total[k] += n


def check_tool_kernels(record: dict) -> list[dict]:
    """K5-K8 against their plain versions at the tools' reference shapes,
    each timed beside its plain version and its library yardstick: K5 at
    BH=256, T=256, n_valid=200; K6 (both variants) at B=128, T=768,
    pos=300, ck=64; K7's seven probes; K8's four orientations. K7's and
    K8's rows sum their calls' times and bound; the per-probe numbers go to
    the record."""
    import torch

    from tortoise_tpu_torch.tools import bench_attn_body, decode_attn_kv128, probe_ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    kv = torch.randn((256, 256, 128), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((256, 64), generator=g, device=dev).to(torch.bfloat16)
    k5 = decode_attn_kv128.check(kv, q, 200)
    record["k5"] = k5
    print(f"K5 BH=256 T=256 n=200: max|err| {k5['max_abs_err']:.4g} = {k5['rel_err']:.3g} x "
          f"max|plain| (bound {k5['bound']}); kernel {k5['ms']:.4f} ms (device "
          f"{k5['device_ms']:.4f}), plain {k5['plain_ms']:.4f} ms, SDPA {k5['library_ms']:.4f} ms "
          f"(device {k5['library_device_ms']:.4f}), bound {k5['bound_ms']:.4f} ms "
          f"({k5['bound_by']})")
    if k5["rel_err"] > k5["bound"]:
        raise AssertionError(f"K5 disagrees with its plain version: {k5}")
    rows.append({"name": K5_NAME, "source": "tortoise_tpu_torch/csrc/decode_attn_kv128.cu",
                 "replaces": "tools/pallas_decode_attn.py:64",
                 "timed_at": "BH=256 T=256 n_valid=200", **k5})
    del kv

    b, t, c, pos, ck = 128, 768, 1024, 300, 64
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((b, c), (b, t, c), (b, t, c)))
    record["k6"] = {}
    for variant in bench_attn_body.VARIANTS:
        r = record["k6"][variant] = bench_attn_body.check(q, k, v, pos, ck, variant, 20)
        print(f"K6[{variant}] B={b} T={t} pos={pos} ck={ck}: max head rel err "
              f"{r['head_rel_err']:.4g} (bound {r['bound']}), max|err| vs f32 reference "
              f"{r['ref_max_abs_err']:.4g}; kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
              f"(device {r['library_device_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        if r["head_rel_err"] > r["bound"]:
            raise AssertionError(f"K6[{variant}] disagrees with its plain version: {r}")
        rows.append({"name": _k6_row_name(variant), "source": "tortoise_tpu_torch/csrc/attn_body.cu",
                     "replaces": "tools/bench_attn_body_pallas.py:124",
                     "timed_at": f"B={b} T={t} pos={pos} ck={ck}", **r})
    del q, k, v

    for name, calls, dtype, replaces, timed_at in (
            (K7_NAME, probe_ops.run_probes(dev), "f32", "tools/probe_mosaic_ops.py:18",
             "the seven probes' calls, B=64 ck=32 H=16 T=768 C=1024"),
            (K8_NAME, probe_ops.timed_probes(dev), "bf16", "tools/probe_mosaic_ops.py:87",
             "the four orientations' calls, B=64 ck=128 C=1024 H=16")):
        record[name] = calls
        if not all(r["ok"] for r in calls):
            raise AssertionError(f"{name}: a probe disagrees with its plain version: {calls}")
        bound_ms, bound_by = _bound(sum(r["nbytes"] for r in calls),
                                    sum(r["flops"] for r in calls), dtype)
        row = {"name": name, "source": "tortoise_tpu_torch/csrc/probe_ops.cu",
               "replaces": replaces, "timed_at": timed_at,
               "max_abs_err": max(r["max_abs_err"] for r in calls),
               "bound_ms": bound_ms, "bound_by": bound_by}
        # K7 times no bf16 yardstick
        sums = ("ms", "plain_ms", "library_ms", "library_bf16_ms", "device_ms",
                "library_device_ms")
        row.update({k_: sum(r[k_] for r in calls) for k_ in sums if k_ in calls[0]})
        rows.append(row)
    for row in rows:
        row["route"] = "cuda"
    return rows


def run_tools(record: dict, launches: Launches) -> None:
    """Phase 11, the tools path: each tool's main() in this process, as a
    user runs it on the card, counted apart. Each checks its own kernels
    against their plain versions and raises on a mismatch (probe_ops
    returns ok=False); profile_ar_step's sections must all be timed."""
    import importlib
    import math

    record["tools"] = {}
    launches.reset()
    for name, argv in TOOL_RUNS:
        tool = importlib.import_module(f"tortoise_tpu_torch.tools.{name}")
        t0 = time.perf_counter()
        print(f"--- python3 -m tortoise_tpu_torch.tools.{name} {' '.join(argv)}")
        res = tool.main(argv)
        res["wall_s"] = time.perf_counter() - t0
        record["tools"][name] = res
        if name == "probe_ops" and not res["ok"]:
            raise AssertionError("probe_ops: a probe failed")
        if name == "profile_ar_step":
            secs = res["sections"]
            timed = [secs["a"], secs["b"], secs["c"], *secs["b2"].values(),
                     *(r for row in secs["d"].values() for r in row.values())]
            if not all(math.isfinite(r["device_ms"]) and r["device_ms"] > 0 for r in timed):
                raise AssertionError(f"profile_ar_step: a section was not timed: {secs}")
    counts = launches.read()
    launches.add(counts)
    record["tools_launches"] = counts
    print("tools path launches", json.dumps(counts))


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
    if grew.get(K4_NAME) != LVC_CALLS_PER_FORWARD:
        raise AssertionError(f"{preset!r} request: one UnivNet forward launched K4 "
                             f"{grew.get(K4_NAME, 0)} times, not {LVC_CALLS_PER_FORWARD}")
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


def run_quality_f32_cache(clips, record: dict, launches: Launches) -> None:
    """One ultra_fast request with the f32 KV cache and gpt_fused_step=False:
    every decode step runs the layer stack, K1 in each of its 30 layers;
    K2 never runs."""
    from tortoise_tpu_torch.api import TextToSpeech

    preset, text, seed = REQUESTS[0]
    t0 = time.perf_counter()
    tts = TextToSpeech(device="cuda", enable_redaction=False, kv_cache_dtype="f32",
                       gpt_fused_step=False)
    init_s = time.perf_counter() - t0
    layers = tts.ar_cfg.layers
    launches.reset()
    res = _quality_request(tts, clips, preset, text, seed, launches)
    counts = launches.read()
    launches.add(counts)
    k2 = sum(counts[_k2_row_name(v)] for v in K2_VARIANTS)
    if counts[K1_NAME] <= 0 or counts[K1_NAME] % layers or k2 or counts[K3_NAME] <= 0:
        raise AssertionError(f"f32-cache request: K1 must run in every layer of every step, K2 "
                             f"never, K3 in the diffusion: {counts}")
    res.update(kv_cache_dtype="f32", gpt_fused_step=False, init_s=init_s,
               k1_launches_per_step=layers, decode_steps=counts[K1_NAME] // layers)
    print("f32-cache request", json.dumps({k: res[k] for k in (
        "wall_s", "stages_s", "peak_mem_bytes", "launches", "decode_steps")}))
    record["quality_f32_cache"] = res
    del tts
    gc.collect()
    import torch

    torch.cuda.empty_cache()


def run_cli(record: dict, launches: Launches) -> None:
    """The full-knob CLI in this process, as a user runs it on the card:
    build/cli.wav must be a 24 kHz float wav, finite, within [-1, 1]."""
    import numpy as np
    import torch
    from scipy.io.wavfile import read as wav_read

    from tortoise_tpu_torch.apps import main as cli

    out = os.path.join(ROOT, "build", "cli.wav")
    if os.path.exists(out):
        os.unlink(out)
    argv = ["--voice", "train_dotrice", "--preset", "ultra_fast", "--seed", "0", "-q", "-o", out,
            REQUESTS[0][1]]
    launches.reset()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    counts = launches.read()
    launches.add(counts)
    sr, wav = wav_read(out)
    res = {"argv": argv, "rc": rc, "wall_s_with_init": wall, "sample_rate": sr,
           "samples": int(wav.shape[0]), "dtype": str(wav.dtype), "launches": counts,
           "max_abs": float(np.abs(wav).max()) if wav.size else None}
    print("CLI", json.dumps(res))
    record["cli"] = res
    if rc != 0 or sr != 24000 or wav.dtype != np.float32 or wav.ndim != 1 or not wav.size \
            or not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
        raise AssertionError(f"the CLI wrote a bad wav: {res}")
    if min(counts[_k2_row_name("bf16")], counts[K3_NAME], counts[K4_NAME]) <= 0:
        raise AssertionError(f"the CLI's request did not launch K2, K3 and K4: {counts}")
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs only on the GPU")
    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.ops import _build
    from tortoise_tpu_torch.utils.audio import load_voice

    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    record = {"device": kind, "nvidia_smi": smi}
    t_start = time.perf_counter()

    sources = ("decode_step", "flash_rel_attn", "lvc", "decode_attn_merged", "decode_attn_kv128",
               "attn_body", "probe_ops")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    record["build_s"] = time.perf_counter() - t_start
    print(f"built kernels in {record['build_s']:.1f} s")

    k2_rows = check_decode_step(record)
    k3_row = check_flash_attention(record)
    k4_row = check_lvc(record)
    k1_row = check_decode_attention_merged(record)

    t0 = time.perf_counter()
    tts = TextToSpeech(device="cuda", enable_redaction=False)
    record["init_s"] = time.perf_counter() - t0
    print(f"TextToSpeech (full width, random weights) ready in {record['init_s']:.1f} s; "
          f"AR batch {tts.autoregressive_batch_size}")
    clips, _ = load_voice("train_dotrice")
    k2_rows["bf16"].update(check_decode_main_path(tts, clips, record))
    for var, timing in check_decode_main_path_int8(tts, clips, record).items():
        k2_rows[var].update(timing)
    check_k1_main_path(tts, clips, record)
    check_diffusion(tts, record)
    check_univnet(tts, record)
    launches = Launches()
    run_pipeline(tts, clips, record, launches)
    # each instance's peak memory is its own
    del tts
    gc.collect()
    torch.cuda.empty_cache()
    run_fast_path(clips, record, launches)
    run_quality_int8(clips, record, launches)
    run_quality_f32_cache(clips, record, launches)
    run_cli(record, launches)
    tool_rows = check_tool_kernels(record)
    run_tools(record, launches)

    rows = [k2_rows[v] for v in K2_VARIANTS] + [k3_row, k4_row, k1_row] + tool_rows
    for row in rows:
        row["launches"] = launches.total[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched by the main paths")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    jax_package = sorted(m for m in sys.modules if m.split(".")[0] == "tortoise_tpu")
    if jax_package:
        raise AssertionError(f"the port imported the JAX package: {jax_package}")
    record["kernels"] = rows
    record["total_s"] = time.perf_counter() - t_start

    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"total {record['total_s']:.1f} s")
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(json.dumps({"kernels": [{k: row[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "device_ms", "library_device_ms")}
        for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
