"""Whole requests with K2 (``gpt_fused_step``) on and off, on the GPU.

Counterpart of ``tools/bench_fused_ab.py``, flag for flag: end-to-end walls
with the whole-step decode kernel on and off at the operating points that
decide its default. Off, the decode runs the layer stack (K1 in every layer
over the bf16 cache; the chunked plain attention over the int8 one).

* the fast path's ``tts`` at B=1, bf16 and int8 GPT weights;
* ``tts_batch`` of ``--batch`` utterances (bf16);
* the quality ``standard`` preset with the bf16 and with the int8 KV cache.

Every request is capped at ``--tokens`` AR tokens and uses a random voice;
seeded random weights at full width. A row is the median wall (p50_s) and
real-time factor of ``--runs`` requests after a warm-up one. The JAX tool's
third quality row (the int8 cache at B=128 with the kernel off) exists
because its fused kernel's VMEM budget capped the batch at 64; K2 takes any
batch, so both int8-cache rows run at the picked batch. It prints one JSON
object.

    python3 -m tortoise_tpu_torch.tools.bench_fused_ab [--runs 5] [--tokens 200] \\
        [--batch 64] [--skip-quality] [--skip-batch] [--quality-runs 3] [--interleaved-batch]

``--interleaved-batch``: ``tts_batch`` alone, on and off in the order
off, on, on, off on one instance (a per-call override), ``--runs`` pairs.
``--device cpu`` runs the plain versions (for tests).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from tortoise_tpu_torch.api import TextToSpeech
from tortoise_tpu_torch.api_fast import TextToSpeechFast
from tortoise_tpu_torch.ops.decode_step import fused_decode_step
from tortoise_tpu_torch.utils import measure

SENTENCE = ("Thanks for reading this article. I hope you found it informative "
            "and that it made you curious about the world of speech synthesis.")
QUALITY_ROWS = (("quality_standard", "bf16"), ("quality_standard_int8kv", "int8"))


def _measure(fn, runs: int) -> dict:
    """fn(seed) -> (wall s, audio s): a warm-up call, then ``runs``. Also
    records K2's launches over the runs and whether every wav was finite."""
    fn(0)
    before = fused_decode_step.launches
    results = [fn(i + 1) for i in range(runs)]
    walls = sorted(w for w, _, _ in results)
    return {"p50_s": walls[len(walls) // 2],
            "rtf": statistics.median(w / a for w, a, _ in results),
            "audio_s": results[0][1], "runs": runs,
            "k2_launches": fused_decode_step.launches - before,
            "finite": all(ok for _, _, ok in results)}


def _timed(dev, call):
    """(wall s, the call's wavs) with the host clock; on CUDA it ends in a
    synchronize."""
    t0 = time.perf_counter()
    wavs = call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, wavs if isinstance(wavs, list) else [wavs]


def _row(wall, wavs):
    return (wall, sum(w.shape[-1] for w in wavs) / 24000.0,
            all(bool(torch.isfinite(w).all()) for w in wavs))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--tokens", type=int, default=200)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--skip-quality", action="store_true")
    parser.add_argument("--skip-batch", action="store_true")
    parser.add_argument("--quality-runs", type=int, default=3)
    parser.add_argument("--interleaved-batch", action="store_true",
                        help="off/on/on/off-ordered tts_batch A/B on one resident instance; "
                             "--runs pairs")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = measure.cuda_device(args.device, "bench_fused_ab")
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "ar_tokens": args.tokens}
    texts = [f"{SENTENCE} Utterance number {i}." for i in range(args.batch)]

    if args.interleaved_batch:
        tts = TextToSpeechFast(dtype=torch.bfloat16, device=args.device)

        def serve(fused, seed):
            return _timed(dev, lambda: tts.tts_batch(
                texts, use_deterministic_seed=seed, max_mel_tokens=args.tokens,
                gpt_fused_step=fused, verbose=False))[0]

        serve(False, 0), serve(True, 0)
        walls = {"fused_off": [], "fused_on": []}
        for i, fused in enumerate([False, True, True, False] * max(1, args.runs // 2)):
            w = serve(fused, i + 1)
            walls["fused_on" if fused else "fused_off"].append(w)
            print(f"run {i} fused={fused}: {w:.3f} s", file=sys.stderr)
        out[f"interleaved_batch{args.batch}"] = {
            k: {"p50_s": statistics.median(v), "all_s": v} for k, v in walls.items()}
        print(json.dumps(out))
        return out

    for gw in ("bf16", "int8"):
        b1_row = "fast_b1" if gw == "bf16" else "fast_b1_int8w"
        for fused in (False, True):
            key = "fused_on" if fused else "fused_off"
            tts = TextToSpeechFast(dtype=torch.bfloat16, gpt_weights=gw, gpt_fused_step=fused,
                                   device=args.device)

            def run(seed):
                return _row(*_timed(dev, lambda: tts.tts(
                    SENTENCE, use_deterministic_seed=seed, max_mel_tokens=args.tokens,
                    verbose=False)))

            out.setdefault(b1_row, {})[key] = _measure(run, args.runs)
            print(f"{b1_row} {key}: {out[b1_row][key]}", file=sys.stderr)
            if not args.skip_batch and gw == "bf16":
                def serve(seed):
                    return _row(*_timed(dev, lambda: tts.tts_batch(
                        texts, use_deterministic_seed=seed, max_mel_tokens=args.tokens,
                        verbose=False)))

                row = _measure(serve, max(2, args.runs - 2))
                row["throughput_audio_s_per_s"] = 1.0 / row["rtf"]
                out.setdefault(f"fast_batch{args.batch}", {})[key] = row
                print(f"fast_batch{args.batch} {key}: {row}", file=sys.stderr)
            del tts

    if not args.skip_quality:
        for row_name, kv_dtype in QUALITY_ROWS:
            for fused in (False, True):
                key = "fused_on" if fused else "fused_off"
                qtts = TextToSpeech(half=True, kv_cache_dtype=kv_dtype, gpt_fused_step=fused,
                                    device=args.device)

                def qrun(seed):
                    return _row(*_timed(dev, lambda: qtts.tts_with_preset(
                        SENTENCE, preset="standard", use_deterministic_seed=seed,
                        max_mel_tokens=args.tokens, verbose=False)))

                out.setdefault(row_name, {})[key] = _measure(qrun, args.quality_runs)
                out[row_name][key]["batch"] = qtts.autoregressive_batch_size
                print(f"{row_name} {key}: {out[row_name][key]}", file=sys.stderr)
                del qtts
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
