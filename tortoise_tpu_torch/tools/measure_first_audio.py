"""Time to the first audio of ``tts_stream`` on the GPU.

Counterpart of ``tools/measure_first_audio.py``, flag for flag. The first
chunk is the prompt's prefill, ``--first`` decode steps and one windowed
HiFi-GAN decode, so its knobs are the first segment's length and the GPT
weights' dtype (a B=1 decode step reads every weight once). The reference
claims under 500 ms to the first chunk on a 4 GB GPU (reference
README.md:34).

Over ``--runs`` streams after a warm-up one (a full-width TextToSpeechFast,
seeded random weights, a random voice) it reports the time to the first
chunk (median and minimum; host clock from the call to the first yielded
CPU tensor), the first chunk's audio seconds, and the stream's cadence: the
median wait between later chunks beside their median audio seconds, and
the stream's wall over its audio seconds (the sustained real-time factor).

    python3 -m tortoise_tpu_torch.tools.measure_first_audio [--first 16] [--chunk 40] \\
        [--gpt-weights bf16|int8] [--runs 5] [--text "..."]

``--device cpu`` runs the plain versions (for tests).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tortoise_tpu_torch.api_fast import TextToSpeechFast
from tortoise_tpu_torch.utils import measure


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--first", type=int, default=16,
                        help="first_chunk_size (AR tokens before the first chunk)")
    parser.add_argument("--chunk", type=int, default=40)
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--gpt-weights", default="bf16", choices=["bf16", "int8"])
    parser.add_argument("--text", default="Thanks for asking, I would love to "
                        "tell you more about that topic.")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = measure.cuda_device(args.device, "measure_first_audio")
    tts = TextToSpeechFast(gpt_weights=args.gpt_weights, device=args.device)

    def one_run(seed):
        """(s to the first chunk, its audio s, the stream's audio s, its wall s,
        every chunk finite, [(s since the chunk before, audio s)] of the
        later chunks)."""
        t0 = last = time.perf_counter()
        first, samples, finite, later = None, 0, True, []
        for chunk in tts.tts_stream(args.text, use_deterministic_seed=seed,
                                    first_chunk_size=args.first, stream_chunk_size=args.chunk,
                                    verbose=False):
            now = time.perf_counter()
            if first is None:
                first = (now - t0, len(chunk) / 24000.0)
            else:
                later.append((now - last, len(chunk) / 24000.0))
            last = now
            samples += len(chunk)
            finite = finite and bool(torch.isfinite(chunk).all())
        return first[0], first[1], samples / 24000.0, last - t0, finite, later

    one_run(0)
    rows = [one_run(i + 1) for i in range(args.runs)]
    firsts = sorted(r[0] for r in rows)
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "first": args.first, "chunk": args.chunk, "gpt_weights": args.gpt_weights,
           "runs": args.runs,
           "first_audio_s_median": firsts[len(firsts) // 2], "first_audio_s_min": firsts[0],
           "first_chunk_audio_s": float(np.median([r[1] for r in rows])),
           "stream_audio_s": float(np.median([r[2] for r in rows])),
           "stream_rtf": float(np.median([r[3] / r[2] for r in rows])),
           "chunk_gap_s_median": float(np.median([g for r in rows for g, _ in r[5]] or [0.0])),
           "chunk_audio_s_median": float(np.median([a for r in rows for _, a in r[5]] or [0.0])),
           "finite": all(r[4] for r in rows)}
    print(f"first-audio latency: median {res['first_audio_s_median'] * 1e3:.1f} ms, "
          f"min {res['first_audio_s_min'] * 1e3:.1f} ms (first={args.first} tokens, "
          f"gpt_weights={args.gpt_weights})")
    print(f"first chunk audio:   {res['first_chunk_audio_s']:.2f} s")
    print(f"later chunks:        every {res['chunk_gap_s_median'] * 1e3:.1f} ms, "
          f"{res['chunk_audio_s_median']:.2f} s of audio each (medians)")
    print(f"sustained stream:    RTF {res['stream_rtf']:.3f} ({res['stream_audio_s']:.1f} s "
          f"audio/run)")
    return res


if __name__ == "__main__":
    main()
