"""Long-form reading on the fast pipeline (reference: tortoise/read_fast.py).

Port of ``tortoise_tpu/apps/read_fast.py``, flag for flag, on the card;
prints wall time and the realized real-time factor.

    python3 -m tortoise_tpu_torch.apps.read_fast --textfile book.txt --voice train_dotrice
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--textfile", required=True)
    parser.add_argument("--voice", default="random")
    parser.add_argument("--output_path", default="results/longform/")
    parser.add_argument("--output_name", default="combined.wav")
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--use_deepspeed", type=bool, default=False)
    parser.add_argument("--kv_cache", type=bool, default=True)
    parser.add_argument("--half", type=bool, default=True)
    parser.add_argument("--extra_voice_dir", action="append", default=[])
    parser.add_argument("--batch-size", type=int, default=8,
                        help="sentences synthesized concurrently through "
                             "tts_batch (0 = sequential, reference behavior)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    from tortoise_tpu_torch.apps.read import split_text
    from tortoise_tpu_torch.utils.audio import load_voices, save_wav

    tts = TextToSpeechFast(models_dir=args.model_dir)

    with open(args.textfile, encoding="utf-8") as f:
        text = " ".join([l for l in f.readlines()])
    texts = split_text(text)

    voice_outpath = os.path.join(args.output_path, args.voice)
    os.makedirs(voice_outpath, exist_ok=True)
    voice_samples, conditioning_latents = load_voices(args.voice.split("&"),
                                                      args.extra_voice_dir)
    if voice_samples is not None:
        conditioning_latents = tts.get_conditioning_latents(voice_samples)
        voice_samples = None

    all_parts = []
    t0 = time.time()
    if args.batch_size > 1 and len(texts) > 1:
        # groups of sentences decode as one candidate batch (tts_batch); the
        # last group pads with a dummy sentence, as the JAX CLI does
        g = args.batch_size
        wavs = []
        for i in range(0, len(texts), g):
            group = texts[i:i + g]
            pad = g - len(group)
            outs = tts.tts_batch(group + ["Padding."] * pad,
                                 conditioning_latents=conditioning_latents,
                                 use_deterministic_seed=args.seed, verbose=False)
            wavs.extend(outs[:len(group)])
        for j, wav in enumerate(wavs):
            wav = np.asarray(wav).squeeze()
            save_wav(os.path.join(voice_outpath, f"{j}.wav"), wav, 24000)
            all_parts.append(wav)
    else:
        for j, sentence in enumerate(texts):
            wav = tts.tts(sentence, voice_samples=voice_samples,
                          conditioning_latents=conditioning_latents,
                          use_deterministic_seed=args.seed, verbose=False)
            wav = np.asarray(wav).squeeze()
            save_wav(os.path.join(voice_outpath, f"{j}.wav"), wav, 24000)
            all_parts.append(wav)
    full = np.concatenate(all_parts)
    wall = time.time() - t0
    print(f"Generation time: {wall:.1f}s")
    print(f"Real-time factor (wall/audio): {wall / (len(full) / 24000):.3f}")
    save_wav(os.path.join(voice_outpath, args.output_name), full, 24000)


if __name__ == "__main__":
    main()
