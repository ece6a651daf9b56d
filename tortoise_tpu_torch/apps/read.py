"""Long-form reading CLI (reference: tortoise/read.py).

Port of ``tortoise_tpu/apps/read.py``, flag for flag, on the card: chunk a
text file into sentences, synthesize each chunk with shared voice latents,
write per-clip wavs plus a combined wav; '--regenerate' re-renders
selected clips.

    python3 -m tortoise_tpu_torch.apps.read --textfile book.txt --voice train_dotrice
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def split_text(text: str, desired_length=200, max_length=300):
    from tortoise_tpu_torch.utils.text import split_and_recombine_text

    if "|" in text:
        print("Found the '|' character in your text, which I will use as a cue for "
              "when to split it up. If this is not what you intended, please remove "
              "all '|' characters from the input.")
        return text.split("|")
    return split_and_recombine_text(text, desired_length, max_length)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--textfile", required=True)
    parser.add_argument("--voice", default="random")
    parser.add_argument("--output_path", default="results/longform/")
    parser.add_argument("--output_name", default="combined.wav")
    parser.add_argument("--preset", default="fast")
    parser.add_argument("--regenerate", default=None,
                        help="comma-separated list of clip indices to re-render")
    parser.add_argument("--candidates", type=int, default=1)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--produce_debug_state", type=bool, default=True)
    parser.add_argument("--use_deepspeed", type=bool, default=False)
    parser.add_argument("--kv_cache", type=bool, default=True)
    parser.add_argument("--half", type=bool, default=True)
    parser.add_argument("--extra_voice_dir", action="append", default=[])
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.utils.audio import load_audio, load_voices, save_wav

    with open(args.textfile, encoding="utf-8") as f:
        text = " ".join([l for l in f.readlines()])
    texts = split_text(text)
    tts = TextToSpeech(models_dir=args.model_dir, kv_cache=args.kv_cache, half=args.half,
                       enable_redaction=any("[" in t for t in texts))

    regenerate = None
    if args.regenerate is not None:
        regenerate = [int(e) for e in args.regenerate.split(",")]

    seed = args.seed
    voice_outpath = os.path.join(args.output_path, args.voice)
    os.makedirs(voice_outpath, exist_ok=True)
    voice_samples, conditioning_latents = load_voices(args.voice.split("&"),
                                                      args.extra_voice_dir)
    # Compute latents once, reuse across all chunks (reference read.py:66-81).
    if voice_samples is not None:
        conditioning_latents = tts.get_conditioning_latents(voice_samples)
        voice_samples = None

    all_parts = []
    for j, sentence in enumerate(texts):
        clip_path = os.path.join(voice_outpath, f"{j}.wav")
        if regenerate is not None and j not in regenerate and os.path.exists(clip_path):
            all_parts.append(load_audio(clip_path, 24000)[0])
            continue
        gen = tts.tts_with_preset(sentence, voice_samples=voice_samples,
                                  conditioning_latents=conditioning_latents,
                                  preset=args.preset, k=args.candidates,
                                  use_deterministic_seed=seed)
        if args.candidates == 1:
            wav = np.asarray(gen).squeeze()
            save_wav(clip_path, wav, 24000)
            all_parts.append(wav)
        else:
            candidate_dir = os.path.join(voice_outpath, str(j))
            os.makedirs(candidate_dir, exist_ok=True)
            for k_, g in enumerate(gen):
                save_wav(os.path.join(candidate_dir, f"{k_}.wav"),
                         np.asarray(g).squeeze(), 24000)

    if args.candidates == 1:
        full = np.concatenate(all_parts)
        save_wav(os.path.join(voice_outpath, args.output_name), full, 24000)

    if args.produce_debug_state:
        os.makedirs("debug_states", exist_ok=True)
        np.savez(os.path.join("debug_states", f"read_debug_{args.voice}.npz"),
                 seed=seed if seed is not None else -1, texts=np.array(texts, dtype=object))


if __name__ == "__main__":
    main()
