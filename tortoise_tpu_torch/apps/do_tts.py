"""Single-phrase synthesis CLI (reference: tortoise/do_tts.py).

Port of ``tortoise_tpu/apps/do_tts.py``, flag for flag, on the card:
multi-voice (','), voice blending ('&'), k candidates, fixed seed and
debug-state dumps.

    python3 -m tortoise_tpu_torch.apps.do_tts --voice train_dotrice --preset ultra_fast
"""
from __future__ import annotations

import argparse
import os

import numpy as np

PRESETS = ["ultra_fast", "fast", "standard", "high_quality"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--text", default="The expressiveness of autoregressive "
                        "transformers is literally nuts! I absolutely adore them.")
    parser.add_argument("--voice", default="random",
                        help="comma-separated voices; use '&' to blend, e.g. 'a&b'")
    parser.add_argument("--preset", default="fast", choices=PRESETS)
    parser.add_argument("--use_deepspeed", type=bool, default=False,
                        help="accepted for reference-CLI compatibility (no-op)")
    parser.add_argument("--kv_cache", type=bool, default=True)
    parser.add_argument("--half", type=bool, default=True)
    parser.add_argument("--output_path", default="results/")
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--candidates", type=int, default=3)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--produce_debug_state", type=bool, default=True)
    parser.add_argument("--cvvp_amount", type=float, default=0.0)
    parser.add_argument("--extra_voice_dir", action="append", default=[])
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.utils.audio import load_voices, save_wav

    os.makedirs(args.output_path, exist_ok=True)
    tts = TextToSpeech(models_dir=args.model_dir, kv_cache=args.kv_cache, half=args.half,
                       enable_redaction="[" in args.text)

    selected_voices = args.voice.split(",")
    for k, selected_voice in enumerate(selected_voices):
        voice_sel = selected_voice.split("&") if "&" in selected_voice else [selected_voice]
        voice_samples, conditioning_latents = load_voices(voice_sel, args.extra_voice_dir)

        gen, dbg_state = tts.tts_with_preset(
            args.text, k=args.candidates, voice_samples=voice_samples,
            conditioning_latents=conditioning_latents, preset=args.preset,
            use_deterministic_seed=args.seed, return_deterministic_state=True,
            cvvp_amount=args.cvvp_amount)
        if isinstance(gen, list):
            for j, g in enumerate(gen):
                save_wav(os.path.join(args.output_path,
                                      f"{selected_voice}_{k}_{j}.wav"), g, 24000)
        else:
            save_wav(os.path.join(args.output_path, f"{selected_voice}_{k}.wav"),
                     gen, 24000)

        if args.produce_debug_state:
            os.makedirs("debug_states", exist_ok=True)
            np.savez(os.path.join("debug_states", f"do_tts_debug_{selected_voice}.npz"),
                     seed=dbg_state[0], text=dbg_state[1])


if __name__ == "__main__":
    main()
