"""Dump (auto_latent, diffusion_latent) for a voice as a reusable .npz
(reference: tortoise/get_conditioning_latents.py).

Port of ``tortoise_tpu/apps/get_conditioning_latents.py``, flag for flag,
on the card; ``load_voice`` reads the .npz back as a latent voice.

    python3 -m tortoise_tpu_torch.apps.get_conditioning_latents --voice train_dotrice \\
        --output_path results/conditioning_latents
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--voice", default="pat")
    parser.add_argument("--output_path", default="../results/conditioning_latents")
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--extra_voice_dir", action="append", default=[])
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.utils.audio import load_voice, save_latents

    os.makedirs(args.output_path, exist_ok=True)
    tts = TextToSpeech(models_dir=args.model_dir, enable_redaction=False)
    for voice in args.voice.split(","):
        cond_paths, _ = load_voice(voice, args.extra_voice_dir)
        if cond_paths is None:
            raise SystemExit(f"voice '{voice}' has no audio clips")
        auto, diffusion = (x.float().cpu().numpy()
                           for x in tts.get_conditioning_latents(cond_paths))
        save_latents(os.path.join(args.output_path, f"{voice}.npz"), auto, diffusion)
        print(f"wrote {voice}.npz (auto {auto.shape}, diffusion {diffusion.shape})")


if __name__ == "__main__":
    main()
