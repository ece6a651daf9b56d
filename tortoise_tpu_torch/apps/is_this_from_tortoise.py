"""Tortoise-detect CLI (reference: tortoise/is_this_from_tortoise.py).

Port of ``tortoise_tpu/apps/is_this_from_tortoise.py``, flag for flag: the
classifier runs on the card, in float32.

    python3 -m tortoise_tpu_torch.apps.is_this_from_tortoise --clip clip.wav
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--clip", required=True)
    parser.add_argument("--model_dir", default=None)
    return parser


def main(argv=None) -> float:
    """Prints the classifier's verdict and returns its probability."""
    args = build_parser().parse_args(argv)

    from tortoise_tpu_torch.api import classify_audio_clip
    from tortoise_tpu_torch.utils.audio import load_audio

    clip = load_audio(args.clip, 24000)
    prob = classify_audio_clip(clip[0], models_dir=args.model_dir)
    print(f"This classifier thinks there is a {prob * 100:.2f}% chance that this "
          "clip was generated from Tortoise.")
    return prob


if __name__ == "__main__":
    main()
