"""TSV-driven batch synthesis for evaluation (reference: tortoise/eval.py).

Port of ``tortoise_tpu/apps/eval.py``, flag for flag, on the card: each
line of --eval_path is ``text<TAB>path_to_real_clip``; the real clip
conditions the synthesis and the wavs land in --output_path. ``--cer``
scores every clip with the wav2vec2-CTC aligner (its greedy transcript's
character error rate against the prompt) into
``<output_path>/results.tsv`` as ``index<TAB>cer<TAB>text``; with no
wav2vec2 checkpoint in --model_dir it warns and skips the scoring.

    python3 -m tortoise_tpu_torch.apps.eval --eval_path lines.tsv --preset ultra_fast --cer
"""
from __future__ import annotations

import argparse
import os
import warnings


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--eval_path", required=True, help="TSV of text<TAB>clip")
    parser.add_argument("--output_path", default="results/eval")
    parser.add_argument("--preset", default="standard")
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--cer", action="store_true",
                        help="score clips with wav2vec2-CTC (char error rate "
                             "vs prompt) into <output_path>/results.tsv")
    return parser


def evaluate_clips(rows, aligner, sample_rate=24000):
    """-> list of (index, cer, text) for ``rows`` of (index, wav, text)."""
    from tortoise_tpu_torch.utils.wav2vec_alignment import character_error_rate

    results = []
    for i, wav, text in rows:
        hyp = aligner.transcribe(wav, audio_sample_rate=sample_rate)
        results.append((i, character_error_rate(text, hyp), text))
    return results


def main(argv=None):
    """Returns the (index, cer, text) rows written to results.tsv, or None
    without --cer or when the scoring was skipped."""
    args = build_parser().parse_args(argv)

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.utils.audio import load_audio, save_wav

    os.makedirs(args.output_path, exist_ok=True)
    tts = TextToSpeech(models_dir=args.model_dir)

    with open(args.eval_path, encoding="utf-8") as f:
        lines = [l.strip() for l in f if l.strip()]
    clips = []
    for i, line in enumerate(lines):
        text, real = line.split("\t")
        conds = [load_audio(real, 22050)]
        gen = tts.tts_with_preset(text, voice_samples=conds, conditioning_latents=None,
                                  preset=args.preset)
        save_wav(os.path.join(args.output_path, f"{i}.wav"), gen, 24000)
        if args.cer:  # only the scorer needs the audio kept in memory
            clips.append((i, gen.numpy(), text))

    if args.cer:
        from tortoise_tpu_torch.utils.wav2vec_alignment import Wav2VecAlignment

        try:  # the redaction's aligner scores too: one wav2vec2 on the card
            aligner = tts.aligner or Wav2VecAlignment(models_dir=args.model_dir,
                                                      device=tts.device)
            results = evaluate_clips(clips, aligner)
        except FileNotFoundError as e:
            warnings.warn(f"--cer skipped: {e}")
            return None
        out = os.path.join(args.output_path, "results.tsv")
        with open(out, "w", encoding="utf-8") as f:
            for i, cer, text in results:
                f.write(f"{i}\t{cer:.4f}\t{text}\n")
        mean = sum(c for _, c, _ in results) / max(len(results), 1)
        print(f"mean CER {mean:.4f} over {len(results)} clips -> {out}")
        return results
    return None


if __name__ == "__main__":
    main()
