"""Console entry point: the full-knob CLI (reference: scripts/tortoise_tts.py).

Port of ``tortoise_tpu/apps/main.py``, flag for flag: text from args or
stdin; --list-voices / --play / --output / --output-dir output modes;
multi-voice, voice blending and 'all'; chunked long-form with
--regenerate/--skip-existing; the complete tuning-knob passthrough group.
It runs on the card unless ``--device cpu`` asks for the CPU (the JAX CLI
parses --device and ignores it). ``--mesh`` is accepted and raises: the
multi-device paths are not ported yet (ROADMAP.md, Queue 1 item g).

    python3 -m tortoise_tpu_torch.apps.main --voice train_dotrice --preset ultra_fast \\
        -o out.wav "Hello there."
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

PRESETS = ["ultra_fast", "fast", "standard", "high_quality"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tortoise_tpu_torch",
        description="Tortoise text-to-speech on PyTorch and CUDA: synthesizes speech in "
                    "multiple voices with realistic prosody and intonation.")
    parser.add_argument("text", type=str, nargs="*",
                        help="Text to speak. If omitted, text is read from stdin.")
    parser.add_argument("-v", "--voice", type=str, default="random",
                        help="Voice(s): '&' joins, ',' separates, 'all' for every voice.")
    parser.add_argument("-V", "--voices-dir", dest="voices_dir", type=str, default=None,
                        help="Extra voice directories, comma-separated.")
    parser.add_argument("-p", "--preset", type=str, default="fast", choices=PRESETS)
    parser.add_argument("-q", "--quiet", action="store_true")
    out = parser.add_mutually_exclusive_group(required=True)
    out.add_argument("-l", "--list-voices", dest="list_voices", action="store_true")
    out.add_argument("-P", "--play", action="store_true")
    out.add_argument("-o", "--output", type=str, default=None)
    out.add_argument("-O", "--output-dir", dest="output_dir", type=str, default=None)
    parser.add_argument("--candidates", type=int, default=1)
    parser.add_argument("--regenerate", type=str, default=None)
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--produce-debug-state", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--models-dir", type=str, default=None)
    parser.add_argument("--text-split", type=str, default=None,
                        help="<desired_length>,<max_length> chunking override")
    parser.add_argument("--disable-redaction", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the default) or cpu")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--kv-cache-dtype", type=str, default="bf16",
                        choices=["bf16", "int8", "f32"],
                        help="int8 halves the decode's cache bytes and doubles the "
                             "candidate batch (bounded quantization error); f32 decodes "
                             "with the layer stack (pass --no-gpt-fused-step)")
    parser.add_argument("--gpt-weights", type=str, default="bf16",
                        choices=["bf16", "int8", "int8_decode"],
                        help="int8: weight-only GPT kernels everywhere "
                             "(faster small-batch decode, bounded error); "
                             "int8_decode: exact bf16 prefill + int8 stack "
                             "for the fused decode kernel only (quality API)")
    parser.add_argument("--gpt-fused-step", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="whole-step fused decode kernel K2 (bf16 or int8 "
                             "cache; default: on for CUDA); off, each layer's "
                             "decode attention is kernel K1")
    parser.add_argument("--mesh", type=str, default=None, metavar="DP[xTP]",
                        help="shard over a device mesh, e.g. --mesh 8 (dp=8) or --mesh 4x2 "
                             "(dp=4, tp=2): not ported to PyTorch yet, raises")
    for flag, typ in [("--num-autoregressive-samples", int), ("--temperature", float),
                      ("--length-penalty", float), ("--repetition-penalty", float),
                      ("--top-p", float), ("--max-mel-tokens", int),
                      ("--cvvp-amount", float), ("--diffusion-iterations", int),
                      ("--cond-free", lambda s: s.lower() in ("1", "true", "yes")),
                      ("--cond-free-k", float), ("--diffusion-temperature", float)]:
        parser.add_argument(flag, type=typ, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    extra_dirs = args.voices_dir.split(",") if args.voices_dir else []

    from tortoise_tpu_torch.utils.audio import get_voices, load_audio, load_voices, save_wav

    if args.list_voices:
        for v in sorted(get_voices(extra_dirs)):
            print(v)
        return 0
    if args.mesh:
        raise NotImplementedError("--mesh: sharding over a device mesh (parallel/*) is not "
                                  "ported to tortoise_tpu_torch yet (ROADMAP.md, Queue 1 item g)")

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.utils.text import split_and_recombine_text

    text = " ".join(args.text) if args.text else sys.stdin.read()
    if args.text_split:
        desired, maxlen = (int(x) for x in args.text_split.split(","))
        texts = split_and_recombine_text(text, desired, maxlen)
    else:
        texts = split_and_recombine_text(text)
    if not texts:
        print("no text provided", file=sys.stderr)
        return 1

    voices = sorted(get_voices(extra_dirs)) if args.voice == "all" \
        else args.voice.split(",")
    if len(voices) > 1 and not args.output_dir:
        print("multiple voices require --output-dir", file=sys.stderr)
        return 1

    tuning = {k: v for k, v in {
        "num_autoregressive_samples": args.num_autoregressive_samples,
        "temperature": args.temperature, "length_penalty": args.length_penalty,
        "repetition_penalty": args.repetition_penalty, "top_p": args.top_p,
        "max_mel_tokens": args.max_mel_tokens, "cvvp_amount": args.cvvp_amount,
        "diffusion_iterations": args.diffusion_iterations,
        "cond_free": args.cond_free, "cond_free_k": args.cond_free_k,
        "diffusion_temperature": args.diffusion_temperature,
    }.items() if v is not None}

    tts = TextToSpeech(models_dir=args.models_dir,
                       autoregressive_batch_size=args.batch_size,
                       kv_cache_dtype=args.kv_cache_dtype,
                       gpt_weights=args.gpt_weights,
                       gpt_fused_step=args.gpt_fused_step,
                       enable_redaction=not args.disable_redaction and "[" in text,
                       device=args.device)

    regenerate = [int(x) for x in args.regenerate.split(",")] if args.regenerate else None
    all_audio = []
    for voice in voices:
        voice_samples, conditioning_latents = load_voices(voice.split("&"), extra_dirs)
        if voice_samples is not None:
            conditioning_latents = tts.get_conditioning_latents(voice_samples)
        parts = []
        for j, chunk in enumerate(texts):
            clip_path = (os.path.join(args.output_dir, voice, f"{j}.wav")
                         if args.output_dir else None)
            if clip_path and os.path.exists(clip_path) and (
                    args.skip_existing or (regenerate and j not in regenerate)):
                parts.append(load_audio(clip_path, 24000)[0])
                continue
            gen = tts.tts_with_preset(chunk, preset=args.preset, k=args.candidates,
                                      conditioning_latents=conditioning_latents,
                                      use_deterministic_seed=args.seed,
                                      verbose=not args.quiet, **tuning)
            first = np.asarray(gen[0] if isinstance(gen, list) else gen).squeeze()
            parts.append(first)
            if clip_path:
                os.makedirs(os.path.dirname(clip_path), exist_ok=True)
                save_wav(clip_path, first, 24000)
                if isinstance(gen, list):
                    for c, g in enumerate(gen[1:], start=1):
                        save_wav(clip_path.replace(".wav", f"_c{c}.wav"),
                                 np.asarray(g).squeeze(), 24000)
        combined = np.concatenate(parts)
        all_audio.append(combined)
        if args.output_dir:
            save_wav(os.path.join(args.output_dir, voice, "combined.wav"), combined, 24000)

    if args.output:
        save_wav(args.output, all_audio[0], 24000)
    elif args.play:
        import sounddevice as sd

        sd.play(all_audio[0], 24000)
        sd.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
