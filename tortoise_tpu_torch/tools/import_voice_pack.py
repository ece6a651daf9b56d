"""Import a reference-layout voice library into the bundled voice pack.

Counterpart of ``tools/import_voice_pack.py``, flag for flag:

    python3 -m tortoise_tpu_torch.tools.import_voice_pack [--source DIR] [--dest DIR] \\
        [--latents] [--voices a,b,c]

Each voice is a folder of wav/mp3 clips (reference tortoise/utils/audio.py:
89-148). The default mode copies the clips verbatim (the clip audio is the
voice's identity: re-encoding would change the cloning) and converts any
``.pth`` latent file to the ``.npz`` latent format. ``--latents`` writes
latent-only ``.npz`` voices instead, computed with ``TextToSpeech.
get_conditioning_latents`` on the card; it refuses random weights (they
would bake noise into the latents), so it needs converted checkpoints
(``tools/fetch_weights``). ``--source`` defaults to
``$TORTOISE_EXTRA_VOICES_DIR``, ``--dest`` to the shared voices folder
(``utils/audio.BUILTIN_VOICES_DIR``). ``--device cpu`` runs ``--latents``
on the CPU (for tests).
"""
from __future__ import annotations

import argparse
import os
import shutil

from tortoise_tpu_torch.utils import audio


def import_clips(src: str, dst: str, names) -> list[str]:
    """Each voice folder of ``names`` under ``src``: its clips copied and
    its ``.pth`` latents converted into ``dst``/<voice>."""
    imported = []
    for name in names:
        sdir = os.path.join(src, name)
        if not os.path.isdir(sdir):
            continue
        ddir = os.path.join(dst, name)
        os.makedirs(ddir, exist_ok=True)
        for f in sorted(os.listdir(sdir)):
            sp = os.path.join(sdir, f)
            if f.endswith((".wav", ".mp3")):
                shutil.copyfile(sp, os.path.join(ddir, f))
            elif f.endswith(".pth"):
                audio.save_latents(os.path.join(ddir, f[:-4] + ".npz"),
                                   *audio._load_latents_file(sp))
        imported.append(name)
    return imported


def import_latents(src: str, dst: str, names, device: str = "cuda") -> list[str]:
    """Each voice folder's clips -> ``dst``/<voice>/<voice>.npz, the
    conditioning latents of the quality API with real weights."""
    from tortoise_tpu_torch.api import TextToSpeech

    tts = TextToSpeech(device=device, enable_redaction=False, allow_random_weights=False)
    imported = []
    for name in names:
        sdir = os.path.join(src, name)
        clips = [os.path.join(sdir, f) for f in sorted(os.listdir(sdir))
                 if f.endswith((".wav", ".mp3"))] if os.path.isdir(sdir) else []
        if not clips:
            continue
        auto, diff = tts.get_conditioning_latents([audio.load_audio(p, 22050) for p in clips])
        ddir = os.path.join(dst, name)
        os.makedirs(ddir, exist_ok=True)
        audio.save_latents(os.path.join(ddir, f"{name}.npz"), auto.float().cpu().numpy(),
                           diff.float().cpu().numpy())
        imported.append(name)
    return imported


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", default=audio.EXTRA_VOICES_DIR,
                        help="reference-layout voice library to import from")
    parser.add_argument("--dest", default=audio.BUILTIN_VOICES_DIR)
    parser.add_argument("--latents", action="store_true",
                        help="store computed conditioning latents, not clips "
                             "(requires real converted checkpoints)")
    parser.add_argument("--voices", default=None,
                        help="comma-separated subset (default: every folder)")
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> dict:
    """Returns {"dest": the folder, "voices": the voices imported}."""
    args = build_parser().parse_args(argv)
    if not args.source or not os.path.isdir(args.source):
        raise SystemExit(f"source voice library not found: {args.source}")
    names = args.voices.split(",") if args.voices else sorted(os.listdir(args.source))
    if args.latents:
        done = import_latents(args.source, args.dest, names, args.device)
    else:
        done = import_clips(args.source, args.dest, names)
    print(f"imported {len(done)} voices into {args.dest}: {', '.join(done)}")
    return {"dest": args.dest, "voices": done}


if __name__ == "__main__":
    main()
