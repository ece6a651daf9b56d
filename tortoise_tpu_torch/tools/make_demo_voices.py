"""Generate the bundled demo voices (deterministic, synthetic).

Counterpart of ``tools/make_demo_voices.py``, with ``--dest``:

    python3 -m tortoise_tpu_torch.tools.make_demo_voices [--dest DIR]

Two synthetic example voices, ``demo_alto`` and ``demo_bass`` (harmonic
vowel-like clips, original data), and the latent-only ``demo_latents``
(the ``.npz`` latent format; reference equivalent
tortoise/voices/cond_latent_example), from the JAX tool's seeds, so that
they come out bit for bit as the repository holds them. ``--dest``
defaults to the shared voices folder (``utils/audio.BUILTIN_VOICES_DIR``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from tortoise_tpu_torch.utils import audio

SR = 22050
# (f0, formant (center, bandwidth) pairs, seed) of each clip of each voice
VOICES = {
    "demo_alto": [(220.0, [(800, 80), (1150, 90), (2900, 120)], 1),
                  (196.0, [(400, 60), (800, 80), (2600, 120)], 2)],
    "demo_bass": [(110.0, [(600, 60), (1040, 80), (2250, 110)], 3),
                  (98.0, [(350, 50), (600, 70), (2400, 110)], 4)],
}


def vowel_clip(f0: float, formants, seconds: float, seed: int) -> np.ndarray:
    """Speech-shaped synthetic clip: a harmonic stack under a formant
    envelope with vibrato, slow amplitude modulation and a breath-noise
    floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * 5.3 * t)
    phase = np.cumsum(f0 * vibrato) / SR
    wav = np.zeros_like(t)
    for h in range(1, 40):
        fh = f0 * h
        if fh > 8000:
            break
        gain = sum(np.exp(-((fh - fc) ** 2) / (2 * bw ** 2)) for fc, bw in formants)
        wav += gain / h * np.sin(2 * np.pi * h * phase + rng.uniform(0, 2 * np.pi))
    wav += 0.01 * rng.standard_normal(t.shape)
    # syllable-ish amplitude envelope
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 2.1 * t + 1.0)
    edge = np.minimum(t / 0.05, 1.0) * np.minimum((t[-1] - t) / 0.05, 1.0)
    wav = wav * env * edge
    return (0.6 * wav / np.abs(wav).max()).astype(np.float32)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dest", default=audio.BUILTIN_VOICES_DIR)
    return parser


def main(argv=None) -> dict:
    """Returns {"written": the files written}."""
    args = build_parser().parse_args(argv)
    written = []
    for name, clips in VOICES.items():
        d = os.path.join(args.dest, name)
        os.makedirs(d, exist_ok=True)
        for i, (f0, formants, seed) in enumerate(clips, 1):
            path = os.path.join(d, f"{i}.wav")
            audio.save_wav(path, vowel_clip(f0, formants, 4.0, seed), SR)
            written.append(path)
    d = os.path.join(args.dest, "demo_latents")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(7)
    path = os.path.join(d, "demo_latents.npz")
    audio.save_latents(path, auto=(rng.standard_normal((1, 1024)) * 0.02).astype(np.float32),
                       diffusion=(rng.standard_normal((1, 2048)) * 0.02).astype(np.float32))
    written.append(path)
    for path in written:
        print("wrote", path)
    return {"written": written}


if __name__ == "__main__":
    main()
