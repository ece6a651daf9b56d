"""Audio loading, resampling, the voice registry and conditioning helpers.

Port of ``tortoise_tpu/utils/audio.py`` plus ``format_conditioning`` and
``deterministic_state`` from ``tortoise_tpu/api_fast.py``. Wav clips are read
with scipy and mp3 clips decoded by ffmpeg in a subprocess; resampling goes
through the port's ``native`` library when it builds and scipy's polyphase
resampler otherwise, exactly as in the JAX package. Voices come from
``BUILTIN_VOICES_DIR``, the library named by ``TORTOISE_EXTRA_VOICES_DIR``
and the directories given: clips (wav, mp3), latent files (``.npz``, the
reference's ``.pth``) and the decoded-clip cache ``<voice>.clips.npz``.
"""
from __future__ import annotations

import contextlib
import os
import random
import subprocess
import tempfile
import time
from glob import glob

import numpy as np
import torch
from scipy.io.wavfile import read as wav_read
from scipy.io.wavfile import write as wav_write
from scipy.signal import resample_poly

from tortoise_tpu_torch import native
from tortoise_tpu_torch.ops import mel as mel_ops

# The speaker clips (40 MB) stay one data directory of the repository, shared
# with the JAX package and read by path; they are data, not a module, and a
# copy would only double the tree.
BUILTIN_VOICES_DIR = os.path.join(os.path.dirname(os.path.realpath(__file__)), "..", "..",
                                  "tortoise_tpu", "voices")
# an optional voice library (for example the reference's voice folders); the
# decoded-clip cache is never written under it
EXTRA_VOICES_DIR = os.environ.get("TORTOISE_EXTRA_VOICES_DIR")


def load_wav(path: str) -> tuple[np.ndarray, int]:
    sr, data = wav_read(path)
    norms = {np.dtype(np.int32): 2 ** 31, np.dtype(np.int16): 2 ** 15}
    if data.dtype in norms:
        norm = norms[data.dtype]
    elif data.dtype in (np.float16, np.float32, np.float64):
        norm = 1.0
    elif data.dtype == np.uint8:
        data, norm = data.astype(np.int16) - 128, 128
    else:
        raise NotImplementedError(f"unsupported wav dtype: {data.dtype}")
    return data.astype(np.float32) / norm, sr


def _load_mp3(path: str, sampling_rate: int) -> np.ndarray:
    """Decode an mp3 to mono at ``sampling_rate`` with ffmpeg."""
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        try:
            subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-i", path,
                            "-ar", str(sampling_rate), "-ac", "1", tmp.name], check=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"decoding {path} requires ffmpeg; convert the clip to wav") \
                from e
        return load_wav(tmp.name)[0]


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return audio
    if audio.ndim == 1 and native.available():
        return native.resample(audio, orig_sr, target_sr)
    if audio.ndim == 2 and audio.shape[0] == 1 and native.available():
        return native.resample(audio[0], orig_sr, target_sr)[None]
    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def load_audio(path: str, sampling_rate: int) -> np.ndarray:
    """A wav or mp3 clip -> float32 (1, T) in [-1, 1] at ``sampling_rate``."""
    ext = os.path.splitext(path)[1].casefold()
    if ext == ".wav":
        audio, sr = load_wav(path)
    elif ext == ".mp3":
        audio, sr = _load_mp3(path, sampling_rate), sampling_rate
    else:
        raise AssertionError(f"unsupported audio format: {path}")
    if audio.ndim > 1:
        audio = audio[0] if audio.shape[0] < 5 else audio[:, 0]
    audio = resample(audio, sr, sampling_rate)
    # the JAX package's (and the reference's) warning for a clip that is
    # probably not [-1, 1] audio: a sample over 2, or none below 0
    if np.any(audio > 2) or not np.any(audio < 0):
        print(f"Error with {path}. Max={audio.max()} min={audio.min()}")
    return np.clip(audio, -1, 1)[None, :]


def save_wav(path: str, audio, sample_rate: int = 24000) -> None:
    """Write float32 samples (any shape that squeezes to 1-D) as a wav."""
    wav_write(path, sample_rate, np.asarray(audio, dtype=np.float32).squeeze())


def save_latents(path: str, auto, diffusion=None) -> None:
    """Conditioning latents -> an .npz that ``load_voice`` reads back."""
    if diffusion is None:
        np.savez(path, auto=np.asarray(auto))
    else:
        np.savez(path, auto=np.asarray(auto), diffusion=np.asarray(diffusion))


def pad_or_truncate(t: np.ndarray, length: int) -> np.ndarray:
    if t.shape[-1] == length:
        return t
    if t.shape[-1] < length:
        return np.pad(t, [(0, 0)] * (t.ndim - 1) + [(0, length - t.shape[-1])])
    return t[..., :length]


def get_voices(extra_voice_dirs: list[str] = ()) -> dict[str, list[str]]:
    voices: dict[str, list[str]] = {}
    for d in [BUILTIN_VOICES_DIR, EXTRA_VOICES_DIR, *extra_voice_dirs]:
        if not d or not os.path.isdir(d):
            continue
        for sub in sorted(os.listdir(d)):
            subj = os.path.join(d, sub)
            if os.path.isdir(subj):
                voices[sub] = [p for ext in ("wav", "mp3", "npz", "pth")
                               for p in sorted(glob(f"{subj}/*.{ext}"))]
    return voices


def _load_latents_file(path: str):
    """A latent voice file -> (auto, diffusion or None): the port's ``.npz``
    or the reference's ``.pth`` (a tensor or an (auto, diffusion) pair)."""
    if path.endswith(".npz"):
        z = np.load(path)
        return np.asarray(z["auto"]), np.asarray(z["diffusion"]) if "diffusion" in z else None
    data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, (tuple, list)):
        if len(data) >= 2 and data[1] is not None:
            return np.asarray(data[0]), np.asarray(data[1])
        return np.asarray(data[0]), None
    return np.asarray(data), None


def load_voice(voice: str, extra_voice_dirs: list[str] = ()):
    """-> (clips, latents): a list of (1, T) clips at 22.05 kHz, or an
    (auto, diffusion) latent pair from a voice that holds only a latent file.

    A clip voice's first load writes its decoded clips to
    ``<voice>.clips.npz`` beside them (never under ``EXTRA_VOICES_DIR``), and
    later loads read that cache; a write that fails is ignored."""
    if voice == "random":
        return None, None
    paths = get_voices(extra_voice_dirs)[voice]
    clip_caches = [p for p in paths if p.endswith(".clips.npz")]
    latent_files = [p for p in paths
                    if p.endswith((".npz", ".pth")) and not p.endswith(".clips.npz")]
    audio_files = [p for p in paths if p.endswith((".wav", ".mp3"))]
    if latent_files and not audio_files:
        return None, _load_latents_file(latent_files[0])
    if clip_caches:
        z = np.load(clip_caches[0])
        return [z[k] for k in sorted(z.files)], None
    clips = [load_audio(p, 22050) for p in audio_files]
    if clips and not (EXTRA_VOICES_DIR and os.path.realpath(audio_files[0]).startswith(
            os.path.realpath(EXTRA_VOICES_DIR))):
        cache = os.path.join(os.path.dirname(audio_files[0]), f"{voice}.clips.npz")
        part = f"{cache}.{os.getpid()}.part"   # renamed whole: no reader sees half a file
        try:
            with open(part, "wb") as f:
                np.savez(f, **{f"clip_{i:03d}": c for i, c in enumerate(clips)})
            os.replace(part, cache)
        except OSError:
            with contextlib.suppress(OSError):
                os.remove(part)
    return clips, None


def load_voices(voices: list[str], extra_voice_dirs: list[str] = ()):
    """Several voices: clips concatenate, latent voices average."""
    latents, clips = [], []
    for voice in voices:
        if voice == "random":
            return None, None
        clip, latent = load_voice(voice, extra_voice_dirs)
        if latent is None:
            clips.extend(clip)
        else:
            latents.append(latent)
        if clips and latents:
            raise ValueError("can only combine raw audio voices or latent voices, not both")
    if not latents:
        return clips, None
    auto = np.stack([a for a, _ in latents]).mean(axis=0)
    diff = [d for _, d in latents if d is not None]
    return None, (auto, np.stack(diff).mean(axis=0) if diff else None)


def deterministic_state(seed=None) -> int:
    """The seed of a synthesis (the clock when none is given)."""
    return int(time.time()) if seed is None else int(seed)


def format_conditioning(clip: np.ndarray, mel_norms, device, rng: random.Random,
                        cond_length: int = 132300) -> torch.Tensor:
    """22.05 kHz clip (1, T) -> (1, T_mel, 80) conditioning mel: crop (at an
    offset drawn from ``rng``) or pad to 6 s, then the tacotron mel."""
    gap = clip.shape[-1] - cond_length
    if gap < 0:
        clip = np.pad(clip, ((0, 0), (0, -gap)))
    elif gap > 0:
        start = rng.randint(0, gap)
        clip = clip[:, start:start + cond_length]
    wav = torch.as_tensor(np.ascontiguousarray(clip), dtype=torch.float32, device=device)
    return mel_ops.tacotron_mel(wav, mel_norms).transpose(1, 2)
