"""Tortoise's voice BPE tokenizer and the conditioning mel, for the reference.

The tokenizer is the reference's ``VoiceBpeTokenizer`` (HF ``tokenizers``
BPE over ``bpe_vocab.json``): the English cleaners, spaces as ``[SPACE]``,
the special tokens split out, HF ``Whitespace`` pre-tokens, then the
merges lowest rank first. The conditioning mel is the 22.05 kHz, 80-bin
"tacotron" mel (HTK scale, slaney norm, power 2, log floor 1e-5) divided by
the published ``mel_norms``, of a clip cropped (at an offset drawn from the
request's seed) or padded to 6 s (reference tortoise/api.py:258-299).
Both data files are read where the repository keeps them.
"""
from __future__ import annotations

import json
import os
import random
import re

import numpy as np
import torch

from portbench.reference.cleaners import english_cleaners

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                        "tortoise_tpu_torch", "data")
_PRE_TOKEN = re.compile(r"\w+|[^\w\s]+")
COND_LENGTH = 132300


class Tokenizer:
    def __init__(self, vocab_file: str = os.path.join(DATA_DIR, "bpe_vocab.json")):
        with open(vocab_file) as f:
            d = json.load(f)
        self.vocab = d["vocab"]
        self.unk = self.vocab[d["unk_token"]]
        self.ranks = {tuple(m.split(" ")) if isinstance(m, str) else tuple(m): i
                      for i, m in enumerate(d["merges"])}
        self.special = {t: self.vocab[t] for t in d.get("special_tokens", [])}
        self._special_re = re.compile("|".join(
            re.escape(t) for t in sorted(self.special, key=len, reverse=True)))

    def _bpe(self, word: str) -> list[int]:
        syms = [c if c in self.vocab else None for c in word]
        while len(syms) > 1:
            pairs = [(self.ranks.get((a, b)), i) for i, (a, b) in enumerate(zip(syms, syms[1:]))
                     if a is not None and b is not None]
            pairs = [p for p in pairs if p[0] is not None]
            if not pairs:
                break
            _, i = min(pairs)
            syms[i:i + 2] = [syms[i] + syms[i + 1]]
        return [self.unk if s is None else self.vocab[s] for s in syms]

    def encode(self, text: str) -> list[int]:
        text = english_cleaners(text).replace(" ", "[SPACE]")
        ids, pos = [], 0
        pieces = []
        for m in self._special_re.finditer(text):
            pieces.append((text[pos:m.start()], m.group(0)))
            pos = m.end()
        pieces.append((text[pos:], None))
        for plain, special in pieces:
            for word in _PRE_TOKEN.findall(plain):
                ids.extend(self._bpe(word))
            if special is not None:
                ids.append(self.special[special])
        return ids


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def tacotron_filterbank(sample_rate=22050, n_fft=1024, n_mels=80, fmin=0.0, fmax=8000.0):
    """librosa's ``mel(htk=True, norm="slaney")``: (n_mels, n_fft // 2 + 1)."""
    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz_htk(np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    fb = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


def conditioning_mels(clips, seed: int, device) -> torch.Tensor:
    """22.05 kHz clips, each (1, T) -> their (1, n_clips, frames, 80)
    conditioning mels; one ``random.Random(seed)`` draws the crops in turn."""
    rng = random.Random(seed)
    window = torch.hann_window(1024, periodic=True, device=device)
    fb = torch.as_tensor(tacotron_filterbank(), device=device)
    norms = torch.as_tensor(np.load(os.path.join(DATA_DIR, "mel_norms.npy")),
                            dtype=torch.float32, device=device)
    out = []
    for clip in clips:
        gap = clip.shape[-1] - COND_LENGTH
        if gap < 0:
            clip = np.pad(clip, ((0, 0), (0, -gap)))
        elif gap > 0:
            start = rng.randint(0, gap)
            clip = clip[:, start:start + COND_LENGTH]
        wav = torch.as_tensor(np.ascontiguousarray(clip), dtype=torch.float32, device=device)
        spec = torch.stft(wav, 1024, hop_length=256, win_length=1024, window=window,
                          center=True, pad_mode="reflect", return_complex=True).abs() ** 2
        mel = torch.log(torch.einsum("mf,bft->bmt", fb, spec).clamp(min=1e-5))
        out.append((mel / norms[:, None]).transpose(1, 2))
    return torch.stack(out, dim=1)
