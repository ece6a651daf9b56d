"""Mel-spectrogram front-end in PyTorch.

Port of ``tortoise_tpu/ops/mel.py``: the 22.05 kHz / 80-bin "tacotron" mel
for AR conditioning (power 2, HTK scale, slaney norm, log-clamp 1e-5,
divided by ``mel_norms``) and the 24 kHz / 100-bin "univnet" mel for the
diffusion conditioning (magnitude, slaney scale and norm, log-clamp). The
STFT is ``torch.stft`` with center=True, reflect padding and a periodic hann
window, which is what ``stft_magnitude`` computes with an rFFT.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

TACOTRON_MEL_MAX = 2.3143386840820312
TACOTRON_MEL_MIN = -11.512925148010254

DEFAULT_MEL_NORMS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data",
                                      "mel_norms.npy")


def normalize_tacotron_mel(mel):
    return 2.0 * ((mel - TACOTRON_MEL_MIN) / (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN)) - 1.0


def denormalize_tacotron_mel(norm_mel):
    return ((norm_mel + 1.0) / 2.0) * (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN) + TACOTRON_MEL_MIN


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        return np.where(f >= 1000.0, min_log_mel + np.log(f / 1000.0) / logstep, f / f_sp)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, 1000.0 * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                   htk: bool = False, slaney_norm: bool = True) -> np.ndarray:
    """Triangular mel filterbank (n_mels, n_fft // 2 + 1), float32."""
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1, dtype=np.float64)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2),
                        htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    fb = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    if slaney_norm:
        fb = fb * (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return fb.astype(np.float32)


def stft_magnitude(x, n_fft: int, hop: int, win_length: int, power: float = 1.0):
    """(B, T) -> (B, n_freqs, n_frames) magnitude (power 1) or power spectrogram."""
    window = torch.hann_window(win_length, periodic=True, dtype=torch.float32, device=x.device)
    spec = torch.stft(x.float(), n_fft, hop_length=hop, win_length=win_length, window=window,
                      center=True, pad_mode="reflect", onesided=True, return_complex=True)
    mag = spec.abs()
    return mag if power == 1.0 else mag ** power


def _apply_filterbank(fb: np.ndarray, spec):
    return torch.einsum("mf,bft->bmt", torch.as_tensor(fb, device=spec.device), spec)


def tacotron_mel(wav, mel_norms=None):
    """(B, T) in [-1, 1] at 22.05 kHz -> (B, 80, frames)."""
    fb = mel_filterbank(22050, 1024, 80, 0.0, 8000.0, htk=True, slaney_norm=True)
    mel = _apply_filterbank(fb, stft_magnitude(wav, 1024, 256, 1024, power=2.0))
    mel = torch.log(mel.clamp(min=1e-5))
    if mel_norms is not None:
        mel = mel / mel_norms.to(mel.device)[:, None]
    return mel


def univnet_mel(wav, do_normalization: bool = False):
    """(B, T) in [-1, 1] at 24 kHz -> (B, 100, frames)."""
    fb = mel_filterbank(24000, 1024, 100, 0.0, 12000.0, htk=False, slaney_norm=True)
    mel = _apply_filterbank(fb, stft_magnitude(wav.clamp(-1.0, 1.0), 1024, 256, 1024))
    mel = torch.log(mel.clamp(min=1e-5))
    return normalize_tacotron_mel(mel) if do_normalization else mel


def load_mel_norms(path: str = DEFAULT_MEL_NORMS_FILE) -> torch.Tensor:
    """The 80-bin normalization statistics (.npy)."""
    return torch.as_tensor(np.load(path), dtype=torch.float32)
