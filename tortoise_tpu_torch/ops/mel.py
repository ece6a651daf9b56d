"""Mel-spectrogram front-end in PyTorch.

Port of ``tortoise_tpu/ops/mel.py``: the 22.05 kHz / 80-bin "tacotron" mel
for AR conditioning (power 2, HTK scale, slaney norm, log-clamp 1e-5,
divided by ``mel_norms``) and the 24 kHz / 100-bin "univnet" mel for the
diffusion conditioning (magnitude, slaney scale and norm, log-clamp). The
STFT is ``torch.stft`` with center=True, reflect padding and a periodic hann
window, which is what ``stft_magnitude`` computes with an rFFT. ``stft`` and
``istft`` are the JAX package's complex transform pair (the reference's
``utils/stft.py`` STFT class), framed by hand as there.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

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


@functools.lru_cache(maxsize=None)
def _hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """A periodic Hann window of ``win_length`` centred in ``n_fft`` zeros."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    pad = (n_fft - win_length) // 2
    return np.pad(w, (pad, n_fft - win_length - pad)).astype(np.float32)


def stft(x, n_fft: int, hop: int, win_length: int, center: bool = True):
    """Complex STFT of a real signal: (..., T) -> (..., n_fft // 2 + 1,
    frames), reflect-padded by n_fft // 2 under ``center``, every frame times
    the window (``tortoise_tpu/ops/mel.py::stft``)."""
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)
    frames = x.unfold(-1, n_fft, hop)                       # (..., frames, n_fft)
    win = torch.as_tensor(_hann_window(win_length, n_fft), device=x.device, dtype=x.dtype)
    return torch.fft.rfft(frames * win, n=n_fft, dim=-1).transpose(-1, -2)


@functools.lru_cache(maxsize=None)
def _window_sumsquare(win_length: int, n_fft: int, hop: int, n_frames: int) -> np.ndarray:
    """The squared window overlap-added over n_frames frames, in float64
    and rounded once (the reference's ``window_sumsquare``)."""
    w2 = _hann_window(win_length, n_fft).astype(np.float64) ** 2
    out = np.zeros(n_fft + hop * (n_frames - 1), np.float64)
    for f in range(n_frames):
        out[f * hop:f * hop + n_fft] += w2
    return out.astype(np.float32)


def istft(spec, n_fft: int, hop: int, win_length: int, length: int | None = None,
          center: bool = True):
    """Inverse of ``stft``: complex (..., n_freqs, frames) -> real (..., T).
    Each frame's inverse rFFT times the window, overlap-added, divided by
    the window's sum of squares where that exceeds 1e-11, the centre's
    padding trimmed, then cut to ``length`` (``tortoise_tpu/ops/mel.py::istft``)."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * torch.as_tensor(_hann_window(win_length, n_fft), device=frames.device,
                                      dtype=frames.dtype)
    *lead, n_frames, _ = frames.shape
    out_len = n_fft + hop * (n_frames - 1)
    sig = F.fold(frames.reshape(-1, n_frames, n_fft).transpose(1, 2), (1, out_len),
                 (1, n_fft), stride=(1, hop)).reshape(*lead, out_len)
    wss = _window_sumsquare(win_length, n_fft, hop, n_frames)
    sig = sig / torch.as_tensor(np.where(wss > 1e-11, wss, 1.0).astype(np.float32),
                                device=sig.device, dtype=sig.dtype)
    if center:
        sig = sig[..., n_fft // 2:out_len - n_fft // 2]
    return sig if length is None else sig[..., :length]


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
