"""The quality pipeline's arithmetic around its models, written out plainly:
the presets, the candidates' stop-token fix and calm-token trim, the spaced
diffusion schedule, the ancestral sampler's last step with
conditioning-free guidance, and the mel's denormalization.

Reference tortoise/api.py:36-114 and 547-556 (presets, ``fix_autoregressive_output``,
the calm trim), tortoise/utils/diffusion.py (``get_named_beta_schedule``,
``space_timesteps``, ``p_mean_variance``) and tortoise/utils/audio.py
(``denormalize_tacotron_mel``).
"""
from __future__ import annotations

import numpy as np
import torch

CALM_TOKEN = 83
MEL_MAX, MEL_MIN = 2.3143386840820312, -11.512925148010254
# tortoise/api.py's tts() defaults and its presets
TTS_DEFAULTS = {"num_autoregressive_samples": 512, "diffusion_iterations": 100,
                "cond_free": True, "cond_free_k": 2.0, "diffusion_temperature": 1.0}
PRESETS = {
    "ultra_fast": {"num_autoregressive_samples": 16, "diffusion_iterations": 30,
                   "cond_free": False},
    "fast": {"num_autoregressive_samples": 96, "diffusion_iterations": 80},
    "standard": {"num_autoregressive_samples": 256, "diffusion_iterations": 200},
    "high_quality": {"num_autoregressive_samples": 256, "diffusion_iterations": 400},
}


def settings(kwargs: dict) -> dict:
    """The tts() settings a ``tts_with_preset`` call's keyword arguments give."""
    out = dict(TTS_DEFAULTS)
    out.update(PRESETS[kwargs.get("preset", "fast")])
    out.update({k: v for k, v in kwargs.items() if k in TTS_DEFAULTS})
    return out


def fix_codes(codes: np.ndarray, stop: int) -> np.ndarray:
    """Stop tokens and all after the first to the calm token, the last three
    codes 45, 45, 248 (a candidate with no stop token is left as it is)."""
    idx = np.where(codes == stop)[0]
    if len(idx) == 0:
        return codes
    codes = codes.copy()
    codes[int(idx[0]):] = CALM_TOKEN
    codes[-3:] = (45, 45, 248)
    return codes


def calm_trim(codes: np.ndarray) -> int:
    """Latent frames kept: up to where a run of more than 8 calm tokens ends."""
    run = 0
    for k, c in enumerate(codes):
        run = run + 1 if c == CALM_TOKEN else 0
        if run > 8:
            return k
    return len(codes)


def frames(latents: int) -> int:
    """24 kHz mel frames (and 256-sample hops) of ``latents`` latent frames."""
    return 4 * latents * 24000 // 22050


def spaced_timesteps(steps: int, total: int = 4000) -> list[int]:
    """The original timesteps kept by ``space_timesteps(total, [steps])``."""
    if steps == 1:
        return [0]
    stride = (total - 1) / (steps - 1)
    out, at = [], 0.0
    for _ in range(steps):
        out.append(round(at))
        at += stride
    return out


def alphas_cumprod(steps: int, total: int = 4000) -> np.ndarray:
    """ᾱ at each kept timestep of the linear schedule (float64)."""
    scale = 1000 / total
    betas = np.linspace(scale * 0.0001, scale * 0.02, total, dtype=np.float64)
    return np.cumprod(1.0 - betas)[spaced_timesteps(steps, total)]


def last_step(x, out, cond_free: bool, k: float, steps: int, rows: int,
              dtype=torch.float32):
    """The sampler's last step (t = 0) from its input ``x`` ((2B or B), T,
    100) and the model's output ``out`` ((2B or B), T, 200), in ``dtype``:
    the guided eps (the strength ramps to ``k`` at t = 0), x0 predicted and
    clipped; at t = 0 the posterior mean is x0 itself (its coefficients are
    1 and 0, the previous ᾱ being 1) and no noise is added."""
    ab0 = float(alphas_cumprod(steps)[0])
    c = out.shape[-1] // 2
    eps = out[:rows, :, :c].to(dtype)
    if cond_free:
        eps = (1 + k) * eps - k * out[rows:2 * rows, :, :c].to(dtype)
    x = x[:rows].to(dtype)
    return (float(np.sqrt(1 / ab0)) * x - float(np.sqrt(1 / ab0 - 1)) * eps).clamp(-1, 1)


def denormalize(mel: torch.Tensor) -> torch.Tensor:
    return (mel + 1) / 2 * (MEL_MAX - MEL_MIN) + MEL_MIN
