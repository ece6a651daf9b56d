"""Generation presets (reference: tortoise/api.py:320-331, api_fast.py:274-279).

A copy of ``tortoise_tpu/presets.py``: the port imports nothing of the JAX
package."""
from __future__ import annotations

COMMON_SETTINGS = {
    "temperature": 0.8,
    "length_penalty": 1.0,
    "repetition_penalty": 2.0,
    "top_p": 0.8,
    "cond_free_k": 2.0,
    "diffusion_temperature": 1.0,
}

QUALITY_PRESETS = {
    "ultra_fast": {"num_autoregressive_samples": 16, "diffusion_iterations": 30, "cond_free": False},
    "fast": {"num_autoregressive_samples": 96, "diffusion_iterations": 80},
    "standard": {"num_autoregressive_samples": 256, "diffusion_iterations": 200},
    "high_quality": {"num_autoregressive_samples": 256, "diffusion_iterations": 400},
}

FAST_PRESETS = {
    "ultra_fast": {"num_autoregressive_samples": 1, "diffusion_iterations": 10},
    "fast": {"num_autoregressive_samples": 32, "diffusion_iterations": 50},
    "standard": {"num_autoregressive_samples": 256, "diffusion_iterations": 200},
    "high_quality": {"num_autoregressive_samples": 256, "diffusion_iterations": 400},
}


def resolve_preset(preset: str, presets: dict, **overrides) -> dict:
    settings = dict(COMMON_SETTINGS)
    settings.update(presets[preset])
    settings.update(overrides)
    return settings
