"""Gaussian diffusion sampling loops (ancestral p-sample and DDIM).

Port of ``tortoise_tpu/diffusion/sampler.py`` (reference
tortoise/utils/diffusion.py:312-780): a Python loop over the spaced
schedule from ``diffusion/schedule.py``. Conditioning-free
guidance runs the cond and uncond halves in ONE model call on a doubled
batch, with the ramped strength cfk = k (1 - t/T). Step noise comes from an
explicit ``torch.Generator``; for a batch split over dp (``shard``, a
``parallel.mesh.BatchShard``) it is drawn at the global batch's shape and
this rank's rows taken, so each row gets the noise it gets unsplit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from tortoise_tpu_torch.diffusion.schedule import DiffusionSchedule
from tortoise_tpu_torch.parallel.mesh import draw_rows


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    cond_free: bool = True
    cond_free_k: float = 2.0
    ramp_conditioning_free: bool = True
    clip_denoised: bool = True
    eta: float = 0.0          # ddim only
    noise_scale: float = 1.0  # ancestral only; 0 gives the mean trajectory


def _tables(schedule: DiffusionSchedule) -> dict[str, np.ndarray]:
    f = lambda a: np.asarray(a, np.float32)
    return {
        "timestep_map": np.asarray(schedule.timestep_map, np.int64),
        "sqrt_recip": f(schedule.sqrt_recip_alphas_cumprod),
        "sqrt_recipm1": f(schedule.sqrt_recipm1_alphas_cumprod),
        "post_logvar": f(schedule.posterior_log_variance_clipped),
        "post_coef1": f(schedule.posterior_mean_coef1),
        "post_coef2": f(schedule.posterior_mean_coef2),
        "log_betas": f(np.log(schedule.betas)),
        "alphas_cumprod": f(schedule.alphas_cumprod),
        "alphas_cumprod_prev": f(schedule.alphas_cumprod_prev),
    }


def _model_out(model_fn, x, t_orig, cfg: SamplerConfig, cfk: float):
    """One (CFG-doubled when cond_free) model call -> (eps, var_values)."""
    if cfg.cond_free:
        b = x.shape[0]
        out = model_fn(torch.cat([x, x]), torch.cat([t_orig, t_orig]))
        c = out.shape[-1] // 2
        eps = (1 + cfk) * out[:b, :, :c] - cfk * out[b:, :, :c]
        return eps, out[:b, :, c:]
    out = model_fn(x, t_orig)
    c = out.shape[-1] // 2
    return out[:, :, :c], out[:, :, c:]


def _p_mean_variance(tab, x, t: int, eps, var_values, clip_denoised: bool):
    g = lambda name: float(tab[name][t])
    frac = (var_values + 1) / 2
    model_log_variance = frac * g("log_betas") + (1 - frac) * g("post_logvar")
    pred_xstart = g("sqrt_recip") * x - g("sqrt_recipm1") * eps
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1, 1)
    mean = g("post_coef1") * pred_xstart + g("post_coef2") * x
    return mean, model_log_variance, pred_xstart


def _step_noise(x, generator: torch.Generator, shard):
    return draw_rows(lambda n: torch.randn((n, *x.shape[1:]), generator=generator,
                                           device=x.device, dtype=x.dtype), x.shape[0], shard)


def _loop(step, schedule: DiffusionSchedule, cfg: SamplerConfig, model_fn: Callable,
          noise, generator):
    tab = _tables(schedule)
    n = schedule.num_timesteps
    x = noise
    for t in range(n - 1, -1, -1):
        t_orig = torch.full((x.shape[0],), int(tab["timestep_map"][t]), device=x.device)
        cfk = cfg.cond_free_k * (1 - t / n) if cfg.ramp_conditioning_free else cfg.cond_free_k
        eps, var_values = _model_out(model_fn, x, t_orig, cfg, cfk)
        x = step(tab, x, t, eps.float(), var_values.float(), generator)
    return x


def p_sample_loop(model_fn: Callable, schedule: DiffusionSchedule, noise,
                  generator: torch.Generator, cfg: SamplerConfig = SamplerConfig(),
                  shard=None):
    """Ancestral sampling from ``noise`` (B, T, C). ``model_fn(x, t_orig)``
    returns (B, T, 2C); with ``cfg.cond_free`` it gets the doubled batch."""
    def step(tab, x, t, eps, var_values, gen):
        mean, logvar, _ = _p_mean_variance(tab, x, t, eps, var_values, cfg.clip_denoised)
        if t == 0 or cfg.noise_scale == 0:
            return mean
        z = _step_noise(x, gen, shard)
        return mean + cfg.noise_scale * torch.exp(0.5 * logvar) * z

    return _loop(step, schedule, cfg, model_fn, noise, generator)


def ddim_sample_loop(model_fn: Callable, schedule: DiffusionSchedule, noise,
                     generator: torch.Generator, cfg: SamplerConfig = SamplerConfig(),
                     shard=None):
    """DDIM (reference diffusion.py:624-780); deterministic at eta=0."""
    def step(tab, x, t, eps_m, var_values, gen):
        _, _, pred_xstart = _p_mean_variance(tab, x, t, eps_m, var_values, cfg.clip_denoised)
        eps = (float(tab["sqrt_recip"][t]) * x - pred_xstart) / float(tab["sqrt_recipm1"][t])
        ab = float(tab["alphas_cumprod"][t])
        ab_prev = float(tab["alphas_cumprod_prev"][t])
        sigma = float(cfg.eta * np.sqrt((1 - ab_prev) / (1 - ab)) * np.sqrt(1 - ab / ab_prev))
        mean_pred = pred_xstart * float(np.sqrt(ab_prev)) \
            + float(np.sqrt(1 - ab_prev - sigma ** 2)) * eps
        if t == 0 or sigma == 0:
            return mean_pred
        z = _step_noise(x, gen, shard)
        return mean_pred + sigma * z

    return _loop(step, schedule, cfg, model_fn, noise, generator)
