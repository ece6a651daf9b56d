"""Diffusion training losses: epsilon-MSE plus the variational bound on the
learned-range variance, its mean frozen.

Port of ``tortoise_tpu/diffusion/losses.py`` (reference
tortoise/utils/diffusion.py:781-916). Schedule arrays are float64 numpy;
each is cast to float32 before it is indexed, as the JAX package's
``_extract`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from tortoise_tpu_torch.diffusion.schedule import DiffusionSchedule


def _extract(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = torch.as_tensor(np.asarray(arr, np.float32), device=t.device)[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_sample(schedule: DiffusionSchedule, x_start, t, noise):
    """Sample q(x_t | x_0) (reference diffusion.py:272-290)."""
    return (_extract(schedule.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + _extract(schedule.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal gaussians, in nats (reference diffusion.py:24-45)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _mean_flat(x):
    return x.reshape(x.shape[0], -1).mean(dim=1)


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of a discretized (8-bit) gaussian, the CDF by its tanh
    approximation (reference :48-86). The clamps keep every branch finite:
    ``torch.where`` gives the branch it did not take a zero gradient, but an
    inf there would still turn into NaN in the backward."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / 255.0)
    min_in = inv_stdv * (centered - 1.0 / 255.0)
    cdf = lambda z: 0.5 * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (z + 0.044715 * z ** 3)))
    cdf_plus, cdf_min = cdf(plus_in), cdf(min_in)
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   torch.log(cdf_delta.clamp(min=1e-12))))


def _p_mean_variance_from_out(schedule, x_t, t, eps, var_values):
    nd = x_t.ndim
    min_log = _extract(schedule.posterior_log_variance_clipped, t, nd)
    max_log = _extract(np.log(schedule.betas), t, nd)
    frac = (var_values + 1) / 2
    model_log_variance = frac * max_log + (1 - frac) * min_log
    pred_xstart = (_extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t
                   - _extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd) * eps)
    mean = (_extract(schedule.posterior_mean_coef1, t, nd) * pred_xstart
            + _extract(schedule.posterior_mean_coef2, t, nd) * x_t)
    return mean, model_log_variance


def vb_terms_bpd(schedule: DiffusionSchedule, x_start, x_t, t, eps, var_values):
    """Variational-bound term in bits per dim (reference :781-828): the
    decoder NLL at t == 0, the KL to the true posterior elsewhere."""
    nd = x_t.ndim
    true_mean = (_extract(schedule.posterior_mean_coef1, t, nd) * x_start
                 + _extract(schedule.posterior_mean_coef2, t, nd) * x_t)
    true_logvar = _extract(schedule.posterior_log_variance_clipped, t, nd)
    mean, logvar = _p_mean_variance_from_out(schedule, x_t, t, eps, var_values)
    kl = _mean_flat(normal_kl(true_mean, true_logvar, mean, logvar)) / np.log(2.0)
    decoder_nll = -_mean_flat(discretized_gaussian_log_likelihood(
        x_start, mean, 0.5 * logvar)) / np.log(2.0)
    return torch.where(t == 0, decoder_nll, kl)


def training_losses(model_fn, schedule: DiffusionSchedule, x_start, t, noise=None,
                    generator: torch.Generator | None = None, rescale_vb: bool = False):
    """MSE + frozen-mean VB loss of an epsilon / learned-range model.

    model_fn(x_t, t_orig) -> (B, T, 2C); x_start (B, T, C); t (B,) spaced
    steps. ``noise`` is given, or drawn from ``generator``. Returns the
    per-sample terms {"loss", "mse", "vb"}, each (B,)."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                            dtype=x_start.dtype)
    x_t = q_sample(schedule, x_start, t, noise)
    t_orig = torch.as_tensor(schedule.timestep_map, device=t.device)[t]
    out = model_fn(x_t, t_orig)
    c = out.shape[-1] // 2
    eps, var_values = out[..., :c], out[..., c:]
    vb = vb_terms_bpd(schedule, x_start, x_t, t, eps.detach(), var_values)
    if rescale_vb:
        vb = vb * schedule.num_timesteps / 1000.0
    mse = _mean_flat((noise - eps) ** 2)
    return {"loss": mse + vb, "mse": mse, "vb": vb}
