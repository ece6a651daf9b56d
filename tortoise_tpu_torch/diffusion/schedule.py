"""Diffusion noise schedules and timestep spacing.

A copy of ``tortoise_tpu/diffusion/schedule.py``: the port imports nothing
of the JAX package.

Numpy-side computation of everything the Gaussian diffusion sampler needs,
matching the vendored improved-diffusion math in the reference
(tortoise/utils/diffusion.py:94-118 beta schedules, :175-255 coefficient
tables, :1093-1149 SpacedDiffusion re-derivation, :1152-1205
space_timesteps). The resulting coefficient tables are plain numpy arrays
that the samplers read.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """Pick ``section_counts`` timesteps from ``num_timesteps`` original steps
    (per-section even striding; "ddimN" for DDIM-paper striding)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired_count} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep coefficient tables, float64 numpy.

    For a spaced schedule, index ``t`` runs over the *spaced* steps
    (0..num_timesteps-1) and ``timestep_map[t]`` gives the original-process
    timestep fed to the model.
    """
    betas: np.ndarray
    timestep_map: np.ndarray  # spaced index -> original timestep
    original_num_steps: int

    # Derived tables
    alphas_cumprod: np.ndarray = dataclasses.field(init=False)
    alphas_cumprod_prev: np.ndarray = dataclasses.field(init=False)
    alphas_cumprod_next: np.ndarray = dataclasses.field(init=False)
    sqrt_alphas_cumprod: np.ndarray = dataclasses.field(init=False)
    sqrt_one_minus_alphas_cumprod: np.ndarray = dataclasses.field(init=False)
    log_one_minus_alphas_cumprod: np.ndarray = dataclasses.field(init=False)
    sqrt_recip_alphas_cumprod: np.ndarray = dataclasses.field(init=False)
    sqrt_recipm1_alphas_cumprod: np.ndarray = dataclasses.field(init=False)
    posterior_variance: np.ndarray = dataclasses.field(init=False)
    posterior_log_variance_clipped: np.ndarray = dataclasses.field(init=False)
    posterior_mean_coef1: np.ndarray = dataclasses.field(init=False)
    posterior_mean_coef2: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        set_ = object.__setattr__
        set_(self, "alphas_cumprod", acp)
        set_(self, "alphas_cumprod_prev", acp_prev)
        set_(self, "alphas_cumprod_next", acp_next)
        set_(self, "sqrt_alphas_cumprod", np.sqrt(acp))
        set_(self, "sqrt_one_minus_alphas_cumprod", np.sqrt(1.0 - acp))
        set_(self, "log_one_minus_alphas_cumprod", np.log(1.0 - acp))
        set_(self, "sqrt_recip_alphas_cumprod", np.sqrt(1.0 / acp))
        set_(self, "sqrt_recipm1_alphas_cumprod", np.sqrt(1.0 / acp - 1))
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        set_(self, "posterior_variance", post_var)
        set_(self, "posterior_log_variance_clipped", np.log(np.append(post_var[1], post_var[1:])))
        set_(self, "posterior_mean_coef1", betas * np.sqrt(acp_prev) / (1.0 - acp))
        set_(self, "posterior_mean_coef2", (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp))

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def full_schedule(schedule_name: str = "linear", num_steps: int = 4000) -> DiffusionSchedule:
    betas = get_named_beta_schedule(schedule_name, num_steps)
    return DiffusionSchedule(betas=betas, timestep_map=np.arange(num_steps), original_num_steps=num_steps)


def spaced_schedule(schedule_name: str = "linear", trained_steps: int = 4000,
                    desired_steps: int | str = 200) -> DiffusionSchedule:
    """Re-derive betas over a subset of timesteps (reference diffusion.py:1104-1117)."""
    if isinstance(desired_steps, int):
        use_timesteps = space_timesteps(trained_steps, [desired_steps])
    else:
        use_timesteps = space_timesteps(trained_steps, desired_steps)
    base = get_named_beta_schedule(schedule_name, trained_steps)
    alphas_cumprod = np.cumprod(1.0 - base, axis=0)
    last = 1.0
    new_betas, tmap = [], []
    for i, acp in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - acp / last)
            last = acp
            tmap.append(i)
    return DiffusionSchedule(betas=np.array(new_betas), timestep_map=np.array(tmap),
                             original_num_steps=trained_steps)
