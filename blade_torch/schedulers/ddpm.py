"""DDPM noise tables and v-prediction conversions (CogVideoX family).

Counterpart of ``blade/schedulers/ddpm.py``: scaled-linear betas with the
optional SNR shift and zero-terminal-SNR rescale of the CogVideoX diffusers
configs, trailing timestep spacing, and the x0 / eps / v conversions.  The
tables are float32 numpy (copied arithmetic, not imported); the conversions
take integer timesteps ``t [B]`` and broadcast the looked-up values over a
sample's remaining axes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "DDPMSchedule",
    "make_ddpm_schedule",
    "add_noise",
    "pred_x0_from_v",
    "pred_eps_from_x0",
    "velocity_from_x0_eps",
    "renoise",
    "trailing_timesteps",
]


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Precomputed diffusion tables (float32 numpy)."""

    num_train_timesteps: int
    alphas_cumprod: np.ndarray  # [T]
    alpha: np.ndarray  # sqrt(alphas_cumprod)
    sigma: np.ndarray  # sqrt(1 - alphas_cumprod)


def make_ddpm_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    snr_shift_scale: float = 1.0,
    rescale_betas_zero_snr: bool = True,
) -> DDPMSchedule:
    """CogVideoX defaults: scaled-linear betas, optional SNR shift and
    zero-terminal-SNR rescale (5B: rescale on; 2B: snr_shift_scale 3)."""
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
    else:
        raise ValueError(beta_schedule)
    alphas_cumprod = np.cumprod(1.0 - betas)
    if snr_shift_scale != 1.0:
        alphas_cumprod = alphas_cumprod / (
            snr_shift_scale + (1 - snr_shift_scale) * alphas_cumprod)
    if rescale_betas_zero_snr:
        ab_sqrt = np.sqrt(alphas_cumprod)
        a0, a_t = ab_sqrt[0], ab_sqrt[-1]
        ab_sqrt = (ab_sqrt - a_t) * a0 / (a0 - a_t)
        # the terminal step has exactly zero SNR; clamp for safe divisions
        alphas_cumprod = np.clip(ab_sqrt**2, 1e-12, 1.0)
    alphas_cumprod = alphas_cumprod.astype(np.float32)
    return DDPMSchedule(
        num_train_timesteps=num_train_timesteps,
        alphas_cumprod=alphas_cumprod,
        alpha=np.sqrt(alphas_cumprod).astype(np.float32),
        sigma=np.sqrt(1.0 - alphas_cumprod).astype(np.float32),
    )


def _gather(table: np.ndarray, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``table[t]`` shaped to broadcast over ``like`` (t: [B] integers)."""
    vals = torch.from_numpy(table).to(like.device)[t.long().to(like.device)]
    return vals.reshape(vals.shape + (1,) * (like.dim() - vals.dim()))


def add_noise(sched: DDPMSchedule, x0, noise, t):
    """x_t = alpha_t x0 + sigma_t noise."""
    return _gather(sched.alpha, t, x0) * x0 + _gather(sched.sigma, t, x0) * noise


def pred_x0_from_v(sched: DDPMSchedule, v, x_t, t):
    """x0 = alpha_t x_t - sigma_t v."""
    return _gather(sched.alpha, t, v) * x_t - _gather(sched.sigma, t, v) * v


def pred_eps_from_x0(sched: DDPMSchedule, x0, x_t, t):
    """eps = (x_t - alpha_t x0) / sigma_t."""
    return (x_t - _gather(sched.alpha, t, x0) * x0) / _gather(sched.sigma, t, x0)


def velocity_from_x0_eps(sched: DDPMSchedule, x0, eps, t):
    """v = alpha_t eps - sigma_t x0."""
    return _gather(sched.alpha, t, x0) * eps - _gather(sched.sigma, t, x0) * x0


def renoise(sched: DDPMSchedule, x_t1, noise, t1, t2):
    """Move a noisy sample from t1 to a higher-noise t2 (> t1) without x0:
    ``x_t2 = (a2/a1) x_t1 + sqrt(max(s2^2 - (a2/a1 s1)^2, 0)) noise``."""
    a1, a2 = _gather(sched.alpha, t1, x_t1), _gather(sched.alpha, t2, x_t1)
    s1, s2 = _gather(sched.sigma, t1, x_t1), _gather(sched.sigma, t2, x_t1)
    ratio = a2 / a1
    beta = torch.sqrt(torch.clamp(s2 ** 2 - (ratio * s1) ** 2, min=0.0))
    return ratio * x_t1 + beta * noise


def trailing_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """"trailing" spacing ``[T-1, T-1-T/N, ...]`` (diffusers
    ``timestep_spacing='trailing'``)."""
    step = num_train_timesteps / num_inference_steps
    ts = np.round(np.arange(num_train_timesteps, 0, -step)).astype(np.int64) - 1
    return ts[:num_inference_steps]
