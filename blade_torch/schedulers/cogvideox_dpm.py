"""CogVideoX inference sampler: SDE-DPM-Solver++(2M) over the v-pred DDPM
tables (``CogVideoXDPMScheduler`` with trailing spacing).

Counterpart of ``blade/schedulers/cogvideox_dpm.py``.  The step index is a
host integer, so each step's scalar coefficients are computed on the host in
float32 (as JAX computes them on its f32 tables) and applied to f32 tensors.
The SDE noise ``xi`` is an argument: the sampler draws it from its
generator, tests hand in JAX's draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from blade_torch.schedulers.ddpm import DDPMSchedule, trailing_timesteps

__all__ = ["DPMSchedule", "make_dpm_schedule", "DPMState", "dpm_init", "dpm_step"]

_LAMBDA_CLAMP = 60.0


@dataclasses.dataclass(frozen=True)
class DPMSchedule:
    """Inference-time grid over a base DDPM table (trailing spacing)."""

    num_steps: int
    timesteps: np.ndarray  # [N] int64, descending
    alpha: np.ndarray  # [N+1]: alpha at each step + terminal 1.0
    sigma: np.ndarray  # [N+1]: sigma at each step + terminal 0.0
    lambdas: np.ndarray  # [N+1] clamped log(alpha/sigma)


def make_dpm_schedule(base: DDPMSchedule, num_inference_steps: int) -> DPMSchedule:
    ts = trailing_timesteps(base.num_train_timesteps, num_inference_steps)
    alpha = np.concatenate([base.alpha[ts], [1.0]]).astype(np.float32)
    sigma = np.concatenate([base.sigma[ts], [0.0]]).astype(np.float32)
    lam = np.log(np.maximum(alpha, 1e-30) / np.maximum(sigma, 1e-30))
    lam = np.clip(lam, -_LAMBDA_CLAMP, _LAMBDA_CLAMP).astype(np.float32)
    return DPMSchedule(num_steps=num_inference_steps, timesteps=ts, alpha=alpha,
                       sigma=sigma, lambdas=lam)


class DPMState(NamedTuple):
    x: torch.Tensor
    m0: torch.Tensor  # previous x0 prediction


def dpm_init(x: torch.Tensor) -> DPMState:
    return DPMState(x=x, m0=torch.zeros_like(x))


def dpm_step(sched: DPMSchedule, state: DPMState, v_pred: torch.Tensor, i: int,
             noise: Optional[torch.Tensor] = None) -> DPMState:
    """SDE-DPM-Solver++(2M) step ``i -> i+1``::

        x0         = alpha_i x - sigma_i v
        D          = x0 (first and last step) or the 2M extrapolation
                     (1 + 1/(2r)) x0 - 1/(2r) m0,  r = h_last / h
        x_next     = (sigma_next / sigma_i) e^-h x - expm1(-2h) alpha_next D
                     + sigma_next sqrt(1 - e^-2h) xi

    ``noise=None`` runs the deterministic variant.
    """
    f32 = np.float32
    a, s, lam = sched.alpha, sched.sigma, sched.lambdas
    x = state.x
    x0 = float(a[i]) * x - float(s[i]) * v_pred
    h = f32(lam[i + 1] - lam[i])
    h_last = f32(lam[i] - lam[max(i - 1, 0)])
    if 0 < i < sched.num_steps - 1:
        r = f32(h_last / (h if h != 0 else f32(1.0)))
        inv2r = f32(f32(1.0) / (f32(2.0) * r))
        d = float(f32(1.0) + inv2r) * x0 - float(inv2r) * state.m0
    else:
        d = x0
    exp_h = np.exp(-h, dtype=f32)
    mult1 = f32(s[i + 1] / max(s[i], f32(1e-30))) * exp_h
    mult2 = np.expm1(f32(-2.0) * h, dtype=f32) * a[i + 1]
    x_next = float(mult1) * x - float(mult2) * d
    if noise is not None:
        mult_noise = s[i + 1] * np.sqrt(max(f32(1.0) - exp_h * exp_h, f32(0.0)), dtype=f32)
        x_next = x_next + float(mult_noise) * noise
    return DPMState(x=x_next, m0=x0)
