"""Flow-matching UniPC multistep scheduler (Wan2.1 family).

Counterpart of ``blade/schedulers/unipc_flow.py``: diffusers
``UniPCMultistepScheduler`` with ``prediction_type='flow_prediction',
use_flow_sigmas=True``, solver order 2, bh2, predict-x0, corrector on,
lower-order final.  Flow path ``x_t = (1 - sigma) x0 + sigma eps``; the
model predicts ``v = eps - x0``; ``lambda = log((1 - sigma) / sigma)``.

The schedule tables are numpy (copied from the JAX package).  The step
index is a host integer, so each step's scalar coefficients are computed
on the host in float32 and applied to f32 tensors.

The flow-matching training half (``flow_training_sigmas`` and the four
conversions TDM uses) looks sigmas up per sample by integer timestep.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "FlowUniPCSchedule",
    "make_flow_unipc_schedule",
    "UniPCState",
    "unipc_init",
    "unipc_step",
    "euler_step",
    "flow_training_sigmas",
    "flow_add_noise",
    "flow_pred_x0",
    "flow_pred_eps",
    "flow_renoise",
]

_LAMBDA_CLAMP = 60.0  # expm1(-60) == -1 in f32; keeps terminal sigma=0 finite


def _shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


@dataclasses.dataclass(frozen=True)
class FlowUniPCSchedule:
    """Inference-time sigma grid (descending) with terminal zero appended."""

    num_steps: int
    sigmas: np.ndarray  # [N+1], sigmas[-1] == 0
    timesteps: np.ndarray  # [N] int64, = sigma * num_train_timesteps
    lambdas: np.ndarray  # [N+1] clamped log((1-s)/s)
    solver_order: int = 2
    lower_order_final: bool = True
    use_corrector: bool = True


def make_flow_unipc_schedule(
    num_inference_steps: int,
    *,
    num_train_timesteps: int = 1000,
    flow_shift: float = 3.0,
    solver_order: int = 2,
    lower_order_final: bool = True,
    use_corrector: bool = True,
) -> FlowUniPCSchedule:
    """diffusers ``use_flow_sigmas`` grid: ``alphas = linspace(1, 1/T, N+1)``,
    ``sigmas = flip(shifted(1 - alphas))[:-1]``, terminal 0 appended."""
    alphas = np.linspace(1.0, 1.0 / num_train_timesteps, num_inference_steps + 1)
    sigmas = 1.0 - alphas
    sigmas = np.flip(_shift_sigmas(sigmas, flow_shift))[:-1].copy()
    timesteps = (sigmas * num_train_timesteps).astype(np.int64)
    sigmas_full = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    with np.errstate(divide="ignore"):
        lambdas = np.log((1.0 - sigmas_full) / np.maximum(sigmas_full, 1e-30))
    lambdas = np.clip(lambdas, -_LAMBDA_CLAMP, _LAMBDA_CLAMP).astype(np.float32)
    return FlowUniPCSchedule(
        num_steps=num_inference_steps,
        sigmas=sigmas_full,
        timesteps=timesteps,
        lambdas=lambdas,
        solver_order=solver_order,
        lower_order_final=lower_order_final,
        use_corrector=use_corrector,
    )


def flow_training_sigmas(num_train_timesteps: int = 1000,
                         flow_shift: float = 3.0) -> np.ndarray:
    """Per-integer-timestep sigma table for TDM training:
    ``sigma_table[t] = shifted(t / T)`` (f32 numpy), the direct form of the
    reference's nearest-timestep lookup after ``set_timesteps(1000)``."""
    t = np.arange(num_train_timesteps, dtype=np.float64) / num_train_timesteps
    return _shift_sigmas(t, flow_shift).astype(np.float32)


def _sig(table, t: torch.Tensor, ndim: int) -> torch.Tensor:
    vals = torch.as_tensor(table, device=t.device)[t.long()]
    return vals.reshape(vals.shape + (1,) * (ndim - vals.dim()))


def flow_add_noise(sigma_table, x0, noise, t):
    """``x_t = (1 - sigma_t) x0 + sigma_t noise``."""
    s = _sig(sigma_table, t, x0.dim())
    return (1.0 - s) * x0 + s * noise


def flow_pred_x0(sigma_table, v, x_t, t):
    """``x0 = x_t - sigma_t v``."""
    s = _sig(sigma_table, t, v.dim())
    return x_t - s * v


def flow_pred_eps(sigma_table, x0, x_t, t):
    """``eps = (x_t - (1 - sigma) x0) / sigma``."""
    s = _sig(sigma_table, t, x0.dim())
    return (x_t - (1.0 - s) * x0) / torch.clamp(s, min=1e-6)


def flow_renoise(sigma_table, x_t1, noise, t1, t2):
    """Move from ``t1`` to a higher noise level ``t2`` without x0 (the
    flow-matching analogue of the DDPM renoise)."""
    s1 = _sig(sigma_table, t1, x_t1.dim())
    s2 = _sig(sigma_table, t2, x_t1.dim())
    ratio = (1.0 - s2) / (1.0 - s1)
    beta = torch.sqrt(torch.clamp(s2 ** 2 - (ratio * s1) ** 2, min=0.0))
    return ratio * x_t1 + beta * noise


class UniPCState(NamedTuple):
    x: torch.Tensor  # current sample at sigma[i]
    m0: torch.Tensor  # x0 prediction at step i-1
    m1: torch.Tensor  # x0 prediction at step i-2
    last_x: torch.Tensor  # sample at step i-1 (pre-predictor, for corrector)


def unipc_init(x: torch.Tensor) -> UniPCState:
    z = torch.zeros_like(x)
    return UniPCState(x=x, m0=z, m1=z, last_x=z)


_f32 = np.float32


def _bh2(h):
    """hh = -h (predict_x0), h_phi_1 = B_h = expm1(hh) (bh2)."""
    hh = _f32(-h)
    h_phi_1 = _f32(np.expm1(hh))
    return hh, h_phi_1, h_phi_1


def _uni_p(sched, x, m0, m1, i, use_order2):
    """Predictor: move x from sigma[i] to sigma[i+1]."""
    sig, lam = sched.sigmas, sched.lambdas
    s0, st = sig[i], sig[i + 1]
    a_t = _f32(1.0) - st
    h = _f32(lam[i + 1] - lam[i])
    _, h_phi_1, b_h = _bh2(h)
    x_t_ = _f32(st / max(s0, _f32(1e-30))) * x - _f32(a_t * h_phi_1) * m0
    if not use_order2:
        return x_t_
    # Order 2: D1 = (m1 - m0) / r1, r1 = (lambda[i-1] - lambda[i]) / h,
    # rho_p = 1/2 (diffusers closed form).
    r1 = _f32((lam[max(i - 1, 0)] - lam[i]) / h)
    d1 = (m1 - m0) / float(r1 if r1 != 0 else _f32(1.0))
    return x_t_ - _f32(a_t * b_h) * (0.5 * d1)


def _uni_c(sched, last_x, m0, m1, m_t, i, use_order2):
    """Corrector: recompute the sample at sigma[i] from last_x at sigma[i-1]
    with the fresh model output m_t at sigma[i]."""
    sig, lam = sched.sigmas, sched.lambdas
    i_prev = max(i - 1, 0)
    s0, st = sig[i_prev], sig[i]
    a_t = _f32(1.0) - st
    h = _f32(lam[i] - lam[i_prev])
    hh, h_phi_1, b_h = _bh2(h)
    x_t_ = _f32(st / max(s0, _f32(1e-30))) * last_x - _f32(a_t * h_phi_1) * m0
    d1_t = m_t - m0
    if not use_order2:  # order-1 corrector: rho_c = [1/2]
        return x_t_ - _f32(a_t * b_h) * (0.5 * d1_t)
    # Order-2 corrector: rks = [r1, 1]; solve [[1,1],[r1,1]] rho = b.
    r1 = _f32((lam[max(i - 2, 0)] - lam[i_prev]) / h)
    d1_0 = (m1 - m0) / float(r1 if r1 != 0 else _f32(1.0))
    b1 = _f32((h_phi_1 / hh - _f32(1.0)) / b_h)
    h_phi_2 = _f32(h_phi_1 / hh - _f32(1.0))
    b2 = _f32((h_phi_2 / hh - _f32(0.5)) * _f32(2.0) / b_h)
    det = _f32(1.0) - r1
    if abs(det) < 1e-12:
        det = _f32(1e-12)
    rho0 = _f32((b1 - b2) / det)
    rho1 = _f32((b2 - r1 * b1) / det)
    return x_t_ - _f32(a_t * b_h) * (float(rho0) * d1_0 + float(rho1) * d1_t)


def unipc_step(sched: FlowUniPCSchedule, state: UniPCState, v_pred: torch.Tensor,
               i: int) -> UniPCState:
    """One UniPC step: corrector at sigma[i], predictor to sigma[i+1].

    ``v_pred`` is the model velocity at ``(state.x, timesteps[i])``; the
    solver runs in f32.  ``state.x`` after the final step is x0.
    """
    i = int(i)
    v = v_pred.float()
    x0_i = state.x - float(sched.sigmas[i]) * v
    x_i = state.x
    if sched.use_corrector and i > 0:
        use_c2 = i >= 2 and sched.solver_order >= 2
        x_i = _uni_c(sched, state.last_x, state.m0, state.m1, x0_i, i, use_c2)
    use_p2 = i >= 1 and sched.solver_order >= 2
    if sched.lower_order_final:
        use_p2 = use_p2 and i < sched.num_steps - 1
    x_next = _uni_p(sched, x_i, x0_i, state.m0, i, use_p2)
    return UniPCState(x=x_next, m0=x0_i, m1=state.m0, last_x=x_i)


def euler_step(sched: FlowUniPCSchedule, x: torch.Tensor, v_pred: torch.Tensor, i: int):
    """Rectified-flow Euler baseline: dx/dsigma = v."""
    return x + float(sched.sigmas[i + 1] - sched.sigmas[i]) * v_pred.float()
