"""Denoising: one loop over Wan's 8-step flow UniPC or CogVideoX's 8-step
SDE-DPM++(2M), with optional ASA mask reuse.

Counterpart of ``blade/sampling/pipeline.py`` (CFG 1: the distilled
samplers' setting).  PyTorch runs eagerly, so :func:`sample` is a host loop
over :func:`step`, which runs the model and then its solver's update.  A
solver (:class:`FlowUniPC`, :class:`SDEDPM`) holds its schedule ``sched``
with ``init(noise)`` and ``update(state, v, i, generator, xi=None)``.

``model_fn(latents, timestep, text_embeds, generator, masks=None,
collect_mask=False) -> prediction`` (or ``(prediction, masks)`` when
collecting).  Step ``i`` hands the model ``fold_generator(generator, i)``;
CogVideoX's SDE noise of step ``i`` is drawn from
``fold_generator(fold_generator(generator, i), 1)`` (JAX:
``fold_in(fold_in(rng, i), 1)``), or injected as ``xi``.  The solver state
is f32 whatever the model's dtype.
"""

from __future__ import annotations

from typing import Callable

import torch

from blade_torch.schedulers import ddpm as D
from blade_torch.schedulers import unipc_flow as F
from blade_torch.schedulers.cogvideox_dpm import dpm_init, dpm_step, make_dpm_schedule
from blade_torch.utils import tracing
from blade_torch.utils.rng import fold_generator

__all__ = ["FlowUniPC", "SDEDPM", "step", "sample"]

ModelFn = Callable[..., torch.Tensor]


class FlowUniPC:
    """Wan's flow-matching UniPC; its update draws no noise."""

    def __init__(self, num_steps: int = 8, flow_shift: float = 3.0):
        self.sched = F.make_flow_unipc_schedule(num_steps, flow_shift=flow_shift)

    def init(self, noise):
        return F.unipc_init(noise.float())

    def update(self, state, v, i, generator, xi=None):
        with tracing.span("sample.update"):
            return F.unipc_step(self.sched, state, v, i)


class SDEDPM:
    """CogVideoX's v-prediction SDE-DPM++(2M), trailing spacing over
    ``ddpm_schedule`` (default ``make_ddpm_schedule()``)."""

    def __init__(self, num_steps: int = 8, ddpm_schedule=None):
        self.sched = make_dpm_schedule(ddpm_schedule or D.make_ddpm_schedule(), num_steps)

    def init(self, noise):
        return dpm_init(noise.float())

    def update(self, state, v, i, generator, xi=None):
        if xi is None:
            g = fold_generator(fold_generator(generator, i), 1)
            xi = torch.randn(state.x.shape, generator=g, device=state.x.device,
                             dtype=torch.float32)
        with tracing.span("sample.update"):
            return dpm_step(self.sched, state, v, i, xi)


def step(model_fn: ModelFn, solver, state, i, text_embeds, generator, *, masks=None,
         collect_mask=False, xi=None):
    """Step ``i``: the model's prediction, then the solver's update.
    ``masks`` replays per-layer ASA masks, skipping the predictor;
    ``collect_mask`` returns ``(state, masks)`` with the masks the model
    predicted."""
    kwargs = {} if masks is None else {"masks": masks}
    if collect_mask:
        kwargs["collect_mask"] = True
    t = torch.full((state.x.shape[0],), float(solver.sched.timesteps[i]), dtype=torch.float32,
                   device=state.x.device)
    out = model_fn(state.x, t, text_embeds, fold_generator(generator, i), **kwargs)
    if collect_mask:
        v, masks = out
        return solver.update(state, v.float(), i, generator, xi), masks
    return solver.update(state, out.float(), i, generator, xi)


def sample(model_fn: ModelFn, solver, noise: torch.Tensor, text_embeds: torch.Tensor, *,
           generator: torch.Generator, mask_refresh_every: int = 0) -> torch.Tensor:
    """Noise -> clean latents (f32).

    ``mask_refresh_every > 1`` reuses the per-layer ASA masks: predicted on
    steps ``i % n == 0`` (the model's ``collect_mask`` protocol) and
    replayed in between.  0/1 = off.
    """
    state, masks = solver.init(noise), None
    for i in range(solver.sched.num_steps):
        with tracing.span("sample.step"):
            if mask_refresh_every > 1 and i % mask_refresh_every == 0:
                state, masks = step(model_fn, solver, state, i, text_embeds, generator,
                                    collect_mask=True)
            else:
                state = step(model_fn, solver, state, i, text_embeds, generator, masks=masks)
    return state.x
