"""Denoising loops: Wan's 8-step flow UniPC and CogVideoX's 8-step
SDE-DPM++(2M), each with optional ASA mask reuse.

Counterpart of ``blade/sampling/pipeline.py`` (CFG 1: the distilled
samplers' setting).  PyTorch runs eagerly, so each loop is a host loop over
steps; the steppers expose the same per-step decomposition as the JAX
package, and ``sample_wan`` / ``sample_cogvideox`` are their folds.

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

__all__ = ["sample_wan", "wan_stepper", "wan_stepper_reuse", "sample_cogvideox",
           "cog_stepper", "cog_stepper_reuse"]

ModelFn = Callable[..., torch.Tensor]


def _update(step_fn, *args):
    """A scheduler's update (``unipc_step`` / ``dpm_step``) in its span."""
    with tracing.span("sample.update"):
        return step_fn(*args)


def _timestep(sched, i, x):
    return torch.full((x.shape[0],), float(sched.timesteps[i]), dtype=torch.float32,
                      device=x.device)


def wan_stepper(model_fn: ModelFn, *, num_steps: int = 8, flow_shift: float = 3.0):
    """``(init, step)``: ``step(state, i, text_embeds, generator)`` is one
    UniPC step."""
    sched = F.make_flow_unipc_schedule(num_steps, flow_shift=flow_shift)

    def init(noise):
        return F.unipc_init(noise.float())

    def step(state, i, text_embeds, generator):
        t = _timestep(sched, i, state.x)
        v = model_fn(state.x, t, text_embeds, fold_generator(generator, i))
        return _update(F.unipc_step, sched, state, v.float(), i)

    return init, step


def wan_stepper_reuse(model_fn: ModelFn, *, num_steps: int = 8, flow_shift: float = 3.0):
    """``(init, refresh, reuse)``: ``refresh`` predicts the per-layer ASA
    masks at step ``i`` alongside the velocity and returns them;
    ``reuse(state, masks, i, ...)`` replays them, skipping the predictor."""
    sched = F.make_flow_unipc_schedule(num_steps, flow_shift=flow_shift)

    def init(noise):
        return F.unipc_init(noise.float())

    def refresh(state, i, text_embeds, generator):
        t = _timestep(sched, i, state.x)
        v, masks = model_fn(state.x, t, text_embeds, fold_generator(generator, i),
                            collect_mask=True)
        return _update(F.unipc_step, sched, state, v.float(), i), masks

    def reuse(state, masks, i, text_embeds, generator):
        t = _timestep(sched, i, state.x)
        v = model_fn(state.x, t, text_embeds, fold_generator(generator, i), masks=masks)
        return _update(F.unipc_step, sched, state, v.float(), i)

    return init, refresh, reuse


def sample_wan(
    model_fn: ModelFn,
    noise: torch.Tensor,
    text_embeds: torch.Tensor,
    *,
    generator: torch.Generator,
    num_steps: int = 8,
    flow_shift: float = 3.0,
    mask_refresh_every: int = 0,
) -> torch.Tensor:
    """Flow-matching sampling for Wan: noise -> clean latents (f32).

    ``mask_refresh_every > 1`` reuses the per-layer ASA masks: predicted on
    steps ``i % n == 0`` (the model's ``collect_mask`` protocol) and
    replayed in between.  0/1 = off.
    """
    if mask_refresh_every and mask_refresh_every > 1:
        init, refresh, reuse = wan_stepper_reuse(model_fn, num_steps=num_steps,
                                                 flow_shift=flow_shift)
        state, masks = init(noise), None
        for i in range(num_steps):
            with tracing.span("sample.step"):
                if i % mask_refresh_every == 0:
                    state, masks = refresh(state, i, text_embeds, generator)
                else:
                    state = reuse(state, masks, i, text_embeds, generator)
        return state.x

    init, step = wan_stepper(model_fn, num_steps=num_steps, flow_shift=flow_shift)
    state = init(noise)
    for i in range(num_steps):
        with tracing.span("sample.step"):
            state = step(state, i, text_embeds, generator)
    return state.x


def _cog_schedule(num_steps, ddpm_schedule):
    return make_dpm_schedule(ddpm_schedule or D.make_ddpm_schedule(), num_steps)


def _sde_noise(x, generator, i):
    g = fold_generator(fold_generator(generator, i), 1)
    return torch.randn(x.shape, generator=g, device=x.device, dtype=torch.float32)


def cog_stepper(model_fn: ModelFn, *, num_steps: int = 8, ddpm_schedule=None):
    """``(init, step)``: ``step(state, i, text_embeds, generator, xi=None)``
    is one SDE-DPM++(2M) step; ``xi`` overrides the step's drawn noise."""
    sched = _cog_schedule(num_steps, ddpm_schedule)

    def init(noise):
        return dpm_init(noise.float())

    def step(state, i, text_embeds, generator, xi=None):
        t = _timestep(sched, i, state.x)
        v = model_fn(state.x, t, text_embeds, fold_generator(generator, i))
        xi = _sde_noise(state.x, generator, i) if xi is None else xi
        return _update(dpm_step, sched, state, v.float(), i, xi)

    return init, step


def cog_stepper_reuse(model_fn: ModelFn, *, num_steps: int = 8, ddpm_schedule=None):
    """``(init, refresh, reuse)``, the mask-reuse decomposition of
    :func:`cog_stepper` (same protocol as :func:`wan_stepper_reuse`)."""
    sched = _cog_schedule(num_steps, ddpm_schedule)

    def init(noise):
        return dpm_init(noise.float())

    def refresh(state, i, text_embeds, generator, xi=None):
        t = _timestep(sched, i, state.x)
        v, masks = model_fn(state.x, t, text_embeds, fold_generator(generator, i),
                            collect_mask=True)
        xi = _sde_noise(state.x, generator, i) if xi is None else xi
        return _update(dpm_step, sched, state, v.float(), i, xi), masks

    def reuse(state, masks, i, text_embeds, generator, xi=None):
        t = _timestep(sched, i, state.x)
        v = model_fn(state.x, t, text_embeds, fold_generator(generator, i), masks=masks)
        xi = _sde_noise(state.x, generator, i) if xi is None else xi
        return _update(dpm_step, sched, state, v.float(), i, xi)

    return init, refresh, reuse


def sample_cogvideox(
    model_fn: ModelFn,
    noise: torch.Tensor,
    text_embeds: torch.Tensor,
    *,
    generator: torch.Generator,
    num_steps: int = 8,
    ddpm_schedule=None,
    mask_refresh_every: int = 0,
) -> torch.Tensor:
    """v-prediction SDE-DPM++(2M) sampling with trailing spacing
    (CogVideoX): noise -> clean latents (f32); ``mask_refresh_every`` as in
    :func:`sample_wan`."""
    if mask_refresh_every and mask_refresh_every > 1:
        init, refresh, reuse = cog_stepper_reuse(model_fn, num_steps=num_steps,
                                                 ddpm_schedule=ddpm_schedule)
        state, masks = init(noise), None
        for i in range(num_steps):
            with tracing.span("sample.step"):
                if i % mask_refresh_every == 0:
                    state, masks = refresh(state, i, text_embeds, generator)
                else:
                    state = reuse(state, masks, i, text_embeds, generator)
        return state.x
    init, step = cog_stepper(model_fn, num_steps=num_steps, ddpm_schedule=ddpm_schedule)
    state = init(noise)
    for i in range(num_steps):
        with tracing.span("sample.step"):
            state = step(state, i, text_embeds, generator)
    return state.x
