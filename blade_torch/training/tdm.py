"""TDM: Trajectory Distribution Matching step distillation (data-free).

Counterpart of ``blade/training/tdm.py``, both diffusion families (Wan's
flow matching, CogVideoX's DDPM v-prediction):

* three roles share ONE base parameter dict: student = base + LoRA_g,
  fake-score = base + LoRA_f, frozen teacher = base.  The model runs each
  role through ``torch.func.functional_call`` with the merged dict;
* one ``train_step`` = K-step stochastic-DDIM trajectory simulation (no
  grad) -> fake-score update (grad in LoRA_f, x0-space MSE weighted by
  ``1/sigma_t^2``) -> generator update (grad in LoRA_g, pseudo-Huber
  against the revised target ``model + real(cfg) - fake``), with the same
  stop-gradients as the JAX step;
* the fake update is rolled back (adapter AND optimizer state) when
  ``loss_fake`` reaches ``fake_loss_skip_threshold``.

Every random draw of a step is made by :func:`make_draws` from the step's
generator; ``train_step(..., draws=...)`` takes them from the caller
instead, which is how the tests hand it JAX's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from blade_torch.schedulers import ddpm as D
from blade_torch.schedulers import unipc_flow as F
from blade_torch.training import lora as lora_lib
from blade_torch.training.lr_schedules import make_lr_schedule
from blade_torch.training.optim import AdamConfig, adam_init, adam_update
from blade_torch.utils import tracing
from blade_torch.utils.rng import fold_generator

__all__ = [
    "DiffusionFamily",
    "ddpm_family",
    "flow_family",
    "TDMConfig",
    "TDMState",
    "TDMDraws",
    "create_tdm_state",
    "make_draws",
    "k_step_trajectory",
    "make_tdm_train_step",
]

Tensors = Dict[str, torch.Tensor]
# model_apply(params, latents, timestep_f32 [B], text_embeds, generator) -> prediction
ModelApply = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiffusionFamily:
    """The five conversions TDM needs, per diffusion formulation."""

    pred_x0: Callable  # (model_out, x_t, t) -> x0
    pred_eps: Callable  # (x0, x_t, t) -> eps
    add_noise: Callable  # (x0, eps, t) -> x_t
    renoise: Callable  # (x_t1, xi, t1, t2 > t1) -> x_t2
    sigma_at: Callable  # (t, ndim) -> sigma_t broadcastable


def ddpm_family(sched: D.DDPMSchedule, device=None) -> DiffusionFamily:
    """The DDPM / v-prediction family (CogVideoX) over a schedule's tables."""
    sigma = torch.as_tensor(sched.sigma, device=device)

    def sigma_at(t, ndim):
        s = sigma[t.long()]
        return s.reshape(s.shape + (1,) * (ndim - s.dim()))

    return DiffusionFamily(
        pred_x0=lambda out, x_t, t: D.pred_x0_from_v(sched, out, x_t, t),
        pred_eps=lambda x0, x_t, t: D.pred_eps_from_x0(sched, x0, x_t, t),
        add_noise=lambda x0, eps, t: D.add_noise(sched, x0, eps, t),
        renoise=lambda x, xi, t1, t2: D.renoise(sched, x, xi, t1, t2),
        sigma_at=sigma_at,
    )


def flow_family(sigma_table: np.ndarray, device=None) -> DiffusionFamily:
    """The flow-matching family over a per-timestep sigma table."""
    table = torch.as_tensor(np.asarray(sigma_table, np.float32), device=device)

    def sigma_at(t, ndim):
        s = table[t.long()]
        return s.reshape(s.shape + (1,) * (ndim - s.dim()))

    return DiffusionFamily(
        pred_x0=lambda out, x_t, t: F.flow_pred_x0(table, out, x_t, t),
        pred_eps=lambda x0, x_t, t: F.flow_pred_eps(table, x0, x_t, t),
        add_noise=lambda x0, eps, t: F.flow_add_noise(table, x0, eps, t),
        renoise=lambda x, xi, t1, t2: F.flow_renoise(table, x, xi, t1, t2),
        sigma_at=sigma_at,
    )


@dataclasses.dataclass(frozen=True)
class TDMConfig:
    k_step: int = 8
    eta: float = 0.9
    cfg: float = 3.5  # teacher CFG (5.0 for Wan)
    lambda_reg: float = 0.5  # 0 for Wan
    total_steps: int = 1000
    t_max: int = 980  # upper bound (exclusive) of the random distill t
    lr_generator: float = 1e-4
    lr_fake: float = 5e-4
    adam_b1: float = 0.0
    adam_b2: float = 0.95
    max_grad_norm: float = 1.0
    lora_rank: int = 64
    lora_alpha: float = 64.0
    # Pseudo-Huber c; None -> the reference's 1e-3 / (128 * sqrt(numel)).
    huber_c: Optional[float] = None
    # Each optimizer applies every N train_step calls, on the mean gradient.
    grad_accum: int = 1
    # Divide the generator loss by clamp(mean|model - real|, max=5).
    use_weighting_factor: bool = True
    # Train full student / fake parameter dicts instead of LoRA adapters.
    train_full_model: bool = False
    # Roll the fake update back when loss_fake reaches this (None = off).
    fake_loss_skip_threshold: Optional[float] = None
    optimizer: str = "adamw"  # "adamw" | "adam"; "prodigy" is not ported yet
    optimizer_state_bf16: bool = False  # not ported yet
    # Generator LR schedule (HF get_scheduler semantics); the fake
    # optimizer is always constant-LR.
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    lr_num_cycles: int = 1
    lr_power: float = 1.0
    max_train_steps: int = 300  # num_training_steps fed to the schedule
    weight_decay: float = 1e-4
    adam_eps: float = 1e-8


@dataclasses.dataclass
class TDMState:
    step: int
    base: Tensors  # frozen teacher / shared base (not checkpointed)
    lora_g: Tensors  # student adapter (or full student parameters)
    lora_f: Tensors  # fake-score adapter (or full fake parameters)
    opt_g: dict
    opt_f: dict


@dataclasses.dataclass
class TDMDraws:
    """Every random value of one ``train_step``.

    ``*_xi`` are standard normals of the latents' shape (f32), ``*_ind``
    integer segment indices in ``[1, k_step]`` and ``*_u`` uniforms in
    ``[0, 1)``, per sample.  The generators feed the model's own draws
    (ASA's token subsampling): one per trajectory step, ``student`` for the
    fake update's target forward, ``teacher`` for the fake / real / fake
    prediction forwards and ``generator`` for the generator forward (the
    JAX step's ``fold_in(rngs[0], k)``, ``rngs[10]``, ``rngs[5]`` and
    ``rngs[11]``).
    """

    traj_xi: List[torch.Tensor]
    traj_gens: List[Optional[torch.Generator]]
    fake_ind: torch.Tensor
    fake_u: torch.Tensor
    fake_xi: torch.Tensor
    fake_xi2: torch.Tensor
    gen_ind: torch.Tensor
    gen_u: torch.Tensor
    gen_xi: torch.Tensor
    gen_xi2: torch.Tensor
    student: Optional[torch.Generator] = None
    teacher: Optional[torch.Generator] = None
    generator: Optional[torch.Generator] = None


def make_draws(generator: torch.Generator, step: int, shape, k_step: int) -> TDMDraws:
    """The draws of step ``step``: twelve generators folded from
    ``generator`` and the step, used in the JAX step's order."""
    g = fold_generator(generator, step)
    sub = [fold_generator(g, i) for i in range(12)]
    dev = generator.device
    b = shape[0]

    def normal(gen):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def ind(gen):
        return torch.randint(1, k_step + 1, (b,), generator=gen, device=dev)

    def uniform(gen):
        return torch.rand((b,), generator=gen, device=dev, dtype=torch.float32)

    traj_gens = [fold_generator(sub[0], k) for k in range(k_step)]
    return TDMDraws(
        traj_xi=[normal(fold_generator(kg, 1)) for kg in traj_gens], traj_gens=traj_gens,
        fake_ind=ind(sub[1]), fake_u=uniform(sub[2]), fake_xi=normal(sub[3]),
        fake_xi2=normal(sub[4]),
        gen_ind=ind(sub[6]), gen_u=uniform(sub[7]), gen_xi=normal(sub[8]),
        gen_xi2=normal(sub[9]),
        student=sub[10], teacher=sub[5], generator=sub[11],
    )


def _check_supported(cfg: TDMConfig) -> None:
    if cfg.optimizer not in ("adamw", "adam"):
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (adamw, adam)")
    if cfg.optimizer_state_bf16:
        raise NotImplementedError("bf16 optimizer moments are not ported yet")


def _adam_config(lr, cfg: TDMConfig, *, scheduled: bool = False) -> AdamConfig:
    if scheduled and cfg.lr_scheduler != "constant":
        lr = make_lr_schedule(cfg.lr_scheduler, lr, warmup_steps=cfg.lr_warmup_steps,
                              total_steps=cfg.max_train_steps,
                              num_cycles=cfg.lr_num_cycles, power=cfg.lr_power)
    return AdamConfig(
        lr=lr, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
        weight_decay=cfg.weight_decay if cfg.optimizer == "adamw" else 0.0,
        max_grad_norm=cfg.max_grad_norm, grad_accum=cfg.grad_accum)


def create_tdm_state(generator: torch.Generator, base: Tensors, cfg: TDMConfig) -> TDMState:
    """Adapters from ``generator`` (folded 0 for LoRA_g, 1 for LoRA_f), or
    copies of the base in full-model mode; zeroed optimizer states."""
    _check_supported(cfg)
    base = {k: v.detach() for k, v in base.items()}
    if cfg.train_full_model:
        lora_g = {k: v.clone() for k, v in base.items()}
        lora_f = {k: v.clone() for k, v in base.items()}
    else:
        lora_g = lora_lib.init_lora(fold_generator(generator, 0), base, rank=cfg.lora_rank)
        lora_f = lora_lib.init_lora(fold_generator(generator, 1), base, rank=cfg.lora_rank)
    return TDMState(
        step=0, base=base, lora_g=lora_g, lora_f=lora_f,
        opt_g=adam_init(lora_g, _adam_config(cfg.lr_generator, cfg, scheduled=True)),
        opt_f=adam_init(lora_f, _adam_config(cfg.lr_fake, cfg)))


@torch.no_grad()
def k_step_trajectory(model_apply: ModelApply, params, family: DiffusionFamily,
                      noise: torch.Tensor, text_embeds: torch.Tensor, *,
                      xis: List[torch.Tensor], generators: List[Optional[torch.Generator]],
                      k_step: int, eta: float, total_steps: int = 1000):
    """K-step stochastic DDIM rollout.  Returns ``(x0s [K, B, ...],
    noisy [K+1, B, ...])``: ``noisy[k]`` is the input to step k and
    ``noisy[K]`` the final x0; both in ``noise``'s dtype."""
    b = noise.shape[0]
    delta = total_steps // k_step
    with tracing.span("tdm.rollout"):
        t = torch.full((b,), total_steps - 1, dtype=torch.long, device=noise.device)
        x = noise
        x0s, noisys = [], []
        for k in range(k_step):
            out = model_apply(params, x, t.float(), text_embeds, generators[k])
            x0 = family.pred_x0(out, x, t)
            eps_hat = family.pred_eps(x0, x, t)
            eps_mix = (eta * eps_hat
                       + math.sqrt(max(1.0 - eta ** 2, 0.0)) * xis[k].to(eps_hat.dtype))
            x_next = family.add_noise(x0, eps_mix, torch.clamp(t - delta, min=0)).to(x.dtype)
            x0s.append(x0.to(x.dtype))
            noisys.append(x)
            x, t = x_next, t - delta
        return torch.stack(x0s), torch.stack(noisys + [x0s[-1]])


def make_tdm_train_step(model_apply: ModelApply, family: DiffusionFamily, cfg: TDMConfig):
    """``train_step(state, batch, generator=None, *, draws=None) -> (state,
    metrics)``.  ``batch``: ``text_embeds`` ``[B, Lt, Dt]``,
    ``uncond_embeds`` (same shape) and ``noise`` ``[B, *latent_shape]``.
    The returned state holds new tensors; the old one stays valid.  Metrics:
    ``loss_fake``, ``loss_du``, ``fake_skipped`` (the skip guard rolled the
    fake update back) and, with a schedule, the generator's ``lr``."""
    _check_supported(cfg)
    opt_g = _adam_config(cfg.lr_generator, cfg, scheduled=True)
    opt_f = _adam_config(cfg.lr_fake, cfg)
    lr_sched = opt_g.lr if callable(opt_g.lr) else None
    c_eta = math.sqrt(max(1.0 - cfg.eta ** 2, 0.0))
    delta = cfg.total_steps // cfg.k_step

    def merge(base, adapter):
        if cfg.train_full_model:
            return adapter  # the adapters ARE the full parameters
        with tracing.span("tdm.merge"):
            return lora_lib.merge_lora(base, adapter, alpha=cfg.lora_alpha, rank=cfg.lora_rank)

    def predict_x0(params, x_t, t, text, gen, guidance=None, uncond=None):
        x0 = family.pred_x0(model_apply(params, x_t, t.float(), text, gen), x_t, t)
        if guidance is not None:
            x0_u = family.pred_x0(model_apply(params, x_t, t.float(), uncond, gen), x_t, t)
            x0 = x0_u + guidance * (x0 - x0_u)
        return x0

    def renoised(m_lat, m_eps, xi, xi2, t_mid, t):
        """The student's x0 re-noised to its segment start, then to ``t``."""
        add_eps = cfg.eta * m_eps + c_eta * xi.to(m_eps.dtype)
        ode_noisy = family.add_noise(m_lat, add_eps, t_mid)
        return family.renoise(ode_noisy, xi2.to(m_eps.dtype), t_mid, t)

    def grads_of(loss, leaves: Tensors) -> Tensors:
        with tracing.span("tdm.backward"):
            return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    def adam(params, grads, opt_state, opt_cfg):
        with tracing.span("tdm.adam"):
            return adam_update(params, grads, opt_state, opt_cfg)

    def train_step(state: TDMState, batch, generator: Optional[torch.Generator] = None, *,
                   draws: Optional[TDMDraws] = None):
        with tracing.span("tdm.step"):
            return step(state, batch, generator, draws)

    def step(state, batch, generator, draws):
        text, uncond, noise = batch["text_embeds"], batch["uncond_embeds"], batch["noise"]
        b, ndim = noise.shape[0], noise.dim()
        if draws is None:
            draws = make_draws(generator, state.step, tuple(noise.shape), cfg.k_step)
        rows = torch.arange(b, device=noise.device)

        # ---- (1) trajectory simulation (no grad) --------------------------
        student = merge(state.base, state.lora_g)
        _, noisy = k_step_trajectory(
            model_apply, student, family, noise, text, xis=draws.traj_xi,
            generators=draws.traj_gens, k_step=cfg.k_step, eta=cfg.eta,
            total_steps=cfg.total_steps)
        noisy_rev = noisy.flip(0)  # index ind counts segments from the end

        def distill_points(ind, u):
            ind = ind.to(noise.device).long()
            lat = noisy_rev[ind, rows]
            t_g = ind * delta - 1
            t_mid = t_g - delta + 1
            # t ~ U[t_mid, t_max) per sample, truncated as the JAX int cast
            t = t_mid + (u.to(noise.device).float()
                         * (cfg.t_max - t_mid).float()).to(torch.long)
            return lat, t_g, t_mid, t

        # ---- (2) fake-score update ---------------------------------------
        with tracing.span("tdm.fake"):
            with torch.no_grad():
                lat_ode, t_g, t_mid, t = distill_points(draws.fake_ind, draws.fake_u)
                m_lat = family.pred_x0(model_apply(student, lat_ode, t_g.float(), text,
                                                   draws.student), lat_ode, t_g)
                m_eps = family.pred_eps(m_lat, lat_ode, t_g)
                noisy_t = renoised(m_lat, m_eps, draws.fake_xi, draws.fake_xi2, t_mid, t)
                w = 1.0 / torch.clamp(family.sigma_at(t, ndim) ** 2, min=1e-8)
                x0_real = (predict_x0(state.base, noisy_t, t, text, draws.teacher)
                           if cfg.lambda_reg > 0 else None)
            del student
            leaves_f = {k: v.detach().requires_grad_(True) for k, v in state.lora_f.items()}
            with torch.enable_grad():
                x0_f = predict_x0(merge(state.base, leaves_f), noisy_t, t, text, draws.teacher)
                loss_f = torch.mean(w * (x0_f - m_lat) ** 2)
                if x0_real is not None:
                    loss_f = loss_f + cfg.lambda_reg * torch.mean(w * (x0_f - x0_real) ** 2)
                grads_f = grads_of(loss_f, leaves_f)
            del x0_f, leaves_f
            loss_fake = tracing.readback(loss_f.detach())
            lora_f, opt_f_state = adam(state.lora_f, grads_f, state.opt_f, opt_f)
            fake_skipped = cfg.fake_loss_skip_threshold is not None and not (
                loss_fake < cfg.fake_loss_skip_threshold)
            if fake_skipped:
                # skip the whole update: adapter and optimizer state roll back
                lora_f, opt_f_state = state.lora_f, state.opt_f
            del grads_f

        # ---- (3) generator update ----------------------------------------
        with tracing.span("tdm.generator"):
            lat_ode, t_g, t_mid, t2 = distill_points(draws.gen_ind, draws.gen_u)
            leaves_g = {k: v.detach().requires_grad_(True) for k, v in state.lora_g.items()}
            with torch.enable_grad():
                out = model_apply(merge(state.base, leaves_g), lat_ode, t_g.float(), text,
                                  draws.generator)
                model_latents = family.pred_x0(out, lat_ode, t_g)
            with torch.no_grad():
                # revised target: student + teacher(cfg) - fake, all stopped
                ml = model_latents.detach()
                noisy_t2 = renoised(ml, family.pred_eps(ml, lat_ode, t_g), draws.gen_xi,
                                    draws.gen_xi2, t_mid, t2)
                real = predict_x0(state.base, noisy_t2, t2, text, draws.teacher,
                                  guidance=cfg.cfg, uncond=uncond)
                fake = predict_x0(merge(state.base, lora_f), noisy_t2, t2, text, draws.teacher)
                revised = ml + real - fake
            numel = float(np.prod(noise.shape[1:]))
            c = cfg.huber_c if cfg.huber_c is not None else 1e-3 / (128.0 * math.sqrt(numel))
            with torch.enable_grad():
                ml32 = model_latents.float()
                huber = torch.sqrt((ml32 - revised.float()) ** 2 + c ** 2) - c
                if cfg.use_weighting_factor:
                    wf = torch.mean(torch.abs(ml32.detach() - real.float()),
                                    dim=tuple(range(1, ndim)), keepdim=True)
                    huber = huber / torch.clamp(wf, max=5.0)
                loss_g = torch.mean(huber)
                grads_g = grads_of(loss_g, leaves_g)
            del leaves_g, out, model_latents, ml32, huber
            lora_g, opt_g_state = adam(state.lora_g, grads_g, state.opt_g, opt_g)

        new_state = TDMState(step=state.step + 1, base=state.base, lora_g=lora_g,
                             lora_f=lora_f, opt_g=opt_g_state, opt_f=opt_f_state)
        metrics = {"loss_fake": loss_fake, "loss_du": tracing.readback(loss_g.detach()),
                   "fake_skipped": fake_skipped}
        if lr_sched is not None:
            metrics["lr"] = lr_sched(state.step // cfg.grad_accum)
        return new_state, metrics

    return train_step
