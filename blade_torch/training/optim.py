"""Adam and AdamW behind global-norm clipping, with optax's exact update.

The TDM trainer's optimizers (``blade/training/tdm.py::_optimizer``) are
``optax.chain(clip_by_global_norm(max_norm), adamw | adam)``, optionally
inside ``optax.MultiSteps`` for gradient accumulation.  This module is the
same update as a small function over flat dicts of tensors, so the state is
a plain dict (``torch.save``-able) and rolling an update back is keeping
the old dict:

* clip: ``g *= max_norm / |g|`` unless ``|g| < max_norm`` (global norm);
* ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu`` (``b1`` may be
  0), ``u = mu_hat / (sqrt(nu_hat) + eps)`` with bias-corrected moments;
* AdamW adds decoupled weight decay ``wd * p``; the step is ``p - lr u``
  with ``lr = schedule(n)`` at the ``n``-th applied update;
* ``grad_accum = N``: each call folds the gradient into a running mean
  and the update above runs every N-th call on that mean (MultiSteps).

The update builds new tensors and never writes into its inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple, Union

import torch

__all__ = ["AdamConfig", "adam_init", "adam_update"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: Union[float, Callable[[int], float]]
    b1: float = 0.0
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0  # 0 is plain Adam; > 0 is AdamW
    max_grad_norm: float = 1.0
    grad_accum: int = 1


def adam_init(params: Mapping[str, torch.Tensor], cfg: AdamConfig) -> dict:
    zeros = lambda: {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
    state = {"count": 0, "mu": zeros(), "nu": zeros()}
    if cfg.grad_accum > 1:
        state.update(acc=zeros(), mini_step=0)
    return state


def _global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))


def adam_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                state: dict, cfg: AdamConfig) -> Tuple[Tensors, dict]:
    """One call: ``(new_params, new_state)``."""
    if cfg.grad_accum > 1:
        n = state["mini_step"]
        acc = {k: a + (grads[k].float() - a) / (n + 1) for k, a in state["acc"].items()}
        if n + 1 < cfg.grad_accum:
            return dict(params), dict(state, acc=acc, mini_step=n + 1)
        grads = acc
    norm = _global_norm(grads)
    clip = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm),
                       cfg.max_grad_norm / norm)
    count = state["count"] + 1
    lr = cfg.lr(count - 1) if callable(cfg.lr) else cfg.lr
    c1 = 1.0 - cfg.b1 ** count
    c2 = 1.0 - cfg.b2 ** count
    new_params, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * clip
        mu[k] = (1.0 - cfg.b1) * g + cfg.b1 * state["mu"][k]
        nu[k] = (1.0 - cfg.b2) * g * g + cfg.b2 * state["nu"][k]
        u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p.float()
        new_params[k] = (p.float() - lr * u).to(p.dtype)
    new_state = dict(state, count=count, mu=mu, nu=nu)
    if cfg.grad_accum > 1:
        new_state.update(acc={k: torch.zeros_like(a) for k, a in state["acc"].items()},
                         mini_step=0)
    return new_params, new_state
