"""Functional LoRA over the port's named parameters.

Counterpart of ``blade/training/lora.py``: rank-``r`` adapters on the
``to_q``, ``to_k``, ``to_v`` and ``to_out`` projections of every attention
of every block (Wan's ``attn1`` and ``attn2``, CogVideoX's ``attn1``), as
the reference trainer's peft config.  ``init_lora`` builds a flat dict of factors keyed
``"<module>.a"`` (``[in, r] ~ N(0, 1/r)``) and ``"<module>.b"``
(``[r, out] = 0``); ``merge_lora`` returns effective parameters
``W + (alpha / r) (a @ b)^T`` (torch weights are ``[out, in]``, flax kernels
``[in, out]``), differentiable in the factors.

Each block gets its own pair.  (The JAX package's ``init_lora`` over a
layer-scanned tree gives one pair per projection shared by all layers; see
ROADMAP.md.)  ``attn1.to_q``/``to_k`` store their weight rows permuted by
``deinterleave_perm`` (``models/layers.py::PermutedLinear``), and the ``b``
factor of those two modules keeps its output columns in the same permuted
order, so the merge is a plain add; :func:`export_lora` and the JAX bridge
(``convert/from_jax.py::wan_lora_factors``, ``cogvideox_lora_factors``)
convert to the checkpoint's own order.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from blade_torch.utils.rng import fold_generator

__all__ = ["DEFAULT_TARGETS", "is_target", "lora_modules", "init_lora", "merge_lora",
           "lora_param_count", "export_lora"]

DEFAULT_TARGETS: Tuple[str, ...] = ("to_q", "to_k", "to_v", "to_out")


def is_target(name: str, targets: Sequence[str] = DEFAULT_TARGETS) -> bool:
    """``name`` is the weight of a targeted projection (``to_out.0`` counts
    as ``to_out``), the rule of the JAX ``_is_target``."""
    parts = name.split(".")
    if len(parts) < 2 or parts[-1] != "weight":
        return False
    module = parts[-3] if parts[-2].isdigit() and len(parts) >= 3 else parts[-2]
    return any(t in module for t in targets)


def lora_modules(params: Mapping[str, torch.Tensor],
                 targets: Sequence[str] = DEFAULT_TARGETS):
    """Module names (``"blocks.0.attn1.to_q"``) of the targeted weights, in
    ``params``' order."""
    return [n[: -len(".weight")] for n in params if is_target(n, targets)]


def init_lora(generator: torch.Generator, params: Mapping[str, torch.Tensor], *,
              rank: int = 64, targets: Sequence[str] = DEFAULT_TARGETS,
              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Factors for every targeted ``[out, in]`` weight: ``a [in, r]`` from
    ``generator`` folded with the module's ordinal, ``b [r, out]`` zeros (so
    the merge starts as the identity)."""
    lora: Dict[str, torch.Tensor] = {}
    for i, module in enumerate(lora_modules(params, targets), start=1):
        w = params[module + ".weight"]
        d_out, d_in = w.shape
        g = fold_generator(generator, i)
        lora[module + ".a"] = torch.randn((d_in, rank), generator=g, device=w.device,
                                          dtype=torch.float32).to(dtype) / math.sqrt(rank)
        lora[module + ".b"] = torch.zeros((rank, d_out), device=w.device, dtype=dtype)
    return lora


def merge_lora(params: Mapping[str, torch.Tensor], lora: Mapping[str, torch.Tensor], *,
               alpha: float = 64.0, rank: int = 64) -> Dict[str, torch.Tensor]:
    """Effective parameters: ``W + (alpha/rank) (a @ b)^T`` in f32, rounded to
    ``W``'s dtype, where ``lora`` has factors; the same tensors elsewhere."""
    scale = alpha / rank
    merged = dict(params)
    for key, a in lora.items():
        if not key.endswith(".a"):
            continue
        module = key[:-2]
        w = params[module + ".weight"]
        delta = (a @ lora[module + ".b"]).transpose(0, 1) * scale
        merged[module + ".weight"] = (w.float() + delta).to(w.dtype)
    return merged


def lora_param_count(lora: Mapping[str, torch.Tensor]) -> int:
    return sum(t.numel() for t in lora.values())


def export_lora(model: torch.nn.Module, lora: Mapping[str, torch.Tensor], *,
                alpha: float, rank: int) -> Dict[str, np.ndarray]:
    """The adapter as numpy arrays keyed by diffusers module name, in the
    checkpoint's own (unpermuted) order, with the peft layout:
    ``<module>.lora_A.weight = a^T [r, in]``, ``<module>.lora_B.weight =
    b^T [out, r]``, so ``delta W = (lora_alpha / lora_rank) B @ A``."""
    out: Dict[str, np.ndarray] = {"lora_alpha": np.asarray(alpha, np.float32),
                                  "lora_rank": np.asarray(rank, np.int32)}
    modules = dict(model.named_modules())
    for key, a in lora.items():
        if not key.endswith(".a"):
            continue
        name = key[:-2]
        b = lora[name + ".b"]
        inv = getattr(modules[name], "_inv", None)
        if inv is not None:  # PermutedLinear: back to the checkpoint's rows
            b = b[:, inv.to(b.device)]
        out[name + ".lora_A.weight"] = a.detach().float().t().cpu().numpy()
        out[name + ".lora_B.weight"] = b.detach().float().t().cpu().numpy()
    return out
