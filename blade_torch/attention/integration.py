"""Glue between ASA and the DiT: the pluggable ``attention_fn``.

Counterpart of ``blade/attention/integration.py``.  The DiT calls
``attention_fn(q, k, v, generator=..., layer_index=..., masks=...,
collect_mask=...)`` for every self-attention.  The generator is folded with
the layer index so each block draws fresh samples.  Where the flax model
``sow``s each layer's mask and ``extract_attn_aux`` stacks them, the port's
``WanModel`` stacks the masks its ``attention_fn`` returns to the same
``[L, ...]`` contract.  The artifact is one mask tensor (energy lane, or
an int level mask) or an ``(idx, counts)`` lists tuple (the multilevel
lane); :func:`stack_masks` and :func:`layer_mask` handle both.
"""

from __future__ import annotations

import dataclasses

import torch

from blade_torch.attention.asa import ASAConfig, asa_attention
from blade_torch.utils import tracing
from blade_torch.utils.rng import fold_generator, make_generator

__all__ = ["make_asa_attention_fn", "asa_model_kwargs", "stack_masks", "layer_mask"]


def stack_masks(per_layer):
    """Per-layer artifacts -> one ``[L, ...]`` stack (a tuple of stacks for
    lists tuples)."""
    if isinstance(per_layer[0], (tuple, list)):
        return tuple(torch.stack(parts) for parts in zip(*per_layer))
    return torch.stack(per_layer)


def layer_mask(masks, i: int):
    """Layer ``i``'s artifact out of a :func:`stack_masks` stack."""
    if isinstance(masks, (tuple, list)):
        return tuple(m[i] for m in masks)
    return masks[i]


def asa_model_kwargs(asa_cfg: ASAConfig) -> dict:
    """Model kwargs wiring ASA with the gilbert permutation hoisted to the
    model: tokens are permuted once per forward (``WanModel.token_perm``)
    and every attention call runs ``pre_arranged``.  Without
    ``use_rearrange`` nothing is permuted and no ``token_perm`` is set."""
    if not asa_cfg.use_rearrange:
        return {"attention_fn": make_asa_attention_fn(asa_cfg)}
    cfg = dataclasses.replace(asa_cfg, pre_arranged=True)
    return {"attention_fn": make_asa_attention_fn(cfg), "token_perm": asa_cfg.permutations()}


def make_asa_attention_fn(asa_cfg: ASAConfig):
    """Returns ``attention_fn(q, k, v, *, generator, layer_index, masks,
    collect_mask) -> out`` (or ``(out, mask)`` when ``collect_mask``).

    ``masks`` is a per-layer stack ``[L, ...]`` from an earlier collecting
    call; layer ``layer_index`` replays its slice and skips the predictor.
    """

    def attention_fn(q, k, v, *, generator=None, layer_index=0, masks=None,
                     collect_mask=False, **_):
        with tracing.span("asa"):
            if generator is None:
                generator = make_generator(0, q.device)
            gen = fold_generator(generator, layer_index)
            mask = None if masks is None else layer_mask(masks, layer_index)
            out, _, mask = asa_attention(q, k, v, asa_cfg, generator=gen, mask=mask,
                                         return_mask=True)
            out = out.to(q.dtype)
        if collect_mask:
            return out, mask
        return out

    return attention_fn
