"""Adaptive block-mask prediction for ASA, energy lane.

Counterpart of ``blade/attention/masks.py``: edge padding to whole blocks,
per-(batch, head) token subsampling, the energy mask (smallest top-scoring
set of key blocks reaching ``energy_threshold`` of each row's mass, clamped
to ``[min_retain, max_retain] * n_k`` blocks, last two block rows and
columns forced on) and the mask -> ascending block lists conversion that the
sparse kernel consumes.  The multilevel lane is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "pad_to_block_multiple",
    "sample_block_tokens",
    "energy_mask",
    "mask_to_block_lists",
    "mask_density",
]


def pad_to_block_multiple(x: torch.Tensor, block: int) -> torch.Tensor:
    """Edge-pad ``x [..., L, D]`` along L up to a multiple of ``block``: tail
    blocks repeat the last token (zeros would distort the pooled estimate)."""
    rem = x.shape[-2] % block
    if rem == 0:
        return x
    last = x[..., -1:, :]
    return torch.cat([x, last.expand(*x.shape[:-2], block - rem, x.shape[-1])], dim=-2)


def sample_offsets(
    b: int, h: int, block: int, num_keep: int, *,
    generator: Optional[torch.Generator], device,
) -> torch.Tensor:
    """One random set of ``num_keep`` positions out of ``block`` per (B, H):
    the indices of the top ``num_keep`` of ``block`` uniform draws."""
    scores = torch.rand((b, h, block), generator=generator, device=device)
    return scores.topk(num_keep, dim=-1).indices


def sample_block_tokens(
    x: torch.Tensor,
    block: int = 128,
    num_keep: int = 32,
    *,
    generator: Optional[torch.Generator] = None,
    offsets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Subsample ``num_keep`` of every ``block`` tokens, same offsets per (B, H).

    ``x``: ``[B, H, L, D]`` with ``L % block == 0``.  ``offsets`` (int
    ``[B, H, num_keep]``) may be injected; otherwise they are drawn from
    ``generator``.  Returns ``[B, H, (L // block) * num_keep, D]``.
    """
    b, h, length, d = x.shape
    nblk = length // block
    if offsets is None:
        offsets = sample_offsets(b, h, block, num_keep, generator=generator,
                                 device=x.device)
    offs = offsets.to(device=x.device, dtype=torch.long)
    xb = x.reshape(b, h, nblk, block, d)
    idx = offs[:, :, None, :, None].expand(b, h, nblk, offs.shape[-1], d)
    return torch.gather(xb, 3, idx).reshape(b, h, nblk * offs.shape[-1], d)


def _force_last2(mask: torch.Tensor, on_value) -> torch.Tensor:
    """Force the last two block rows and columns on (text/EOS blocks)."""
    mask = mask.clone()
    mask[..., :, -2:] = on_value
    mask[..., -2:, :] = on_value
    return mask


def energy_mask(
    scores: torch.Tensor,
    *,
    min_retain_ratio=0.05,
    max_retain_ratio=0.1,
    energy_threshold: float = 0.95,
    force_last2: bool = True,
) -> torch.Tensor:
    """Boolean block mask keeping the top blocks holding ``energy_threshold``
    of each row's mass.

    Per row: rank descending (stable: ties keep the lower index first, as
    ``lax.top_k`` and the stable argsort do), find the first rank where the
    cumulative sum reaches the threshold, clamp that count to
    ``[max(1, n_k * min_retain), n_k * max_retain]`` and keep the top-count
    blocks.  Retain ratios are scalars (top-k lane) or per-(B, H) tensors.
    """
    n_k = scores.shape[-1]
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    scalar_ratios = not (torch.is_tensor(max_retain_ratio)
                         and max_retain_ratio.dim() > 0)
    if scalar_ratios:
        # The clamp caps the count at int(n_k * max_ratio): only that prefix
        # of the ranking matters.
        k_cap = max(int(n_k * float(max_retain_ratio)), 1)
        total = scores.sum(dim=-1, keepdim=True)
        order = order[..., :k_cap]
        vals = torch.gather(scores, -1, order)
        reached = torch.cumsum(vals, dim=-1) >= energy_threshold * total
        k_idx = reached.int().argmax(dim=-1)
        k_idx = torch.where(reached.any(dim=-1), k_idx, torch.full_like(k_idx, k_cap))
        min_retain = max(int(n_k * float(min_retain_ratio)), 1)
        count = k_idx.clamp(min_retain, k_cap)
        keep_sorted = torch.arange(k_cap, device=scores.device) < count[..., None]
    else:
        sorted_scores = torch.gather(scores, -1, order)
        cum = torch.cumsum(sorted_scores, dim=-1)
        reached = cum >= energy_threshold * cum[..., -1:]
        k_idx = reached.int().argmax(dim=-1)
        k_idx = torch.where(reached.any(dim=-1), k_idx, torch.full_like(k_idx, n_k))

        def retain(ratio):
            r = (n_k * torch.as_tensor(ratio, device=scores.device)).to(torch.int32)
            r = r.clamp(min=1)
            if r.dim() and r.dim() == k_idx.dim() - 1:
                r = r[..., None]  # per-(B, H) ratios broadcast over rows
            return r

        count = torch.minimum(torch.maximum(k_idx, retain(min_retain_ratio)),
                              retain(max_retain_ratio))
        keep_sorted = torch.arange(n_k, device=scores.device) < count[..., None]
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    mask.scatter_(-1, order, keep_sorted)
    if force_last2:
        mask = _force_last2(mask, True)
    return mask


def mask_to_block_lists(mask: torch.Tensor):
    """Boolean block mask ``[..., n_q, n_k]`` -> ``(indices, counts)``.

    ``indices``: int32 ``[..., n_q, n_k]``, the selected key-block indices
    ascending, padded by repeating the last valid index (index 0 for an
    empty row); ``counts``: int32 ``[..., n_q]``.
    """
    # Stable argsort of (not selected) puts the selected indices first, ascending.
    idx = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    counts = mask.sum(dim=-1)
    pos = torch.arange(mask.shape[-1], device=mask.device)
    last = torch.gather(idx, -1, (counts[..., None] - 1).clamp(min=0))
    idx = torch.where(pos < counts[..., None], idx, last)
    return idx.to(torch.int32), counts.to(torch.int32)


def mask_density(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of active blocks (1 - sparsity)."""
    return mask.float().mean()
