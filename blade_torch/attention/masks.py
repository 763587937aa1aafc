"""Adaptive block-mask prediction for ASA: the energy and multilevel lanes.

Counterpart of ``blade/attention/masks.py``: edge padding to whole blocks,
per-(batch, head) token subsampling, the energy mask (smallest top-scoring
set of key blocks reaching ``energy_threshold`` of each row's mass, clamped
to ``[min_retain, max_retain] * n_k`` blocks, last two block rows and
columns forced on), the mask -> ascending block lists conversion that the
sparse kernel consumes, the union lists of adjacent mask-row pairs that the
union-gathered sparse kernel walks, the "max" predictor's pooled score
estimate, and the multilevel lane's rank bands: the int level mask and the
per-level ascending lists that the multi-level kernel walks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "pad_to_block_multiple",
    "sample_block_tokens",
    "energy_mask",
    "DEFAULT_MASK_RATIOS",
    "multilevel_mask",
    "multilevel_rank_bands",
    "multilevel_lists",
    "mask_to_block_lists",
    "union_block_lists",
    "mask_density",
    "pooled_attention_scores",
    "pooled_scores_plain",
]

# f32 score elements per chunk of the pooled estimate (512 MB).
_CHUNK_ELEMS = 1 << 27


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


def pooled_scores_plain(
    q_s: torch.Tensor,
    k_s: torch.Tensor,
    tokens_per_block: int,
    scale: float,
    q_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Block-pooled softmax estimate ``Po [B, H, n_q, n_k]`` in f32, computed
    on ``q_s``/``k_s`` as given (the plain version of the "max" predictor
    kernel).

    ``Po[i, j] = max over rows m of q-block i and keys n of k-block j of
    softmax_row(q_s k_s^T * scale)[m, n]``, each row then renormalised to
    sum to 1.  The row max and sum run over every key of ``k_s``; blocks are
    ``tokens_per_block`` rows (``n_q = Ls // tpb``, ``n_k = Lks // tpb``).
    Chunked over query rows (whole q-blocks), so the ``Ls x Lks`` scores
    are never held whole.
    """
    b, h, ls, _ = q_s.shape
    lks = k_s.shape[2]
    tpb = tokens_per_block
    n_q, n_k = ls // tpb, lks // tpb
    if q_chunk is None:
        q_chunk = _CHUNK_ELEMS // max(1, b * h * lks)
    q_chunk = max(tpb, q_chunk // tpb * tpb)
    kt = k_s.float().transpose(-1, -2)
    rows = []
    for r0 in range(0, n_q * tpb, q_chunk):
        qc = q_s[:, :, r0:min(r0 + q_chunk, n_q * tpb)].float()
        s = (qc @ kt) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        nqc = qc.shape[2] // tpb
        per_row = p[..., :n_k * tpb].reshape(b, h, nqc, tpb, n_k, tpb).amax(dim=-1)
        rows.append((per_row / l.reshape(b, h, nqc, tpb, 1)).amax(dim=3))
    po = torch.cat(rows, dim=2)
    return po / po.sum(dim=-1, keepdim=True)


def pooled_attention_scores(
    q_s: torch.Tensor,
    k_s: torch.Tensor,
    *,
    tokens_per_block: int,
    scale: Optional[float] = None,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Block-pooled attention estimate ``Po [B, H, n_q, n_k]`` (rows sum to
    1) from (sub)sampled Q/K ``[B, H, Ls, D]``, every ``tokens_per_block``
    rows standing for one 128-token block.  As in JAX, Q and K are rounded
    to bf16 for the score product (f32 accumulation): the estimator is
    approximate by construction.  Chunked over ``q_chunk`` query rows."""
    if scale is None:
        scale = 1.0 / q_s.shape[-1] ** 0.5
    return pooled_scores_plain(q_s.to(torch.bfloat16), k_s.to(torch.bfloat16),
                               tokens_per_block, scale, q_chunk=min(q_chunk, q_s.shape[2]))


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


# Inference-time multilevel bands: fraction-of-rank -> pooling level
# (1 = full attention, L = L-times mean-pooled K/V, 0 = skip).
DEFAULT_MASK_RATIOS: Dict[int, Tuple[float, float]] = {
    1: (0.0, 0.05),
    2: (0.05, 0.15),
    4: (0.15, 0.25),
    8: (0.25, 0.5),
    0: (0.5, 1.0),
}


def _descending_order(scores: torch.Tensor) -> torch.Tensor:
    """Stable descending ranking: ties keep the lower index first (JAX's
    ``argsort(-scores, stable=True)``)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def multilevel_mask(
    scores: torch.Tensor,
    mask_ratios: Optional[Dict[int, Tuple[float, float]]] = None,
    force_last2: bool = True,
) -> torch.Tensor:
    """Int32 level mask in {0, 1, 2, 4, 8}: the key block of descending rank
    ``r`` gets the level of the band ``[int(n_k*lo), int(n_k*hi))`` holding
    ``r``; the last two block rows and columns are then forced to 1."""
    if mask_ratios is None:
        mask_ratios = DEFAULT_MASK_RATIOS
    n_k = scores.shape[-1]
    order = _descending_order(scores)
    ranks = torch.arange(n_k, device=scores.device)
    band = torch.zeros(n_k, dtype=torch.int32, device=scores.device)
    for level, (lo, hi) in mask_ratios.items():
        lo_i, hi_i = max(0, int(n_k * lo)), min(n_k, int(n_k * hi))
        band = torch.where((ranks >= lo_i) & (ranks < hi_i),
                           torch.full_like(band, level), band)
    levels = torch.empty(scores.shape, dtype=torch.int32, device=scores.device)
    levels.scatter_(-1, order, band.expand(scores.shape).contiguous())
    if force_last2:
        levels = _force_last2(levels, 1)
    return levels


def multilevel_rank_bands(
    n_k: int, mask_ratios: Optional[Dict[int, Tuple[float, float]]] = None
) -> Dict[int, Tuple[int, int]]:
    """Static ``level -> (band_start, band_width)`` over a descending ranking
    of ``n_k`` key blocks (levels 1, 2, 4, 8)."""
    if mask_ratios is None:
        mask_ratios = DEFAULT_MASK_RATIOS
    bands = {}
    for level in (1, 2, 4, 8):
        lo, hi = mask_ratios.get(level, (0.0, 0.0))
        lo_i, hi_i = max(0, int(n_k * lo)), min(n_k, int(n_k * hi))
        bands[level] = (lo_i, max(hi_i - lo_i, 0))
    return bands


def multilevel_lists(
    scores: torch.Tensor,
    mask_ratios: Optional[Dict[int, Tuple[float, float]]] = None,
    cap: Optional[int] = None,
    force_last2: bool = True,
):
    """Per-level ascending block lists straight from one score ranking;
    equal, bit for bit, to ``multilevel_mask`` followed by one
    ``mask_to_block_lists`` a level.

    Each level's list is its rank band of the descending order, sorted.  The
    last two key blocks are forced to level 1: removed from whichever band
    they ranked into (they become sentinels past ``n_k``, compacted by the
    sort and clamped back to ``n_k - 1``) and appended to the level-1 list,
    where, as the two largest indices, they keep it ascending.  The last two
    query rows attend at level 1 to every block (``min(n_k, cap)`` of them).

    Returns ``(idx int32 [..., n_q, 4, cap], counts int32 [..., n_q, 4])``
    for levels 1, 2, 4, 8; list tails repeat an in-range index.
    """
    if mask_ratios is None:
        mask_ratios = DEFAULT_MASK_RATIOS
    n_q, n_k = scores.shape[-2], scores.shape[-1]
    lead = scores.shape[:-1]
    dev = scores.device
    if cap is None:
        cap = n_k
    sentinel = n_k + 2
    order = _descending_order(scores).to(torch.int32)
    forced_row = (torch.arange(n_q, device=dev) >= n_q - 2) if force_last2 \
        else torch.zeros(n_q, dtype=torch.bool, device=dev)
    full_row = torch.arange(cap, dtype=torch.int32, device=dev).clamp(max=n_k - 1)
    bands = multilevel_rank_bands(n_k, mask_ratios)
    idx_levels, cnt_levels = [], []
    for level in (1, 2, 4, 8):
        lo_i, band_w = bands[level]
        budget = cap - (2 if (level == 1 and force_last2) else 0)
        width = min(band_w, budget)
        cnt = torch.full(lead, width, dtype=torch.int32, device=dev)
        if width:
            band = order[..., lo_i:lo_i + width]
            if force_last2:
                is_forced = band >= n_k - 2
                band = torch.where(is_forced, torch.full_like(band, sentinel), band)
                cnt = cnt - is_forced.sum(-1, dtype=torch.int32)
            if level == 1 and force_last2:
                tail = torch.arange(n_k - 2, n_k, dtype=torch.int32, device=dev)
                band = torch.cat([band, tail.expand(*lead, 2)], dim=-1)
                cnt = cnt + 2
            asc = torch.sort(band, dim=-1).values.clamp(max=n_k - 1)
            if cap > asc.shape[-1]:
                asc = torch.cat([asc, asc[..., -1:].expand(*lead, cap - asc.shape[-1])],
                                dim=-1)
        elif level == 1 and force_last2:
            asc = torch.arange(n_k - 2, n_k - 2 + cap, dtype=torch.int32, device=dev)
            asc = asc.clamp(max=n_k - 1).expand(*lead, cap)
            cnt = cnt + 2
        else:
            asc = torch.zeros((*lead, cap), dtype=torch.int32, device=dev)
        if level == 1:
            asc = torch.where(forced_row[:, None], full_row, asc)
            cnt = torch.where(forced_row, torch.full_like(cnt, min(n_k, cap)), cnt)
        else:
            cnt = torch.where(forced_row, torch.zeros_like(cnt), cnt)
        idx_levels.append(asc)
        cnt_levels.append(cnt)
    return torch.stack(idx_levels, dim=-2), torch.stack(cnt_levels, dim=-1)


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


def union_block_lists(mask: torch.Tensor, group: int = 2, bound: Optional[int] = None):
    """Union key-block lists over groups of ``group`` adjacent mask rows
    (the union-gathered sparse kernel's input); bit for bit JAX's.

    ``mask``: bool ``[..., n_q, n_k]`` with ``n_q % group == 0``.  ``bound``:
    a static bound on every union row's selection except fully-on rows
    (energy masks: ``group * (ceil(n_k * max_retain) + 2)``; only the
    forced last-two query rows exceed it).  When given and below ``n_k``,
    the ranking is one ``topk`` of that width instead of an ``n_k``-wide
    sort, and a row whose union exceeds it is rewritten as the identity
    list; list tails repeat the last listed index.

    Returns ``(indices [..., n_q/group, n_k], counts [..., n_q/group],
    valbits [..., n_q/group, n_k])``, all int32, where bit ``r`` of
    ``valbits`` says whether mask row ``group * i + r`` selected that block.
    """
    *lead, n_q, n_k = mask.shape
    if n_q % group:
        raise ValueError(f"union_block_lists: {n_q} mask rows are not a multiple of "
                         f"the group {group}")
    m = mask.reshape(*lead, n_q // group, group, n_k)
    union = m.any(dim=-2)
    if bound is not None and bound < n_k:
        dev = mask.device
        iota = torch.arange(n_k, dtype=torch.int32, device=dev)
        counts = union.sum(dim=-1, dtype=torch.int32)
        # selected blocks first, both segments ascending by block id
        key = torch.where(union, 2 * n_k - iota, n_k - iota)
        sel = key.topk(bound, dim=-1).indices.to(torch.int32)
        pos = torch.arange(bound, dtype=torch.int32, device=dev)
        cl = counts.clamp(max=bound)[..., None]
        last = torch.gather(sel, -1, (cl - 1).clamp(min=0).long())
        sel = torch.where(pos < cl, sel, last)
        sel = torch.cat([sel, last.expand(*sel.shape[:-1], n_k - bound)], dim=-1)
        idx = torch.where((counts > bound)[..., None], iota, sel)
    else:
        idx, counts = mask_to_block_lists(union)
    bits = torch.zeros(idx.shape, dtype=torch.int32, device=mask.device)
    for r in range(group):
        picked = torch.gather(m[..., r, :], -1, idx.long())
        bits = bits | (picked.to(torch.int32) << r)
    return idx, counts, bits


def mask_density(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of active blocks (1 - sparsity)."""
    return mask.float().mean()
