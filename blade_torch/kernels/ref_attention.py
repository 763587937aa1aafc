"""Plain PyTorch attention: the oracle for every attention kernel of the port.

Counterpart of ``blade/kernels/ref_attention.py``.  All functions take
``[B, H, L, D]`` and return ``(out, lse)`` with ``lse`` the natural-log row
log-sum-exp of the scaled scores (f32).  Scores are computed in f32.
``attention_backward_reference`` is the plain backward of both forwards.

Unlike the JAX reference these run chunked over query rows, so they also
serve at main-path shapes on the card: a full ``[12, 32760, 32760]`` f32
score tensor would be 51 GB.  Chunking changes no value (each query row's
softmax is independent).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from blade_torch.attention.masks import pad_to_block_multiple

__all__ = [
    "dense_attention_with_lse",
    "block_masked_attention",
    "attention_backward_reference",
    "merge_attention",
    "mean_pool_kv",
    "pool_pyramid",
    "pooled_level_attention_reference",
    "pooled_level_backward_reference",
    "multilevel_block_attention_reference",
    "lists_to_level_masks",
    "multilevel_lists_attention",
    "NEG_INF",
]

# Large-but-finite negative used to mask scores and to mark empty rows' lse.
NEG_INF = -1e30
# f32 score elements per chunk (512 MB).
_CHUNK_ELEMS = 1 << 27


def _rows_per_chunk(lead: int, lk: int, multiple: int = 1) -> int:
    rows = max(1, _CHUNK_ELEMS // max(1, lead * lk))
    return max(multiple, rows // multiple * multiple)


def dense_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    bias: float = 0.0,
):
    """Softmax attention returning ``(out, lse)``; f32 accumulation.

    ``bias`` is a scalar added to every score (``+log(level)`` for pooled
    branches).  V's width may differ from Q/K's.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    lq, lk = q.shape[-2], k.shape[-2]
    lead = math.prod(q.shape[:-2])
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    step = _rows_per_chunk(lead, lk)
    for r0 in range(0, lq, step):
        s = torch.matmul(q[..., r0:r0 + step, :].float(), kf.transpose(-1, -2))
        s = s * scale + bias
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        outs.append(torch.matmul(p / l, vf).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    return torch.cat(outs, dim=-2), torch.cat(lses, dim=-1)


def block_masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_mask: torch.Tensor,
    *,
    block_k: int,
    scale: Optional[float] = None,
    bias: float = 0.0,
):
    """Binary block-sparse attention by dense masking (reference semantics).

    ``block_mask``: bool ``[B, H, ceil(Lq/128), ceil(Lk/block_k)]`` (mask
    rows are 128 queries).  Skipped blocks contribute nothing; a row with no
    selected key gets out 0 and lse ``NEG_INF``.  ``block_k`` is the mask's
    column granularity and is always passed explicitly.
    """
    block_q = 128
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    lq, lk = q.shape[-2], k.shape[-2]
    lead = math.prod(q.shape[:-2])
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    step = _rows_per_chunk(lead, lk, block_q)
    for r0 in range(0, lq, step):
        qc = q[..., r0:r0 + step, :]
        rows = qc.shape[-2]
        bm = block_mask[..., r0 // block_q:-(-(r0 + rows) // block_q), :]
        tok = bm.repeat_interleave(block_q, dim=-2).repeat_interleave(block_k, dim=-1)
        tok = tok[..., :rows, :lk]
        s = torch.matmul(qc.float(), kf.transpose(-1, -2)) * scale + bias
        s = torch.where(tok, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        # Masked entries are exact zeros: a fully empty row must not leak
        # mean-of-V through exp(NEG_INF - NEG_INF) = 1.
        p = torch.where(tok, torch.exp(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        outs.append(torch.matmul(p / l_safe, vf).to(q.dtype))
        lse = (m + torch.log(l_safe))[..., 0]
        lses.append(torch.where(l[..., 0] == 0, torch.full_like(lse, NEG_INF), lse))
    return torch.cat(outs, dim=-2), torch.cat(lses, dim=-1)


def attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g_out: torch.Tensor,
    g_lse: torch.Tensor,
    *,
    block_mask: Optional[torch.Tensor] = None,
    block_k: int = 128,
    scale: float,
    bias: float = 0.0,
    delta: Optional[torch.Tensor] = None,
):
    """Gradients ``(dq, dk, dv)`` of ``(out, lse)`` from the forward's saved
    statistics, with the backward kernels' formula
    (``blade/kernels/block_sparse_attn.py:147-225``)::

        delta = rowsum(g_out * out)
        p     = exp(s * scale + bias - lse)
        ds    = p * (g_out . v^T + g_lse - delta)
        dq    = scale * ds . k,   dk = scale * ds^T . q,   dv = p^T . g_out

    ``block_mask`` (bool ``[B, H, ceil(Lq/128), ceil(Lk/block_k)]``, or
    ``None`` for dense) zeroes ``p`` on skipped blocks; a row whose ``lse``
    is ``NEG_INF`` (empty) contributes nothing.  ``delta``: the row sums
    ``rowsum(g_out * out)`` when the caller has them (several passes over
    one ``(out, lse)``).  f32 math, chunked over query rows like the
    forwards; the results come back in the inputs' dtypes.
    """
    lq, lk = q.shape[-2], k.shape[-2]
    lead = math.prod(q.shape[:-2])
    kf, vf = k.float(), v.float()
    if delta is None:
        delta = (g_out.float() * out.float()).sum(dim=-1)
    rest = g_lse.float() - delta
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=v.device)
    dqs = []
    step = _rows_per_chunk(lead, lk, 128)
    for r0 in range(0, lq, step):
        qc = q[..., r0:r0 + step, :].float()
        gc = g_out[..., r0:r0 + step, :].float()
        rows = qc.shape[-2]
        live = (lse[..., r0:r0 + step] > NEG_INF / 2)[..., None]
        if block_mask is not None:
            bm = block_mask[..., r0 // 128:-(-(r0 + rows) // 128), :]
            tok = bm.repeat_interleave(128, dim=-2).repeat_interleave(block_k, dim=-1)
            live = live & tok[..., :rows, :lk]
        s = torch.matmul(qc, kf.transpose(-1, -2)) * scale + bias
        p = torch.exp(s - lse[..., r0:r0 + step, None].float())
        p = torch.where(live, p, torch.zeros_like(p))
        ds = p * (torch.matmul(gc, vf.transpose(-1, -2)) + rest[..., r0:r0 + step, None])
        dqs.append((torch.matmul(ds, kf) * scale).to(q.dtype))
        dk += torch.matmul(ds.transpose(-1, -2), qc) * scale
        dv += torch.matmul(p.transpose(-1, -2), gc)
    return torch.cat(dqs, dim=-2), dk.to(k.dtype), dv.to(v.dtype)


def mean_pool_kv(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Mean-pool ``[..., L, D]`` along L by ``factor`` (``L % factor == 0``)."""
    *lead, length, d = x.shape
    return x.reshape(*lead, length // factor, factor, d).mean(dim=-2)


def pool_pyramid(x: torch.Tensor):
    """The 2/4/8x mean-pooled pyramid of ``x [..., L, D]`` (``L % 8 == 0``),
    pooled in f32 and chained (pool4 = pool2(pool2), pool8 = pool2(pool4)),
    as the pyramid pack kernel pools.  Returns three f32 tensors."""
    p = x.float()
    out = []
    for _ in range(3):
        y = p.reshape(*p.shape[:-2], p.shape[-2] // 2, 2, p.shape[-1])
        p = (y[..., 0, :] + y[..., 1, :]) * 0.5
        out.append(p)
    return out


def pooled_level_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_mask: torch.Tensor,
    *,
    level: int,
    scale: float,
    pooled_valid_len: int,
):
    """One pooled level of multi-level attention: the plain version of the
    pooled-level kernel (``csrc/gather_attn.cu``).

    ``k_pool, v_pool [..., Lp, D]``: the level-``level`` mean-pooled K/V,
    whose ``128 // level``-row segment ``b`` stands for key block ``b``;
    ``block_mask`` bool ``[..., ceil(Lq/128), n_k]``.  Pooled rows at or
    past ``pooled_valid_len`` are masked and every score gets ``+log(level)``.
    Returns ``(out, lse)``; a row with no key gets out 0 and lse ``NEG_INF``.
    """
    return block_masked_attention(
        q, k_pool[..., :pooled_valid_len, :], v_pool[..., :pooled_valid_len, :], block_mask,
        block_k=128 // level, scale=scale, bias=float(math.log(level)))


def pooled_level_backward_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g_out: torch.Tensor,
    g_lse: torch.Tensor,
    block_mask: torch.Tensor,
    *,
    level: int,
    scale: float,
    pooled_valid_len: int,
    delta: Optional[torch.Tensor] = None,
):
    """The plain backward of one pooled level: the plain version of the
    pooled-level backward kernels (``csrc/pooled_level_bwd.cu``).

    Key block ``b`` is the ``128 // level``-row segment ``b`` of ``k_pool,
    v_pool [..., Lp, D]``; every score carries ``+log(level)``; pooled rows
    at or past ``pooled_valid_len`` get no probability and no gradient.  p is
    recomputed from the given ``lse``: the level's own, or the merged lse of
    all levels, in which case the levels' passes sum to the gradient of the
    merged attention.  Returns ``(dq, dk_pool, dv_pool)``, ``dk_pool`` and
    ``dv_pool`` as long as ``k_pool`` (zero past ``pooled_valid_len``).
    """
    pvl = pooled_valid_len
    dq, dk, dv = attention_backward_reference(
        q, k_pool[..., :pvl, :], v_pool[..., :pvl, :], out, lse, g_out, g_lse,
        block_mask=block_mask, block_k=128 // level, scale=scale,
        bias=float(math.log(level)), delta=delta)
    pad = (0, 0, 0, k_pool.shape[-2] - pvl)
    return dq, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)


def multilevel_block_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    levels: torch.Tensor,
    *,
    scale: Optional[float] = None,
):
    """Dense reference for multi-level pooled block attention.

    ``levels``: int ``[B, H, L/128, L/128]`` in {0, 1, 2, 4, 8}: 0 skips the
    block, 1 attends to it fully, L attends to its L-times mean-pooled K/V
    with a ``+log(L)`` score bias.  Sequences are multiples of 128.
    Returns ``(out, lse)``.
    """
    outs, lses = [], []
    for level in (1, 2, 4, 8):
        kp = k if level == 1 else mean_pool_kv(k, level)
        vp = v if level == 1 else mean_pool_kv(v, level)
        out_l, lse_l = block_masked_attention(q, kp, vp, levels == level, scale=scale,
                                              block_k=128 // level,
                                              bias=float(math.log(level)))
        outs.append(out_l)
        lses.append(lse_l)
    return merge_attention(outs, lses)


def lists_to_level_masks(idx: torch.Tensor, counts: torch.Tensor, n_kt: int) -> torch.Tensor:
    """Per-level lists ``(idx [..., 4, cap], counts [..., 4])`` -> bool
    ``[..., 4, n_kt]`` (entries past a level's count are ignored)."""
    valid = torch.arange(idx.shape[-1], device=idx.device) < counts[..., None]
    hits = torch.zeros((*idx.shape[:-1], n_kt), dtype=torch.int32, device=idx.device)
    hits.scatter_add_(-1, idx.long(), valid.to(torch.int32))
    return hits > 0


def multilevel_lists_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lists,
    *,
    q_rows: int,
    scale: Optional[float] = None,
):
    """Multi-level attention driven by per-level lists: the plain version of
    the fused multi-level kernel (``bt_multilevel_fwd``,
    ``csrc/gather_attn.cu``).

    ``lists = (idx [B, H, n_q, 4, cap], counts [B, H, n_q, 4])`` for levels
    1, 2, 4, 8 (``masks.multilevel_lists``); mask row ``i`` covers queries
    ``[i * q_rows, (i + 1) * q_rows)``.  K/V are edge-padded to whole 128
    blocks; level 1 attends to keys below ``Lk``, level L to the pooled rows
    below ``ceil(Lk / L)`` of the chained f32 pyramid rounded to K's dtype
    (the pyramid pack kernel's output), with a ``+log(L)`` bias.  A row with
    no key gets out 0 and lse ``NEG_INF``.  f32 math, chunked over mask rows.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    lq, lk = q.shape[-2], k.shape[-2]
    idx, counts = lists
    n_q = idx.shape[-3]
    if n_q * q_rows < lq:
        raise ValueError(f"{n_q} mask rows of {q_rows} do not cover {lq} queries")
    kp, vp = pad_to_block_multiple(k, 128), pad_to_block_multiple(v, 128)
    n_kt = kp.shape[-2] // 128
    level_mask = lists_to_level_masks(idx, counts, n_kt)  # [B, H, n_q, 4, n_kt]
    keys, vals, col_level, col_block, col_ok, col_bias = [kp.float()], [vp.float()], [], [], [], []
    for pk, pv in zip(pool_pyramid(kp), pool_pyramid(vp)):
        keys.append(pk.to(k.dtype).float())
        vals.append(pv.to(v.dtype).float())
    for li, (level, kl) in enumerate(zip((1, 2, 4, 8), keys)):
        cols = torch.arange(kl.shape[-2], device=q.device)
        col_level.append(torch.full_like(cols, li))
        col_block.append(cols // (128 // level))
        col_ok.append(cols < -(-lk // level))
        col_bias.append(torch.full(cols.shape, math.log(level), device=q.device))
    kall, vall = torch.cat(keys, dim=-2), torch.cat(vals, dim=-2)
    col_level, col_block = torch.cat(col_level), torch.cat(col_block)
    col_ok, col_bias = torch.cat(col_ok), torch.cat(col_bias)
    lead = math.prod(q.shape[:-2])
    step = max(1, _CHUNK_ELEMS // max(1, lead * kall.shape[-2] * q_rows))
    outs, lses = [], []
    for m0 in range(0, -(-lq // q_rows), step):
        qc = q[..., m0 * q_rows:(m0 + step) * q_rows, :]
        rows = qc.shape[-2]
        tok = level_mask[..., m0:m0 + step, :, :][..., col_level, col_block] & col_ok
        tok = tok.repeat_interleave(q_rows, dim=-2)[..., :rows, :]
        s = torch.matmul(qc.float(), kall.transpose(-1, -2)) * scale + col_bias
        s = torch.where(tok, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(tok, torch.exp(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        outs.append(torch.matmul(p / l_safe, vall).to(q.dtype))
        lse = (m + torch.log(l_safe))[..., 0]
        lses.append(torch.where(l[..., 0] == 0, torch.full_like(lse, NEG_INF), lse))
    return torch.cat(outs, dim=-2), torch.cat(lses, dim=-1)


def merge_attention(outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor]):
    """Exactly combine attention branches over disjoint key sets:
    ``out = sum_i softmax_i(lse)_i * o_i``, ``lse = logsumexp_i(lse_i)``.
    Any per-branch score bias is already folded into that branch's lse."""
    lse_stack = torch.stack(list(lses), dim=0)
    m = lse_stack.amax(dim=0)
    w = torch.exp(lse_stack - m[None])
    denom = w.sum(dim=0)
    wn = w / denom
    out = sum(o.float() * wn[i][..., None] for i, o in enumerate(outs))
    return out.to(outs[0].dtype), m + torch.log(denom)
