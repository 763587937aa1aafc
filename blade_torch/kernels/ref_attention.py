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

__all__ = [
    "dense_attention_with_lse",
    "block_masked_attention",
    "attention_backward_reference",
    "merge_attention",
    "mean_pool_kv",
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
    is ``NEG_INF`` (empty) contributes nothing.  f32 math, chunked over
    query rows like the forwards; the results come back in the inputs'
    dtypes.
    """
    lq, lk = q.shape[-2], k.shape[-2]
    lead = math.prod(q.shape[:-2])
    kf, vf = k.float(), v.float()
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
