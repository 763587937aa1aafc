"""Multi-level pooled block-sparse attention (the inference lane of ASA).

Counterpart of ``blade/kernels/multilevel_attn.py``, both of its lanes.
Each ``(mask row, 128-key block)`` pair is attended at one level: 0 skips
it, 1 attends to its keys, L in {2, 4, 8} to its L-times mean-pooled keys
and values with a ``+log(L)`` score bias; all levels share one softmax.

* The fused lane (``fused_supported``: at most 256 key blocks, d in {64,
  128}) takes per-level ascending lists (``masks.multilevel_lists``) or an
  int level mask.  On the card ``pack_kv_pyramid`` (``csrc/pack.cu``)
  builds the level-1 and pooled records in one pass and
  ``bt_multilevel_fwd`` (``csrc/multilevel_attn.cu``) walks the four lists
  into one online-softmax carry.
* The per-level lane (every other geometry, e.g. Wan2.1-14B 720p with 591
  key blocks) takes an int level mask at 128-row granularity.  Level 1 runs
  ``block_sparse_attention`` (``pack_kv`` + the sparse kernel); each pooled
  level runs ``bt_pooled_level_fwd`` (``csrc/pooled_level_attn.cu``) over
  that level's ``pack_kv_pyramid`` records; the four ``(out, lse)`` pairs
  are merged exactly by LSE in f32.

CPU tensors take the plain versions (``ref_attention``).  Forward-only: no
entry point reaches the multilevel backward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from blade_torch.attention.masks import mask_to_block_lists
from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream
from blade_torch.kernels.block_sparse_attn import block_sparse_attention
from blade_torch.kernels.pack import KV_BLOCK, pack_kv_pyramid
from blade_torch.kernels.ref_attention import (
    merge_attention,
    multilevel_lists_attention,
    pooled_level_attention_reference,
)

__all__ = ["multilevel_attention", "multilevel_from_records", "fused_supported",
           "levels_to_lists", "pooled_level_attention", "pooled_level_from_records"]

# The JAX lane selection's VMEM budgets (``multilevel_attn.py:489-495``),
# kept so the port picks the fused lane for exactly the same geometries.
FUSED_PYR_BUDGET = 5 * 1024 * 1024
FUSED_RES_BUDGET = 7 * 1024 * 1024

_ml_kernel = CudaKernel(
    "multilevel_fwd", "bt_multilevel_fwd", "pppppppppiiiiiiifp",
    source="blade_torch/csrc/multilevel_attn.cu",
    replaces="blade/kernels/multilevel_attn.py:521",  # _fused_ml_kernel
)
_pooled_kernel = CudaKernel(
    "pooled_level_fwd", "bt_pooled_level_fwd", "ppppppiiiiiiiifp",
    source="blade_torch/csrc/pooled_level_attn.cu",
    # _sparse_fwd_kernel (HBM-gathered segments) and _vmem_level_kernel
    # (resident pyramid): one function, two TPU memory placements
    replaces="blade/kernels/block_sparse_attn.py:233; blade/kernels/multilevel_attn.py:62",
)


def fused_supported(d: int, lk: int, itemsize: int = 2) -> bool:
    """Whether the fused multi-level lane covers this geometry (JAX's rule:
    ``n_kt <= 256``, ``d`` in {64, 128} and the pooled pyramids within its
    residency budgets)."""
    n_kt = -(-lk // KV_BLOCK)
    if n_kt > 256 or d not in (64, 128):
        return False
    if n_kt * (64 + 32 + 16) * 2 * d * itemsize <= FUSED_PYR_BUDGET:
        return True
    return n_kt * (32 + 16) * 2 * d * itemsize <= FUSED_RES_BUDGET


def levels_to_lists(levels: torch.Tensor):
    """Int level mask ``[..., n_q, n_k]`` -> per-level lists ``(idx [..., n_q,
    4, n_k], counts [..., n_q, 4])`` for levels 1, 2, 4, 8."""
    per = [mask_to_block_lists(levels == lv) for lv in (1, 2, 4, 8)]
    return (torch.stack([i for i, _ in per], dim=-2),
            torch.stack([c for _, c in per], dim=-1))


def multilevel_from_records(q, records, idx, cnt, lk: int, q_rows: int, scale: float):
    """The kernel alone: ``q [B, H, Lq, d]`` bf16 over ``records``, the
    ``pack_kv_pyramid`` output of the ``Lk``-long K/V, and int32 lists on
    q's device.  Returns ``(out, lse)``."""
    check_inputs("multilevel_attention", q, *records, dtype=torch.bfloat16)
    check_inputs("multilevel_attention", idx, cnt, dtype=torch.int32)
    b, h, lq, d = q.shape
    n_kt = -(-lk // KV_BLOCK)
    want = [(b * h, 2 * n_kt * (KV_BLOCK >> i), d) for i in range(4)]
    if [tuple(r.shape) for r in records] != want:
        raise ValueError(f"records {[tuple(r.shape) for r in records]} must be {want}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _ml_kernel(q.data_ptr(), *(r.data_ptr() for r in records), idx.data_ptr(),
               cnt.data_ptr(), out.data_ptr(), lse.data_ptr(), b * h, lq, lk, d,
               idx.shape[-3], idx.shape[-1], q_rows, float(scale), cuda_stream(q.device))
    return out, lse


def _multilevel_cuda(q, k, v, idx, cnt, q_rows, scale):
    check_inputs("multilevel_attention", q, k, v, dtype=torch.bfloat16)
    b, h, _, d = q.shape
    lk = k.shape[2]
    records = pack_kv_pyramid(k.reshape(b * h, lk, d), v.reshape(b * h, lk, d))
    idx = idx.to(device=q.device, dtype=torch.int32).contiguous()
    cnt = cnt.to(device=q.device, dtype=torch.int32).contiguous()
    return multilevel_from_records(q, records, idx, cnt, lk, q_rows, scale)


def _check_pooled(q, records, level):
    """(n_kt, seg): the block count and segment rows of one level's records."""
    if level not in (2, 4, 8):
        raise ValueError(f"pooled level must be 2, 4 or 8, got {level}")
    seg = KV_BLOCK // level
    bh, _, d = q.shape
    n_kt = records.shape[1] // (2 * seg)
    if records.dim() != 3 or tuple(records.shape) != (bh, 2 * n_kt * seg, d) or n_kt == 0:
        raise ValueError(f"records {tuple(records.shape)} must be [{bh}, 2 * n_kt * {seg}, {d}]")
    return n_kt, seg


def pooled_level_from_records(q, records, idx, cnt, *, level: int, scale: float,
                              pooled_valid_len: int):
    """The kernel alone: ``q [BH, Lq, d]`` bf16 over one level's records
    (``records [BH, 2 * n_kt * 128/level, d]``, ``pack_kv_pyramid``'s
    level-``level`` output) and int32 lists ``idx [BH, ceil(Lq/128), max_k]``,
    ``cnt [BH, ceil(Lq/128)]`` on q's device.  Returns ``(out, lse)``."""
    check_inputs("pooled_level_attention", q, records, dtype=torch.bfloat16)
    check_inputs("pooled_level_attention", idx, cnt, dtype=torch.int32)
    n_kt, seg = _check_pooled(q, records, level)
    bh, lq, d = q.shape
    n_qt = -(-lq // KV_BLOCK)
    if tuple(idx.shape[:2]) != (bh, n_qt) or tuple(cnt.shape) != (bh, n_qt):
        raise ValueError(f"lists idx {tuple(idx.shape)} counts {tuple(cnt.shape)} must be "
                         f"[{bh}, {n_qt}, max_k] and [{bh}, {n_qt}]")
    if not 0 < pooled_valid_len <= n_kt * seg:
        raise ValueError(f"pooled_valid_len {pooled_valid_len} outside (0, {n_kt * seg}]")
    out = torch.empty_like(q)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    _pooled_kernel(q.data_ptr(), records.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                   out.data_ptr(), lse.data_ptr(), bh, lq, n_kt, d, level, n_qt,
                   idx.shape[-1], pooled_valid_len, float(scale), cuda_stream(q.device))
    return out, lse


def pooled_level_attention(q, records, block_mask, *, level: int, scale: float,
                           pooled_valid_len: int):
    """One pooled level of the per-level lane (JAX's
    ``pooled_level_attention``): ``q [BH, Lq, d]`` against the level's
    records ``[BH, 2 * n_kt * 128/level, d]`` (block ``b``: its ``128/level``
    pooled K rows, then its pooled V rows), the blocks of mask row ``i``
    (queries ``[128 i, 128 (i + 1))``) given by ``block_mask`` bool ``[BH,
    ceil(Lq/128), n_kt]``.  Pooled rows at or past ``pooled_valid_len`` are
    masked; the lse carries ``+log(level)``.  Returns ``(out [BH, Lq, d],
    lse [BH, Lq])``; a row with no block gets out 0 and lse -1e30."""
    n_kt, seg = _check_pooled(q, records, level)
    if tuple(block_mask.shape) != (q.shape[0], -(-q.shape[1] // KV_BLOCK), n_kt):
        raise ValueError(f"block_mask {tuple(block_mask.shape)} does not match q "
                         f"{tuple(q.shape)} and {n_kt} key blocks")
    if not q.is_cuda:
        rec = records.view(records.shape[0], n_kt, 2, seg, records.shape[-1])
        k_pool, v_pool = (rec[:, :, i].reshape(records.shape[0], n_kt * seg, -1)
                          for i in (0, 1))
        return pooled_level_attention_reference(q, k_pool, v_pool, block_mask, level=level,
                                                scale=scale, pooled_valid_len=pooled_valid_len)
    idx, cnt = mask_to_block_lists(block_mask)
    return pooled_level_from_records(q, records, idx.contiguous(), cnt.contiguous(),
                                     level=level, scale=scale,
                                     pooled_valid_len=pooled_valid_len)


def _multilevel_per_level(q, k, v, levels, scale):
    """JAX's per-level lane (``multilevel_attn.py:420-463``): level 1 through
    the block-sparse kernel, each pooled level through the pooled-level
    kernel over the edge-padded pyramid, an exact f32 LSE merge of the four
    ``(out, lse)`` pairs (each ``out`` in q's dtype, as JAX rounds it)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    n_qt, n_kt = -(-lq // KV_BLOCK), -(-lk // KV_BLOCK)
    if tuple(levels.shape) != (b, h, n_qt, n_kt):
        raise ValueError(f"the per-level lane takes a 128-row level mask {(b, h, n_qt, n_kt)}, "
                         f"got {tuple(levels.shape)}")
    levels = levels.to(q.device)
    out1, lse1 = block_sparse_attention(q, k, v, levels == 1, scale=scale)
    outs, lses = [out1], [lse1]
    q3 = q.reshape(b * h, lq, d)
    records = pack_kv_pyramid(k.reshape(b * h, lk, d), v.reshape(b * h, lk, d))
    for level, rec in zip((2, 4, 8), records[1:]):
        out_l, lse_l = pooled_level_attention(
            q3, rec, (levels == level).reshape(b * h, n_qt, n_kt), level=level, scale=scale,
            pooled_valid_len=-(-lk // level))
        outs.append(out_l.reshape(b, h, lq, d))
        lses.append(lse_l.reshape(b, h, lq))
    return merge_attention(outs, lses)


def multilevel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    levels: Optional[torch.Tensor] = None,
    *,
    lists=None,
    q_rows: int = 128,
    scale: Optional[float] = None,
    fused: Optional[bool] = None,
):
    """Multi-level pooled sparse attention over ``[B, H, L, D]``; returns
    ``(out [B, H, Lq, D], lse [B, H, Lq])``.

    ``lists``: ``(idx [B, H, n_q, 4, cap], counts [B, H, n_q, 4])`` per-level
    ascending lists (levels 1, 2, 4, 8; ``cap`` at least every count);
    otherwise ``levels``, an int mask ``[B, H, n_q, n_k]`` in {0, 1, 2, 4, 8}.
    Mask row ``i`` covers queries ``[i * q_rows, (i + 1) * q_rows)`` with
    ``n_q = ceil(Lq / q_rows)``; ``q_rows`` is 128 or 256.

    ``fused=None`` picks the fused lane where ``fused_supported`` holds and
    the per-level lane elsewhere; ``False`` forces the per-level lane, which
    takes an int level mask with ``q_rows == 128`` only.
    """
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q_rows not in (128, 256):
        raise ValueError(f"q_rows must be 128 or 256, got {q_rows}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("multilevel_attention is forward-only: call it under "
                           "torch.no_grad()")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if fused is None:
        fused = fused_supported(d, lk, q.element_size())
    if not fused:
        if lists is not None:
            raise ValueError("precomputed lists require the fused lane")
        if q_rows != 128:
            raise ValueError("q_rows != 128 requires the fused lane")
        if levels is None:
            raise ValueError("the per-level lane needs an int level mask")
        return _multilevel_per_level(q, k, v, levels, scale)
    if lists is None:
        if levels is None:
            raise ValueError("multilevel_attention needs levels or lists")
        lists = levels_to_lists(levels)
    idx, cnt = lists
    n_q = -(-lq // q_rows)
    if tuple(idx.shape[:-1]) != (b, h, n_q, 4) or tuple(cnt.shape) != (b, h, n_q, 4):
        raise ValueError(f"lists idx {tuple(idx.shape)} counts {tuple(cnt.shape)} must "
                         f"be [{b}, {h}, {n_q}, 4, cap] and [{b}, {h}, {n_q}, 4]")
    if not q.is_cuda:
        if int(cnt.max()) > idx.shape[-1]:
            raise ValueError("a list count exceeds the list capacity")
        return multilevel_lists_attention(q, k, v, (idx, cnt), q_rows=q_rows, scale=scale)
    return _multilevel_cuda(q, k, v, idx, cnt, q_rows, scale)
