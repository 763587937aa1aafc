"""Multi-level pooled block-sparse attention (the inference lane of ASA).

Counterpart of ``blade/kernels/multilevel_attn.py``, both of its lanes.
Each ``(mask row, 128-key block)`` pair is attended at one level: 0 skips
it, 1 attends to its keys, L in {2, 4, 8} to its L-times mean-pooled keys
and values with a ``+log(L)`` score bias; all levels share one softmax.

* The fused lane (``fused_supported``: at most 256 key blocks, d in {64,
  128}) takes per-level ascending lists (``masks.multilevel_lists``) or an
  int level mask.  On the card ``pack_kv_pyramid`` (``csrc/pack.cu``)
  builds the level-1 and pooled records in one pass and
  ``bt_multilevel_fwd`` (``csrc/gather_attn.cu``) walks the four lists
  into one online-softmax carry.
* The level carry (on the card, past JAX's rule: an int level mask at
  128-row granularity with d in {64, 128}, e.g. Wan2.1-14B 720p with 591
  key blocks): the mask's four lists are built inside the call and the
  fused lane's pyramid pack and kernel run over them.  The rule bounds
  what a TPU keeps resident in VMEM; the CUDA kernel keeps nothing
  resident across blocks, so the bound does not exist on the card.
* The per-level lane (every other geometry past the rule, every CPU call
  past it, and ``fused=False``) takes an int level mask at 128-row
  granularity.  Level 1 runs ``block_sparse_attention`` (``pack_kv`` + the
  sparse kernel); each pooled level runs ``bt_pooled_level_fwd``
  (``csrc/gather_attn.cu``) over that level's ``pack_kv_pyramid``
  records; the four ``(out, lse)`` pairs are merged exactly by LSE in f32.

Both lanes are differentiable in ``q, k, v``, each through one
``torch.autograd.Function``, the counterpart of JAX's custom VJPs:

* fused lane and level carry (``_fused_ml_core_bwd``): the four level
  masks are rebuilt from the lists (each mask row repeated onto its
  128-row tiles when ``q_rows`` is 256) and four passes run against the
  GLOBAL merged ``(out, lse)``: level 1 through the block-sparse backward
  kernels (``block_sparse_attn.attention_backward``), levels 2, 4, 8
  through the pooled-level backward kernels (``csrc/pooled_level_bwd.cu``)
  with a ``+log(L)`` bias; the passes sum;
* per-level lane (``_pooled_level_core_bwd``): level 1 is
  ``block_sparse_attention``'s own Function, the three pooled levels one
  Function over a shared pyramid whose backward runs each level against
  its own ``(out_l, lse_l)``; ``merge_attention`` backpropagates through
  torch autograd, as JAX differentiates its merge.

JAX pools outside its custom VJP and lets XLA un-pool; the port's pyramid
comes from a pack kernel, so the Functions un-pool explicitly: a pooled
row's dK/dV spreads as ``1/L`` over the ``L`` edge-padded keys it averages,
and the shares of the padded copies past ``Lk`` go to key ``Lk - 1``.

CPU tensors take the plain versions (``ref_attention``): the plain forward
and, in the same Functions, the plain per-pass backward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from blade_torch.attention.masks import mask_to_block_lists
from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream
from blade_torch.kernels.block_sparse_attn import (
    _aligned,
    attention_backward,
    attention_delta,
    block_sparse_attention,
)
from blade_torch.kernels.pack import KV_BLOCK, pack_kv_pyramid
from blade_torch.kernels.ref_attention import (
    lists_to_level_masks,
    merge_attention,
    multilevel_lists_attention,
    pooled_level_attention_reference,
    pooled_level_backward_reference,
)
from blade_torch.utils import tracing

__all__ = ["multilevel_attention", "multilevel_from_records", "fused_supported",
           "levels_to_lists", "pooled_level_attention", "pooled_level_from_records",
           "pooled_level_backward", "pooled_level_dq_from_records",
           "pooled_level_dkv_from_records"]

# The JAX lane selection's VMEM budgets (``multilevel_attn.py:489-495``),
# kept so the port picks the fused lane for exactly the same geometries.
FUSED_PYR_BUDGET = 5 * 1024 * 1024
FUSED_RES_BUDGET = 7 * 1024 * 1024

_ml_kernel = CudaKernel(
    "multilevel_fwd", "bt_multilevel_fwd", "pppppppppiiiiiiifp",
    source="blade_torch/csrc/gather_attn.cu",
    replaces="blade/kernels/multilevel_attn.py:521",  # _fused_ml_kernel
)
_pooled_kernel = CudaKernel(
    "pooled_level_fwd", "bt_pooled_level_fwd", "ppppppiiiiiiiifp",
    source="blade_torch/csrc/gather_attn.cu",
    # _sparse_fwd_kernel (HBM-gathered segments) and _vmem_level_kernel
    # (resident pyramid): one function, two TPU memory placements
    replaces="blade/kernels/block_sparse_attn.py:233; blade/kernels/multilevel_attn.py:62",
)
_POOLED_BWD_SOURCE = "blade_torch/csrc/pooled_level_bwd.cu"
# _sparse_dq_kernel / _sparse_dkv_kernel at seg_rows 64/32/16, as
# gather_backward launches them (block_sparse_attn.py:1488 and :1526)
_pooled_dq_kernel = CudaKernel(
    "pooled_level_dq", "bt_pooled_level_dq", "pppppppppiiiiiiiifp",
    source=_POOLED_BWD_SOURCE, replaces="blade/kernels/block_sparse_attn.py:646",
)
_pooled_dkv_kernel = CudaKernel(
    "pooled_level_dkv", "bt_pooled_level_dkv", "ppppppppppiiiiiiifp",
    source=_POOLED_BWD_SOURCE, replaces="blade/kernels/block_sparse_attn.py:758",
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


def _split_records(records, n_kt, seg):
    """Level records ``[BH, 2 * n_kt * seg, d]`` -> ``(k_pool, v_pool)``,
    each ``[BH, n_kt * seg, d]``."""
    rec = records.view(records.shape[0], n_kt, 2, seg, records.shape[-1])
    return tuple(rec[:, :, i].reshape(records.shape[0], n_kt * seg, -1) for i in (0, 1))


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
        k_pool, v_pool = _split_records(records, n_kt, seg)
        return pooled_level_attention_reference(q, k_pool, v_pool, block_mask, level=level,
                                                scale=scale, pooled_valid_len=pooled_valid_len)
    idx, cnt = mask_to_block_lists(block_mask)
    return pooled_level_from_records(q, records, idx.contiguous(), cnt.contiguous(),
                                     level=level, scale=scale,
                                     pooled_valid_len=pooled_valid_len)


def _check_pooled_bwd(q, records, out, lse, g_out, g_lse, delta, level):
    check_inputs("pooled_level_backward", q, records, out, g_out, dtype=torch.bfloat16)
    check_inputs("pooled_level_backward", lse, g_lse, delta, dtype=torch.float32)
    if out.shape != q.shape or g_out.shape != q.shape or not (
            lse.shape == g_lse.shape == delta.shape == q.shape[:2]):
        raise ValueError("pooled_level_backward: out, g_out must be q's shape and lse, "
                         "g_lse, delta [BH, Lq]")
    return _check_pooled(q, records, level)


def pooled_level_dq_from_records(q, records, out, lse, g_out, g_lse, delta, idx, cnt, *,
                                 level: int, scale: float, pooled_valid_len: int):
    """The dQ kernel alone: ``q, out, g_out [BH, Lq, d]`` bf16, ``lse, g_lse,
    delta [BH, Lq]`` f32, one level's records and its int32 lists ``idx [BH,
    ceil(Lq/128), max_k]``, ``cnt [BH, ceil(Lq/128)]`` -> ``dq``."""
    n_kt, _ = _check_pooled_bwd(q, records, out, lse, g_out, g_lse, delta, level)
    check_inputs("pooled_level_dq", idx, cnt, dtype=torch.int32)
    bh, lq, d = q.shape
    dq = torch.empty_like(q)
    _pooled_dq_kernel(q.data_ptr(), records.data_ptr(), g_out.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), g_lse.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                      dq.data_ptr(), bh, lq, n_kt, d, level, idx.shape[1], idx.shape[-1],
                      pooled_valid_len, float(scale), cuda_stream(q.device))
    return dq


def pooled_level_dkv_from_records(q, records, out, lse, g_out, g_lse, delta, t_idx, t_cnt, *,
                                  level: int, scale: float, pooled_valid_len: int):
    """The dK/dV kernel alone: as :func:`pooled_level_dq_from_records` with
    the transposed lists ``t_idx [BH, n_kt, max_q]``, ``t_cnt [BH, n_kt]``
    (the 128-row query tiles that selected each block) -> ``(dk, dv)`` of
    the pooled rows, ``[BH, n_kt * 128/level, d]``."""
    n_kt, seg = _check_pooled_bwd(q, records, out, lse, g_out, g_lse, delta, level)
    check_inputs("pooled_level_dkv", t_idx, t_cnt, dtype=torch.int32)
    bh, lq, d = q.shape
    dk = torch.empty((bh, n_kt * seg, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _pooled_dkv_kernel(q.data_ptr(), records.data_ptr(), g_out.data_ptr(), lse.data_ptr(),
                       delta.data_ptr(), g_lse.data_ptr(), t_idx.data_ptr(), t_cnt.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(), bh, lq, n_kt, d, level, t_idx.shape[-1],
                       pooled_valid_len, float(scale), cuda_stream(q.device))
    return dk, dv


def pooled_level_backward(q, records, out, lse, g_out, g_lse, block_mask, *, level: int,
                          scale: float, pooled_valid_len: int, delta=None):
    """The backward of one pooled level (JAX's ``gather_backward`` at
    ``seg_rows = 128/level``): ``q, out, g_out [BH, Lq, d]``, ``lse, g_lse
    [BH, Lq]`` (the level's own lse, or the merged one of all levels),
    ``records`` the level's ``pack_kv_pyramid`` output and ``block_mask``
    bool ``[BH, ceil(Lq/128), n_kt]``.  Returns ``(dq, dk_pool, dv_pool)``,
    the pooled gradients ``[BH, n_kt * 128/level, d]``.  ``delta =
    rowsum(g_out * out)`` may be passed when several passes share it."""
    n_kt, seg = _check_pooled(q, records, level)
    if tuple(block_mask.shape) != (q.shape[0], -(-q.shape[1] // KV_BLOCK), n_kt):
        raise ValueError(f"block_mask {tuple(block_mask.shape)} does not match q "
                         f"{tuple(q.shape)} and {n_kt} key blocks")
    if not q.is_cuda:
        k_pool, v_pool = _split_records(records, n_kt, seg)
        return pooled_level_backward_reference(
            q, k_pool, v_pool, out, lse, g_out, g_lse, block_mask, level=level, scale=scale,
            pooled_valid_len=pooled_valid_len, delta=delta)
    # Autograd hands over cotangents that may be views at any offset (the
    # merge's per-level lse cotangents); the kernels take 16-byte aligned rows.
    dtype = q.dtype
    q, out, g_out = (_aligned(t.to(dtype)) for t in (q, out, g_out))
    if delta is None:
        delta = attention_delta(out, g_out)
    lse, g_lse, delta = (_aligned(t.float()) for t in (lse, g_lse, delta))
    kw = dict(level=level, scale=scale, pooled_valid_len=pooled_valid_len)
    lists = (t.contiguous() for t in mask_to_block_lists(block_mask))
    t_lists = (t.contiguous() for t in mask_to_block_lists(block_mask.transpose(-1, -2)))
    dq = pooled_level_dq_from_records(q, records, out, lse, g_out, g_lse, delta, *lists, **kw)
    dk, dv = pooled_level_dkv_from_records(q, records, out, lse, g_out, g_lse, delta,
                                           *t_lists, **kw)
    return dq, dk, dv


def _unpool(pooled, lk):
    """Each pooled level's ``(level, [B, H, n_kt * 128/level, d])`` gradient
    un-pooled onto the ``Lk`` keys, summed in f32: a pooled row spreads
    ``1/level`` of its gradient over the ``level`` edge-padded keys it
    averages, and the shares of the padded copies past ``Lk`` (the last key
    repeated) go to key ``Lk - 1``."""
    acc = sum(g.float().repeat_interleave(level, dim=-2) / level for level, g in pooled)
    tail = acc[..., lk:, :].sum(dim=-2)
    acc = acc[..., :lk, :]
    acc[..., -1, :] += tail
    return acc


def _flat(t):
    """``[B, H, L, d]`` (or ``[B, H, L]``) -> contiguous ``[BH, L, ...]``."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:]).contiguous()


class _FusedMultilevel(torch.autograd.Function):
    """The fused lane, ``(out, lse)`` differentiable in ``q, k, v``: JAX's
    ``_fused_ml_core`` custom VJP with the pooling inside (the backward
    un-pools)."""

    @staticmethod
    def forward(ctx, q, k, v, idx, cnt, q_rows, scale):
        b, h, lq, d = q.shape
        lk = k.shape[2]
        records = pack_kv_pyramid(_flat(k), _flat(v))
        if q.is_cuda:
            check_inputs("multilevel_attention", q, k, v, dtype=torch.bfloat16)
            idx = idx.to(device=q.device, dtype=torch.int32).contiguous()
            cnt = cnt.to(device=q.device, dtype=torch.int32).contiguous()
            out, lse = multilevel_from_records(q, records, idx, cnt, lk, q_rows, scale)
        else:
            out, lse = multilevel_lists_attention(q, k, v, (idx, cnt), q_rows=q_rows,
                                                  scale=scale)
        ctx.save_for_backward(q, k, v, out, lse, idx, cnt, *records[1:])
        ctx.q_rows, ctx.scale = q_rows, scale
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, idx, cnt, *records = ctx.saved_tensors
        b, h, lq, d = q.shape
        lk = k.shape[2]
        n_qt, n_kt = -(-lq // KV_BLOCK), -(-lk // KV_BLOCK)
        masks = lists_to_level_masks(idx, cnt, n_kt)  # [B, H, n_q, 4, n_kt]
        if ctx.q_rows != KV_BLOCK:  # each mask row onto its 128-row tiles
            masks = masks.repeat_interleave(ctx.q_rows // KV_BLOCK, dim=2)[:, :, :n_qt]
        g_out = g_out.to(q.dtype)
        delta = attention_delta(out, g_out)
        dq, dk, dv = attention_backward(q, k, v, out, lse, g_out, g_lse, masks[:, :, :, 0],
                                        scale=ctx.scale, delta=delta)
        dq = dq.float()
        flat = [_flat(t) for t in (q, out, lse, g_out, g_lse, delta)]
        dks, dvs = [], []
        for li, (level, rec) in enumerate(zip((2, 4, 8), records), start=1):
            dq_l, dk_l, dv_l = pooled_level_backward(
                flat[0], rec, *flat[1:5], _flat(masks[:, :, :, li]), level=level, scale=ctx.scale,
                pooled_valid_len=-(-lk // level), delta=flat[5])
            dq += dq_l.float().reshape(q.shape)
            dks.append((level, dk_l.reshape(b, h, -1, d)))
            dvs.append((level, dv_l.reshape(b, h, -1, d)))
        dk = (dk.float() + _unpool(dks, lk)).to(k.dtype)
        dv = (dv.float() + _unpool(dvs, lk)).to(v.dtype)
        return dq.to(q.dtype), dk, dv, None, None, None, None


class _PooledLevels(torch.autograd.Function):
    """Levels 2, 4 and 8 of the per-level lane over one shared pyramid:
    ``(out_2, lse_2, out_4, lse_4, out_8, lse_8)`` differentiable in ``q, k,
    v``; the backward runs each level against its own ``(out_l, lse_l)``
    (JAX's ``_pooled_level_core_bwd``) and un-pools."""

    @staticmethod
    def forward(ctx, q, k, v, levels, scale):
        b, h, lq, d = q.shape
        lk = k.shape[2]
        n_qt, n_kt = -(-lq // KV_BLOCK), -(-lk // KV_BLOCK)
        q3 = _flat(q)
        records = pack_kv_pyramid(_flat(k), _flat(v))[1:]
        outs = []
        for level, rec in zip((2, 4, 8), records):
            out_l, lse_l = pooled_level_attention(
                q3, rec, (levels == level).reshape(b * h, n_qt, n_kt), level=level,
                scale=scale, pooled_valid_len=-(-lk // level))
            outs += [out_l.reshape(b, h, lq, d), lse_l.reshape(b, h, lq)]
        ctx.save_for_backward(q, levels, *records, *outs)
        ctx.scale, ctx.lk = scale, lk
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        q, levels, *saved = ctx.saved_tensors
        records, outs = saved[:3], saved[3:]
        b, h, lq, d = q.shape
        n_qt, n_kt = levels.shape[-2:]
        q3 = _flat(q)
        dq = torch.zeros(q3.shape, dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for i, (level, rec) in enumerate(zip((2, 4, 8), records)):
            dq_l, dk_l, dv_l = pooled_level_backward(
                q3, rec, _flat(outs[2 * i]), _flat(outs[2 * i + 1]),
                _flat(grads[2 * i].to(q.dtype)), _flat(grads[2 * i + 1]),
                (levels == level).reshape(b * h, n_qt, n_kt), level=level, scale=ctx.scale,
                pooled_valid_len=-(-ctx.lk // level))
            dq += dq_l.float()
            dks.append((level, dk_l.reshape(b, h, -1, d)))
            dvs.append((level, dv_l.reshape(b, h, -1, d)))
        return (dq.reshape(q.shape).to(q.dtype), _unpool(dks, ctx.lk).to(q.dtype),
                _unpool(dvs, ctx.lk).to(q.dtype), None, None)


def _level_mask(q, k, levels, lane):
    """``levels`` on q's device, checked to be a 128-row level mask
    ``[B, H, ceil(Lq/128), ceil(Lk/128)]`` of ``q`` and ``k``."""
    b, h, lq, _ = q.shape
    shape = (b, h, -(-lq // KV_BLOCK), -(-k.shape[2] // KV_BLOCK))
    if tuple(levels.shape) != shape:
        raise ValueError(f"{lane} takes a 128-row level mask {shape}, "
                         f"got {tuple(levels.shape)}")
    return levels.to(q.device)


def _multilevel_per_level(q, k, v, levels, scale):
    """JAX's per-level lane (``multilevel_attn.py:420-463``): level 1 through
    the block-sparse kernel, each pooled level through the pooled-level
    kernel over the edge-padded pyramid, an exact f32 LSE merge of the four
    ``(out, lse)`` pairs (each ``out`` in q's dtype, as JAX rounds it)."""
    levels = _level_mask(q, k, levels, "the per-level lane")
    out1, lse1 = block_sparse_attention(q, k, v, levels == 1, scale=scale)
    # A block recomputed in a backward opens the spans and counts nothing.
    counted = tracing.active() and not tracing.recomputing()
    span = tracing.timed if counted else tracing.span
    with span("asa.levels"):
        pooled = _PooledLevels.apply(q, k, v, levels, scale)
    with span("asa.level_merge"):
        out = merge_attention([out1, *pooled[0::2]], [lse1, *pooled[1::2]])
    if counted:
        tracing.count("asa.per_level_calls")
    return out


def _level_carry(q, k, v, levels, scale):
    """An int level mask at 128-row mask rows past JAX's fused rule, on the
    card: its four lists, built here (kept past the call only for a
    backward), drive the fused lane's one carry (``pack_kv_pyramid`` +
    ``bt_multilevel_fwd``)."""
    levels = _level_mask(q, k, levels, "the level carry")
    with tracing.span("asa.level_lists"):
        idx, cnt = levels_to_lists(levels)
    if tracing.active() and not tracing.recomputing():
        tracing.count("asa.level_carry_calls")
    return _FusedMultilevel.apply(q, k, v, idx, cnt, KV_BLOCK, float(scale))


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

    ``fused=None`` picks the fused lane where ``fused_supported`` holds;
    elsewhere an int level mask at ``q_rows == 128`` with ``D`` in {64, 128}
    on the card takes the level carry, and anything else the per-level
    lane.  ``False`` forces the per-level lane, which takes an int level
    mask with ``q_rows == 128`` only.
    """
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q_rows not in (128, 256):
        raise ValueError(f"q_rows must be 128 or 256, got {q_rows}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if fused is None:
        fused = fused_supported(d, lk, q.element_size())
        if (not fused and q.is_cuda and lists is None and levels is not None
                and q_rows == KV_BLOCK and d in (64, 128)):
            return _level_carry(q, k, v, levels, scale)
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
    if not q.is_cuda and int(cnt.max()) > idx.shape[-1]:
        raise ValueError("a list count exceeds the list capacity")
    return _FusedMultilevel.apply(q, k, v, idx, cnt, q_rows, float(scale))
