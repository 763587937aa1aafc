"""Multi-level pooled block-sparse attention (the inference lane of ASA).

Counterpart of ``blade/kernels/multilevel_attn.py``'s fused lane.  Each
``(mask row, 128-key block)`` pair is attended at one level: 0 skips it, 1
attends to its keys, L in {2, 4, 8} to its L-times mean-pooled keys and
values with a ``+log(L)`` score bias; all levels share one softmax.  The
levels arrive as per-level ascending lists (``masks.multilevel_lists``) or
as an int level mask.

On the card, ``pack_kv_pyramid`` (``csrc/pack.cu``) builds the level-1 and
pooled records in one pass and ``bt_multilevel_fwd``
(``csrc/multilevel_attn.cu``) walks the four lists into one online-softmax
carry.  CPU tensors take the plain version,
``ref_attention.multilevel_lists_attention``.  Forward-only: the multilevel
backward belongs to CogVideoX training, a later slice.  Geometries outside
``fused_supported`` run JAX's per-level lane, which is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from blade_torch.attention.masks import mask_to_block_lists
from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream
from blade_torch.kernels.pack import KV_BLOCK, pack_kv_pyramid
from blade_torch.kernels.ref_attention import multilevel_lists_attention

__all__ = ["multilevel_attention", "multilevel_from_records", "fused_supported",
           "levels_to_lists"]

# The JAX lane selection's VMEM budgets (``multilevel_attn.py:489-495``),
# kept so the port picks the fused lane for exactly the same geometries.
FUSED_PYR_BUDGET = 5 * 1024 * 1024
FUSED_RES_BUDGET = 7 * 1024 * 1024

_ml_kernel = CudaKernel(
    "multilevel_fwd", "bt_multilevel_fwd", "pppppppppiiiiiiifp",
    source="blade_torch/csrc/multilevel_attn.cu",
    replaces="blade/kernels/multilevel_attn.py:521",  # _fused_ml_kernel
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


def multilevel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    levels: Optional[torch.Tensor] = None,
    *,
    lists=None,
    q_rows: int = 128,
    scale: Optional[float] = None,
):
    """Multi-level pooled sparse attention over ``[B, H, L, D]``; returns
    ``(out [B, H, Lq, D], lse [B, H, Lq])``.

    ``lists``: ``(idx [B, H, n_q, 4, cap], counts [B, H, n_q, 4])`` per-level
    ascending lists (levels 1, 2, 4, 8; ``cap`` at least every count);
    otherwise ``levels``, an int mask ``[B, H, n_q, n_k]`` in {0, 1, 2, 4, 8}.
    Mask row ``i`` covers queries ``[i * q_rows, (i + 1) * q_rows)`` with
    ``n_q = ceil(Lq / q_rows)``; ``q_rows`` is 128 or 256.
    """
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q_rows not in (128, 256):
        raise ValueError(f"q_rows must be 128 or 256, got {q_rows}")
    if not fused_supported(d, lk, q.element_size()):
        raise NotImplementedError(
            f"multilevel_attention: d={d}, Lk={lk} ({-(-lk // KV_BLOCK)} key blocks) "
            "needs the per-level lane (blade/kernels/multilevel_attn.py:283-312), "
            "which is not ported yet")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("multilevel_attention is forward-only: call it under "
                           "torch.no_grad()")
    if lists is None:
        if levels is None:
            raise ValueError("multilevel_attention needs levels or lists")
        lists = levels_to_lists(levels)
    idx, cnt = lists
    n_q = -(-lq // q_rows)
    if tuple(idx.shape[:-1]) != (b, h, n_q, 4) or tuple(cnt.shape) != (b, h, n_q, 4):
        raise ValueError(f"lists idx {tuple(idx.shape)} counts {tuple(cnt.shape)} must "
                         f"be [{b}, {h}, {n_q}, 4, cap] and [{b}, {h}, {n_q}, 4]")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        if int(cnt.max()) > idx.shape[-1]:
            raise ValueError("a list count exceeds the list capacity")
        return multilevel_lists_attention(q, k, v, (idx, cnt), q_rows=q_rows, scale=scale)
    return _multilevel_cuda(q, k, v, idx, cnt, q_rows, scale)
