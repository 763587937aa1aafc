"""Flash attention, dense and block-sparse, with their backward passes.

Counterpart of ``blade/kernels/block_sparse_attn.py``'s public API:
``flash_attention``, ``flash_attention_wide_v`` and
``block_sparse_attention``.  On the card the dense forwards launch the
kernel of ``csrc/flash_attn.cu``, the block-sparse forward the gather kernel
of ``csrc/gather_attn.cu`` over ``pack_kv``'s records (both bf16 in, f32
accumulate, ``(out, lse)`` out), and the backwards those of
``csrc/flash_attn_bwd.cu``: dQ and dK/dV in two kernels each, no atomics,
both pairs on ``wgmma`` fed by a TMA ring (the block-sparse pair walks the
mask's lists and its transpose's, reading K/V, Q and dO in place), after
``delta = rowsum(dO * O)`` in one pass (``attention_delta``,
``csrc/attn_delta.cu``); CPU tensors take the plain versions in
``kernels/ref_attention.py`` (delta's is ``_delta_reference``).

``flash_attention`` and ``block_sparse_attention`` are differentiable
through one ``torch.autograd.Function``, the counterpart of JAX's
``_attn_with_lse`` custom VJP: the forward saves ``q, k, v, out, lse`` and
the mask, and the backward takes the cotangents of BOTH outputs (the LSE
merge of ASA's branches feeds every branch an LSE cotangent).
``flash_attention_wide_v`` (the mask predictor) is forward-only, as the
JAX predictor runs under ``stop_gradient``.

Shapes: ``[B, H, L, D]``; ``Lq`` and ``Lk`` may be ragged (no padding is
materialised: the kernels mask keys past ``Lk`` and rows past ``Lq``
themselves).  The sparse mask is bool ``[B, H, ceil(Lq/128),
ceil(Lk/128)]``; a row with no selected block gives out 0 and lse -1e30,
and no gradient.

With the module flag ``SPARSE_UNION`` set (JAX's flag of the same name and
default), the sparse forward pairs the mask rows (``QGROUP`` = 2; an odd row
count is padded with one empty row), walks the union of each pair's key
blocks with per-row validity bits (``masks.union_block_lists``, its bounded
``topk`` lane when the caller passes ``union_bound``) and launches the
gather kernel's union walk (``csrc/gather_attn.cu``: a CTA a mask row takes
the union entries its bit selects, K/V read in place, no ``pack_kv``); CPU
tensors take its plain version, the block-masked attention over the masks
rebuilt from the union lists.  The backward is unchanged: as in JAX, it rebuilds the plain
per-row lists from the mask.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from blade_torch.attention.masks import mask_to_block_lists, union_block_lists
from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream
from blade_torch.kernels.pack import KV_BLOCK, pack_kv
from blade_torch.kernels.ref_attention import (
    attention_backward_reference,
    block_masked_attention,
    dense_attention_with_lse,
)

__all__ = ["flash_attention", "flash_attention_wide_v", "block_sparse_attention",
           "attention_backward", "attention_delta", "backward_lists", "KV_BLOCK", "QGROUP",
           "SPARSE_UNION"]

QGROUP = 2  # mask rows sharing one union-gathered query tile
# Union gathering pays only where adjacent mask rows select overlapping
# blocks (Gilbert locality); off by default, as in JAX.
SPARSE_UNION = False

_dense_kernel = CudaKernel(
    "dense_fwd", "bt_attn_dense_fwd", "pppppiiiiiffp",
    source="blade_torch/csrc/flash_attn.cu",
    replaces="blade/kernels/block_sparse_attn.py:88",  # _dense_fwd_kernel
)
_sparse_kernel = CudaKernel(
    "sparse_fwd", "bt_attn_sparse_fwd", "ppppppiiiiiiffp",
    source="blade_torch/csrc/gather_attn.cu",
    replaces="blade/kernels/block_sparse_attn.py:360",  # _sparse_fwd_rows_kernel
)
_union_kernel = CudaKernel(
    "sparse_union_fwd", "bt_attn_sparse_union_fwd", "pppppppiiiiiiffp",
    source="blade_torch/csrc/gather_attn.cu",
    replaces="blade/kernels/block_sparse_attn.py:522",  # _sparse_fwd_union_kernel
)
_BWD_SOURCE = "blade_torch/csrc/flash_attn_bwd.cu"
_dense_dq_kernel = CudaKernel(
    "dense_dq", "bt_attn_dense_dq", "ppppppppiiiiffp", source=_BWD_SOURCE,
    replaces="blade/kernels/block_sparse_attn.py:147",  # _dense_dq_kernel
)
_dense_dkv_kernel = CudaKernel(
    "dense_dkv", "bt_attn_dense_dkv", "pppppppppiiiiffp", source=_BWD_SOURCE,
    replaces="blade/kernels/block_sparse_attn.py:184",  # _dense_dkv_kernel
)
_sparse_dq_kernel = CudaKernel(
    "sparse_dq", "bt_attn_sparse_dq", "ppppppppppiiiiiiffp", source=_BWD_SOURCE,
    replaces="blade/kernels/block_sparse_attn.py:646",  # _sparse_dq_kernel
)
_sparse_dkv_kernel = CudaKernel(
    "sparse_dkv", "bt_attn_sparse_dkv", "pppppppppppiiiiiiffp", source=_BWD_SOURCE,
    replaces="blade/kernels/block_sparse_attn.py:758",  # _sparse_dkv_kernel
)
_delta_kernel = CudaKernel(
    "attn_delta", "bt_attn_delta", "pppiip", source="blade_torch/csrc/attn_delta.cu",
    replaces="blade/kernels/block_sparse_attn.py:1043",  # delta in _bwd_call (XLA)
)


def _dense_cuda(q, k, v, scale, bias):
    check_inputs("flash_attention", q, k, v, dtype=torch.bfloat16)
    b, h, lq, d = q.shape
    lk, dv = k.shape[2], v.shape[3]
    if d not in (64, 128) or dv % 64:
        raise ValueError(f"flash_attention: the kernel takes d in (64, 128) and "
                         f"dv % 64 == 0 (d={d}, dv={dv})")
    out = torch.empty((b, h, lq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _dense_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), b * h, lq, lk, d, dv, float(scale),
                  float(bias), cuda_stream(q.device))
    return out, lse


def _check_qkv(q, k, v, same_dv: bool):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention inputs must be [B, H, L, D]")
    if q.shape[:2] != k.shape[:2] or k.shape[:3] != v.shape[:3] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if same_dv and v.shape[3] != q.shape[3]:
        raise ValueError("V must have Q's head dim here")


def _sparse_cuda(q, k, v, mask, scale, bias):
    check_inputs("block_sparse_attention", q, k, v, dtype=torch.bfloat16)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d not in (64, 128):
        raise ValueError(f"block_sparse_attention: the kernel takes d in "
                         f"(64, 128), got {d}")
    n_qt, n_kt = mask.shape[-2:]
    idx, cnt = mask_to_block_lists(mask.reshape(b * h, n_qt, n_kt))
    idx, cnt = idx.contiguous(), cnt.contiguous()
    kv = pack_kv(k.reshape(b * h, lk, d), v.reshape(b * h, lk, d))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _sparse_kernel(q.data_ptr(), kv.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                   out.data_ptr(), lse.data_ptr(), b * h, lq, lk, d, n_qt,
                   idx.shape[-1], float(scale), float(bias),
                   cuda_stream(q.device))
    return out, lse


def _union_lists(mask, bound):
    """``mask [BH, n_qt, n_kt]`` -> the union lists of its row pairs:
    ``(entries [BH, n_pairs, n_kt], counts [BH, n_pairs])`` int32, each entry
    ``block | valbits << 16``.  An odd row count gets one empty row."""
    if mask.shape[-2] % QGROUP:
        pad = torch.zeros((mask.shape[0], QGROUP - mask.shape[-2] % QGROUP, mask.shape[-1]),
                          dtype=mask.dtype, device=mask.device)
        mask = torch.cat([mask, pad], dim=-2)
    idx, cnt, bits = union_block_lists(mask, group=QGROUP, bound=bound)
    return (idx | (bits << 16)).contiguous(), cnt.contiguous()


def _union_reference(q, k, v, entries, counts, scale, bias):
    """Plain version of the union kernel on its own inputs: each mask row
    rebuilt from its pair's union entries and validity bits, then the
    block-masked attention."""
    b, h, lq, _ = q.shape
    n_qt, n_kt = -(-lq // 128), -(-k.shape[2] // KV_BLOCK)
    blk = (entries & 0xFFFF).long()
    live = torch.arange(entries.shape[-1], device=entries.device) < counts[..., None]
    rows = []
    for r in range(QGROUP):
        sel = live & (((entries >> (16 + r)) & 1) == 1)
        hit = torch.zeros((*entries.shape[:-1], n_kt), dtype=torch.int32, device=q.device)
        rows.append(hit.scatter_add_(-1, blk, sel.to(torch.int32)) > 0)
    mask = torch.stack(rows, dim=-2).reshape(b, h, -1, n_kt)[:, :, :n_qt]
    return block_masked_attention(q, k, v, mask, scale=scale, block_k=KV_BLOCK, bias=bias)


def _sparse_union_forward(q, k, v, mask, scale, bias, bound):
    """The ``SPARSE_UNION`` forward: union lists, then the kernel (or its
    plain version for CPU tensors)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    n_qt, n_kt = mask.shape[-2:]
    entries, counts = _union_lists(mask.reshape(b * h, n_qt, n_kt), bound)
    if not q.is_cuda:
        return _union_reference(q, k, v, entries.reshape(b, h, *entries.shape[1:]),
                                counts.reshape(b, h, -1), scale, bias)
    check_inputs("block_sparse_attention", q, k, v, dtype=torch.bfloat16)
    if d not in (64, 128):
        raise ValueError(f"block_sparse_attention: the union kernel takes d in "
                         f"(64, 128), got {d}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _union_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), entries.data_ptr(),
                  counts.data_ptr(), out.data_ptr(), lse.data_ptr(), b * h, lq, lk, d,
                  counts.shape[-1], entries.shape[-1], float(scale), float(bias),
                  cuda_stream(q.device))
    return out, lse


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (copied only when it is not):
    autograd may hand over a cotangent that is a view at any offset."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _delta_reference(out, g_out):
    """Plain ``delta = rowsum(dO * O)`` in f32 (JAX's expression in
    ``_bwd_call``)."""
    return (g_out.float() * out.float()).sum(dim=-1)


def attention_delta(out, g_out):
    """``delta = rowsum(g_out * out)`` in f32, ``[..., L, d] -> [..., L]``:
    the row statistic every flash-attention backward takes.  CUDA tensors
    (bf16, d in (64, 128)) launch ``bt_attn_delta``; CPU tensors take the
    plain version."""
    if not out.is_cuda:
        return _delta_reference(out, g_out)
    if out.shape != g_out.shape:
        raise ValueError(f"attention_delta: out {tuple(out.shape)} and g_out "
                         f"{tuple(g_out.shape)} differ")
    d = out.shape[-1]
    if d not in (64, 128):
        raise ValueError(f"attention_delta: the kernel takes d in (64, 128), got {d}")
    out, g_out = _aligned(out), _aligned(g_out)
    check_inputs("attention_delta", out, g_out, dtype=torch.bfloat16)
    delta = torch.empty(out.shape[:-1], dtype=torch.float32, device=out.device)
    _delta_kernel(out.data_ptr(), g_out.data_ptr(), delta.data_ptr(), delta.numel(), d,
                  cuda_stream(out.device))
    return delta


def backward_lists(mask):
    """The sparse backward's lists of a block mask ``[BH, n_qt, n_kt]``:
    ``(idx, cnt)`` of the mask (each query block's key blocks, for dQ) and
    ``(t_idx, t_cnt)`` of its transpose (each key block's query blocks, for
    dK/dV), int32, contiguous; ``masks.mask_to_block_lists`` of each, as
    JAX's ``_bwd_call`` takes them."""
    idx, cnt = mask_to_block_lists(mask)
    t_idx, t_cnt = mask_to_block_lists(mask.transpose(-1, -2))
    return tuple(t.contiguous() for t in (idx, cnt, t_idx, t_cnt))


def _backward_cuda(q, k, v, out, lse, g_out, g_lse, mask, scale, bias,
                   parts=("dq", "dkv"), delta=None, lists=None):
    """The backward kernels: ``delta = rowsum(dO * O)`` (``attention_delta``)
    unless the caller passes it, then dQ and dK/dV, each in its own kernel;
    a mask's ``backward_lists`` unless the caller passes them.  ``parts``
    picks which of the two kernels run (to time one alone); the gradients of
    a kernel left out come back ``None``."""
    g_out = g_out.to(q.dtype).contiguous()
    g_lse = g_lse.float().contiguous()
    check_inputs("attention backward", q, k, v, out, g_out, dtype=torch.bfloat16)
    if delta is None:
        delta = attention_delta(out, g_out)
    check_inputs("attention backward", lse, delta, g_lse, dtype=torch.float32)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d not in (64, 128) or v.shape[-1] != d:
        raise ValueError(f"attention backward: the kernels take d = dv in (64, 128) "
                         f"(d={d}, dv={v.shape[-1]})")
    dq = torch.empty_like(q) if "dq" in parts else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if "dkv" in parts else (None, None)
    stats = (lse.data_ptr(), delta.data_ptr(), g_lse.data_ptr())
    stream = cuda_stream(q.device)
    if mask is None:
        if dq is not None:
            _dense_dq_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
                             *stats, dq.data_ptr(), b * h, lq, lk, d, float(scale),
                             float(bias), stream)
        if dk is not None:
            _dense_dkv_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
                              *stats, dk.data_ptr(), dv.data_ptr(), b * h, lq, lk, d,
                              float(scale), float(bias), stream)
        return dq, dk, dv
    n_qt, n_kt = mask.shape[-2:]
    if lists is None:
        lists = backward_lists(mask.reshape(b * h, n_qt, n_kt))
    idx, cnt, t_idx, t_cnt = lists
    if dq is not None:
        _sparse_dq_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(), *stats,
                          idx.data_ptr(), cnt.data_ptr(), dq.data_ptr(), b * h, lq, lk, d,
                          n_qt, idx.shape[-1], float(scale), float(bias), stream)
    if dk is not None:
        _sparse_dkv_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
                           *stats, t_idx.data_ptr(), t_cnt.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), b * h, lq, lk, d, n_kt, t_idx.shape[-1],
                           float(scale), float(bias), stream)
    return dq, dk, dv


def attention_backward(q, k, v, out, lse, g_out, g_lse, mask, *, scale, bias=0.0,
                       delta=None):
    """``(dq, dk, dv)`` of dense (``mask=None``) or 128 x 128 block-sparse
    attention from its saved ``(out, lse)``: the backward kernels on the
    card, the plain backward for CPU tensors."""
    if q.is_cuda:
        return _backward_cuda(q, k, v, out, lse, g_out, g_lse, mask, scale, bias, delta=delta)
    return attention_backward_reference(q, k, v, out, lse, g_out, g_lse, block_mask=mask,
                                        block_k=KV_BLOCK, scale=scale, bias=bias, delta=delta)


class _Attention(torch.autograd.Function):
    """``(out, lse)`` of dense (``mask=None``) or block-sparse attention,
    differentiable in ``q, k, v`` through both outputs."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, bias, union_bound):
        if mask is not None and SPARSE_UNION:
            out, lse = _sparse_union_forward(q, k, v, mask, scale, bias, union_bound)
        elif q.is_cuda:
            out, lse = (_dense_cuda(q, k, v, scale, bias) if mask is None
                        else _sparse_cuda(q, k, v, mask, scale, bias))
        elif mask is None:
            out, lse = dense_attention_with_lse(q, k, v, scale=scale, bias=bias)
        else:
            out, lse = block_masked_attention(q, k, v, mask, scale=scale,
                                              block_k=KV_BLOCK, bias=bias)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.scale, ctx.bias = scale, bias
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, mask = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, lse, g_out, g_lse, mask,
                                        scale=ctx.scale, bias=ctx.bias)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    bias: float = 0.0,
):
    """Dense flash attention with LSE: ``(out [B,H,Lq,D], lse [B,H,Lq])``,
    differentiable in ``q, k, v``."""
    _check_qkv(q, k, v, same_dv=True)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Attention.apply(q, k, v, None, float(scale), float(bias), None)


def flash_attention_wide_v(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    bias: float = 0.0,
):
    """Dense flash whose V width ``Dv`` (a multiple of 128) is independent of
    Q/K's: the sum predictor's one-hot block-pooling V.  Returns
    ``(out [B,H,Lq,Dv], lse [B,H,Lq])``.  Forward-only (the predictor runs
    without gradient)."""
    _check_qkv(q, k, v, same_dv=False)
    if v.shape[3] % 128:
        raise ValueError(f"flash_attention_wide_v: Dv={v.shape[3]} must be a "
                         "multiple of 128")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_wide_v is forward-only: call it "
                           "under torch.no_grad()")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return dense_attention_with_lse(q, k, v, scale=scale, bias=bias)
    return _dense_cuda(q, k, v, scale, bias)


def block_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    bias: float = 0.0,
    union_bound: Optional[int] = None,
):
    """Block-sparse flash attention with LSE over 128x128 blocks,
    differentiable in ``q, k, v``.

    ``block_mask``: bool ``[B, H, ceil(Lq/128), ceil(Lk/128)]``; ``None``
    means dense.  ``union_bound`` (read only with ``SPARSE_UNION`` set): a
    static bound on every union row's selection except fully-on rows (see
    ``masks.union_block_lists``).  Returns ``(out [B,H,Lq,D], lse [B,H,Lq])``.
    """
    if block_mask is None:
        return flash_attention(q, k, v, scale=scale, bias=bias)
    _check_qkv(q, k, v, same_dv=True)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    n_qt, n_kt = -(-lq // 128), -(-lk // KV_BLOCK)
    if tuple(block_mask.shape) != (b, h, n_qt, n_kt):
        raise ValueError(f"block_mask {tuple(block_mask.shape)} must be "
                         f"{(b, h, n_qt, n_kt)}")
    if block_mask.device != q.device:
        raise ValueError(f"block_mask is on {block_mask.device}, q on {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _Attention.apply(q, k, v, block_mask, float(scale), float(bias), union_bound)
