"""Flash attention, dense and block-sparse, forward only.

Counterpart of ``blade/kernels/block_sparse_attn.py``'s public forward API:
``flash_attention``, ``flash_attention_wide_v`` and
``block_sparse_attention``.  On the card each launches the kernels of
``csrc/flash_attn.cu`` (bf16 in, f32 accumulate, ``(out, lse)`` out); CPU
tensors take the plain versions in ``kernels/ref_attention.py``.

Shapes: ``[B, H, L, D]``; ``Lq`` and ``Lk`` may be ragged (no padding is
materialised: the kernels mask keys past ``Lk`` themselves).  The sparse
mask is bool ``[B, H, ceil(Lq/128), ceil(Lk/128)]``; a row with no selected
block gives out 0 and lse -1e30.  The backward kernels are not ported yet,
so CUDA inputs that require grad raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from blade_torch.attention.masks import mask_to_block_lists
from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream
from blade_torch.kernels.pack import KV_BLOCK, pack_kv
from blade_torch.kernels.ref_attention import (
    block_masked_attention,
    dense_attention_with_lse,
)

__all__ = ["flash_attention", "flash_attention_wide_v", "block_sparse_attention",
           "KV_BLOCK"]

_dense_kernel = CudaKernel(
    "dense_fwd", "bt_attn_dense_fwd", "pppppiiiiiffp",
    source="blade_torch/csrc/flash_attn.cu",
    replaces="blade/kernels/block_sparse_attn.py:88",  # _dense_fwd_kernel
)
_sparse_kernel = CudaKernel(
    "sparse_fwd", "bt_attn_sparse_fwd", "ppppppiiiiiiffp",
    source="blade_torch/csrc/flash_attn.cu",
    replaces="blade/kernels/block_sparse_attn.py:360",  # _sparse_fwd_rows_kernel
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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    bias: float = 0.0,
):
    """Dense flash attention with LSE: ``(out [B,H,Lq,D], lse [B,H,Lq])``."""
    _check_qkv(q, k, v, same_dv=True)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return dense_attention_with_lse(q, k, v, scale=scale, bias=bias)
    return _dense_cuda(q, k, v, scale, bias)


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
    ``(out [B,H,Lq,Dv], lse [B,H,Lq])``."""
    _check_qkv(q, k, v, same_dv=False)
    if v.shape[3] % 128:
        raise ValueError(f"flash_attention_wide_v: Dv={v.shape[3]} must be a "
                         "multiple of 128")
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
):
    """Block-sparse flash attention with LSE over 128x128 blocks.

    ``block_mask``: bool ``[B, H, ceil(Lq/128), ceil(Lk/128)]``; ``None``
    means dense.  Returns ``(out [B,H,Lq,D], lse [B,H,Lq])``.
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
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return block_masked_attention(q, k, v, block_mask, scale=scale,
                                      block_k=KV_BLOCK, bias=bias)
    check_inputs("block_sparse_attention", q, k, v, dtype=torch.bfloat16)
    if d not in (64, 128):
        raise ValueError(f"block_sparse_attention: the kernel takes d in "
                         f"(64, 128), got {d}")
    idx, cnt = mask_to_block_lists(block_mask.reshape(b * h, n_qt, n_kt))
    idx, cnt = idx.contiguous(), cnt.contiguous()
    kv = pack_kv(k.reshape(b * h, lk, d), v.reshape(b * h, lk, d))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _sparse_kernel(q.data_ptr(), kv.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                   out.data_ptr(), lse.data_ptr(), b * h, lq, lk, d, n_qt,
                   idx.shape[-1], float(scale), float(bias),
                   cuda_stream(q.device))
    return out, lse
