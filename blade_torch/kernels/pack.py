"""K/V record packing for the block-sparse gathers.

Counterpart of ``blade/kernels/pack.py::pack_kv``, both modes:

* :func:`pack_kv` (``pyramid=False``): record ``b`` of each head holds key
  block ``b``'s 128 K rows followed by its 128 V rows, so the sparse kernel
  reads one contiguous record per listed block; rows past ``Lk`` are zeros.
* :func:`pack_kv_pyramid` (``pyramid=True``): the same level-1 records of
  the EDGE-padded K/V plus the 2/4/8x mean-pooled records (block ``b`` at
  level L: its ``128/L`` pooled K rows, then its ``128/L`` pooled V rows),
  pooled in f32 and chained, rounded to K's dtype once a level.  Edge
  padding (the last token repeated) is what JAX pools, so the last pooled
  row of a ragged tail mixes real and repeated tokens as it does there.

The CUDA kernels are ``csrc/pack.cu``; CPU tensors take the plain versions.
"""

from __future__ import annotations

import torch

from blade_torch.attention.masks import pad_to_block_multiple
from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream
from blade_torch.kernels.ref_attention import pool_pyramid

__all__ = ["pack_kv", "pack_kv_pyramid", "KV_BLOCK"]

KV_BLOCK = 128

_pack_kernel = CudaKernel(
    "pack_kv", "bt_pack_kv", "pppiiip",
    source="blade_torch/csrc/pack.cu",
    replaces="blade/kernels/pack.py:32",  # _pack_kernel, pyramid=False
)
_pyramid_kernel = CudaKernel(
    "pack_kv_pyramid", "bt_pack_kv_pyramid", "ppppppiiip",
    source="blade_torch/csrc/pack.cu",
    replaces="blade/kernels/pack.py:32",  # _pack_kernel, pyramid=True
)


def _pack_kv_reference(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: zero-pad to whole blocks, then interleave per block."""
    bh, lk, d = k.shape
    n_kt = -(-lk // KV_BLOCK)
    pad = n_kt * KV_BLOCK - lk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    kv = torch.stack([k.reshape(bh, n_kt, KV_BLOCK, d),
                      v.reshape(bh, n_kt, KV_BLOCK, d)], dim=2)
    return kv.reshape(bh, 2 * n_kt * KV_BLOCK, d)


def pack_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``k, v [BH, Lk, D]`` -> records ``[BH, 2 * ceil(Lk/128) * 128, D]``.

    Rows past ``Lk`` in the last record are zeros.  (The TPU version also
    pads the block count to its 16-block grid chunk; that padding is a TPU
    tiling detail and is not kept.)
    """
    if k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"pack_kv: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "must both be [BH, Lk, D]")
    if not k.is_cuda:
        return _pack_kv_reference(k, v)
    check_inputs("pack_kv", k, v, dtype=torch.bfloat16)
    bh, lk, d = k.shape
    out = torch.empty((bh, 2 * (-(-lk // KV_BLOCK)) * KV_BLOCK, d),
                      dtype=k.dtype, device=k.device)
    _pack_kernel(k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, lk, d,
                 cuda_stream(k.device))
    return out


def _records(k: torch.Tensor, v: torch.Tensor, rows: int) -> torch.Tensor:
    """``[BH, n*rows, D]`` K and V -> ``[BH, 2*n*rows, D]`` records of
    ``rows`` K rows then ``rows`` V rows."""
    bh, n, d = k.shape[0], k.shape[1] // rows, k.shape[2]
    kv = torch.stack([k.reshape(bh, n, rows, d), v.reshape(bh, n, rows, d)], dim=2)
    return kv.reshape(bh, 2 * n * rows, d)


def _pack_kv_pyramid_reference(k: torch.Tensor, v: torch.Tensor):
    """Plain version: edge-pad to whole blocks, pool in f32 (chained), round
    once a level, interleave K and V rows per block."""
    kp, vp = pad_to_block_multiple(k, KV_BLOCK), pad_to_block_multiple(v, KV_BLOCK)
    out = [_records(kp, vp, KV_BLOCK)]
    for i, (pk, pv) in enumerate(zip(pool_pyramid(kp), pool_pyramid(vp))):
        out.append(_records(pk.to(k.dtype), pv.to(v.dtype), KV_BLOCK >> (i + 1)))
    return tuple(out)


def pack_kv_pyramid(k: torch.Tensor, v: torch.Tensor):
    """``k, v [BH, Lk, D]`` -> ``(kv1, kv2, kv4, kv8)``: ``kvL`` is
    ``[BH, 2 * ceil(Lk/128) * 128/L, D]``, the level-L records of the
    edge-padded K/V (level 1 unpooled)."""
    if k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"pack_kv_pyramid: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "must both be [BH, Lk, D]")
    if not k.is_cuda:
        return _pack_kv_pyramid_reference(k, v)
    check_inputs("pack_kv_pyramid", k, v, dtype=torch.bfloat16)
    bh, lk, d = k.shape
    n_kt = -(-lk // KV_BLOCK)
    outs = tuple(torch.empty((bh, 2 * n_kt * (KV_BLOCK >> i), d), dtype=k.dtype,
                             device=k.device) for i in range(4))
    _pyramid_kernel(k.data_ptr(), v.data_ptr(), *(o.data_ptr() for o in outs), bh, lk, d,
                    cuda_stream(k.device))
    return outs
