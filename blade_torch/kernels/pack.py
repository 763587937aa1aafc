"""K/V record packing for the block-sparse gather (``pyramid=False`` lane).

Counterpart of ``blade/kernels/pack.py::pack_kv``.  Record ``b`` of each
head holds key block ``b``'s 128 K rows followed by its 128 V rows, so the
sparse kernel reads one contiguous record per listed block.  The CUDA kernel
is ``csrc/pack.cu``; CPU tensors take the plain version.
"""

from __future__ import annotations

import torch

from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream

__all__ = ["pack_kv", "KV_BLOCK"]

KV_BLOCK = 128

_pack_kernel = CudaKernel(
    "pack_kv", "bt_pack_kv", "pppiiip",
    source="blade_torch/csrc/pack.cu",
    replaces="blade/kernels/pack.py:32",  # _pack_kernel, pyramid=False
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
