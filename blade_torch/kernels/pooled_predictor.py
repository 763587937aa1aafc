"""The "max" mask predictor's pooled score estimate.

Counterpart of ``blade/kernels/pooled_predictor.py::pooled_scores_kernel_call``:
``Po[bh, i, j] = max over (m in q-block i, n in k-block j) of
softmax_row(q_s k_s^T * scale)[m, n]`` over the subsampled sequences, each
row then renormalised to sum to 1 -- the reference's renormalised col-max
pooling.  On the card it launches ``csrc/pooled_predictor.cu`` (bf16 in,
f32 scores and statistics, ``Po`` f32 out; one pass over ``k_s`` that
writes each sampled row's raw k-block maxima to a scratch the wrapper
allocates); CPU tensors take the plain version
``masks.pooled_scores_plain`` (f32 on the values given).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from blade_torch.attention.masks import pooled_scores_plain
from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream

__all__ = ["pooled_scores"]

_pooled_kernel = CudaKernel(
    "pooled_predictor", "bt_pooled_scores", "ppppiiiiifp",
    source="blade_torch/csrc/pooled_predictor.cu",
    replaces="blade/kernels/pooled_predictor.py:45",  # _kernel
)


def _pooled_scores_cuda(q_s, k_s, tpb, scale):
    check_inputs("pooled_scores", q_s, k_s, dtype=torch.bfloat16)
    b, h, ls, d = q_s.shape
    lks = k_s.shape[2]
    if d not in (64, 128) or tpb not in (16, 32):
        raise ValueError(f"pooled_scores: the kernel takes d in (64, 128) and "
                         f"tokens_per_block in (16, 32) (d={d}, tpb={tpb})")
    po = torch.empty((b, h, ls // tpb, lks // tpb), dtype=torch.float32, device=q_s.device)
    raw = torch.empty((b * h, ls, lks // tpb), dtype=torch.float32, device=q_s.device)
    _pooled_kernel(q_s.data_ptr(), k_s.data_ptr(), raw.data_ptr(), po.data_ptr(), b * h, ls,
                   lks, d, tpb, float(scale), cuda_stream(q_s.device))
    return po


def pooled_scores(
    q_s: torch.Tensor,
    k_s: torch.Tensor,
    tokens_per_block: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``q_s [B, H, Ls, d]``, ``k_s [B, H, Lks, d]`` (bf16 on the card; every
    ``tokens_per_block`` rows are one block's samples) -> ``Po [B, H,
    Ls // tpb, Lks // tpb]`` f32, rows summing to 1."""
    if q_s.dim() != 4 or k_s.dim() != 4 or q_s.shape[:2] != k_s.shape[:2] \
            or q_s.shape[3] != k_s.shape[3]:
        raise ValueError(f"pooled_scores: q_s {tuple(q_s.shape)} and k_s "
                         f"{tuple(k_s.shape)} must be [B, H, L, d] alike")
    tpb = tokens_per_block
    if q_s.shape[2] % tpb or k_s.shape[2] % tpb or k_s.shape[2] == 0:
        raise ValueError(f"pooled_scores: lengths {q_s.shape[2]}, {k_s.shape[2]} must be "
                         f"non-zero multiples of tokens_per_block {tpb}")
    if scale is None:
        scale = 1.0 / math.sqrt(q_s.shape[-1])
    if not q_s.is_cuda:
        return pooled_scores_plain(q_s, k_s, tpb, scale)
    return _pooled_scores_cuda(q_s, k_s, tpb, scale)
