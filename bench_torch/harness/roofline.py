"""The yardstick's arithmetic: peaks, bounds and the work of attention.

Copied from the port's ``chip_smoke.py`` (``_bound``, ``_dense_work``,
``_block_pairs``) into the benchmark, so that a later change to the program
cannot change what its kernels are held to.  The peaks are NVIDIA's data
sheet for the H100 SXM (dense rates, no sparsity): 989 TFLOP/s in bf16 and
3.35 TB/s of HBM3.  A bound is ``max(operations / rate, bytes / bandwidth)``
with each input read once and each output written once.  The functions
that take masks return device tensors, so counting needs no host sync.
"""

from __future__ import annotations

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops, nbytes):
    """Least seconds for ``flops`` bf16 tensor-core operations and
    ``nbytes`` of device-memory traffic (numbers or tensors)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    if torch.is_tensor(t_ops) or torch.is_tensor(t_bytes):
        return torch.maximum(torch.as_tensor(t_ops, dtype=torch.float64),
                             torch.as_tensor(t_bytes, dtype=torch.float64))
    return max(t_ops, t_bytes)


def block_pairs(mask: torch.Tensor, lq: int, lk: int) -> torch.Tensor:
    """Query-key pairs a 128 x 128 block mask ``[..., n_q, n_k]`` selects,
    rows past ``lq`` and keys past ``lk`` left out (f64 device scalar)."""
    n_qt, n_kt = mask.shape[-2:]
    rows = (lq - 128 * torch.arange(n_qt, device=mask.device)).clamp(max=128)
    keys = (lk - 128 * torch.arange(n_kt, device=mask.device)).clamp(max=128)
    return (mask.double() * rows[:, None].double() * keys[None, :].double()).sum()


def attention_flops(pairs, head_dim: int, v_dim: int = None):
    """Operations of softmax attention over ``pairs`` query-key pairs:
    ``2 d`` for the score and ``2 dv`` for the weighted value."""
    return 2.0 * pairs * (head_dim + (head_dim if v_dim is None else v_dim))


def linear_flops(rows: int, n_in: int, n_out: int) -> float:
    """Operations of ``rows`` rows through an ``n_in -> n_out`` matrix."""
    return 2.0 * rows * n_in * n_out


def asa_energy_work(mask: torch.Tensor, lq: int, lk: int, head_dim: int,
                    sample_tokens: int, gap: int, elem_bytes: int = 2):
    """``(operations, least seconds)`` of one ASA call on the energy lane
    over ``mask [B, H, n_q, n_k]`` (device tensors).

    Operations are what the model computes: softmax attention over the
    pairs the mask selects, over every query and the ``ceil(lk / gap)``
    mean-pooled keys, and the predictor's scores between the
    ``sample_tokens`` sampled rows of each 128-block of Q and of K.  The
    bytes are the call's inputs and output, each once: Q, K, V read and the
    output written (bf16).
    """
    b, heads, n_q, n_k = mask.shape
    pooled = -(-lk // gap)
    flops = (attention_flops(block_pairs(mask, lq, lk), head_dim)
             + attention_flops(float(b * heads * lq * pooled), head_dim)
             + 2.0 * b * heads * (n_q * sample_tokens) * (n_k * sample_tokens) * head_dim)
    nbytes = float(elem_bytes * b * heads * head_dim * (2 * lq + 2 * lk))
    return flops, bound_s(flops, nbytes)


def asa_energy_backward_work(mask: torch.Tensor, lq: int, lk: int, head_dim: int, gap: int,
                             elem_bytes: int = 2):
    """``(operations, least seconds)`` of the backward of one energy-lane
    call: twice the forward's attention operations over the selected pairs
    and the pooled keys (dV and dP, then dQ and dK: four products to the
    forward's two; the predictor takes no gradient).  The bytes are Q, K,
    V, the output and its gradient read and dQ, dK, dV written, each once."""
    b, heads = mask.shape[:2]
    pooled = -(-lk // gap)
    flops = 2.0 * (attention_flops(block_pairs(mask, lq, lk), head_dim)
                   + attention_flops(float(b * heads * lq * pooled), head_dim))
    nbytes = float(elem_bytes * b * heads * head_dim * (4 * lq + 4 * lk))
    return flops, bound_s(flops, nbytes)


def level_pairs(idx: torch.Tensor, cnt: torch.Tensor, lq: int, lk: int, level: int,
                q_rows: int) -> torch.Tensor:
    """Query-key pairs one level's lists select (``idx [..., n_q, cap]``,
    ``cnt [..., n_q]``): a listed block holds ``128 / level`` pooled keys,
    those past ``ceil(lk / level)`` and rows past ``lq`` left out."""
    n_q, cap = idx.shape[-2], idx.shape[-1]
    rows = (lq - q_rows * torch.arange(n_q, device=idx.device)).clamp(max=q_rows)
    seg = 128 // level
    keys = (-(-lk // level) - seg * idx.long()).clamp(0, seg)
    live = torch.arange(cap, device=idx.device) < cnt[..., None]
    return ((keys * live).sum(-1).double() * rows.double()).sum()


def asa_multilevel_work(idx: torch.Tensor, cnt: torch.Tensor, lq: int, lk: int,
                        head_dim: int, q_rows: int, sample_tokens: int, elem_bytes: int = 2):
    """``(operations, least seconds)`` of one ASA call on the multilevel
    lane over its lists (``idx [B, H, n_q, 4, cap]``, ``cnt [B, H, n_q, 4]``
    for levels 1, 2, 4, 8): softmax attention over the full-resolution and
    pooled keys the lists select, and the predictor's scores; Q, K, V read
    and the output written once."""
    b, heads = idx.shape[:2]
    pairs = sum(level_pairs(idx[..., li, :], cnt[..., li], lq, lk, lv, q_rows)
                for li, lv in enumerate((1, 2, 4, 8)))
    n_qb, n_kb = -(-lq // 128), -(-lk // 128)
    flops = (attention_flops(pairs, head_dim)
             + 2.0 * b * heads * (n_qb * sample_tokens) * (n_kb * sample_tokens) * head_dim)
    nbytes = float(elem_bytes * b * heads * head_dim * (2 * lq + 2 * lk))
    return flops, bound_s(flops, nbytes)


def levels_to_lists(levels: torch.Tensor):
    """An int level mask ``[..., n_q, n_k]`` (the per-level lane's artifact)
    as per-level lists ``(idx [..., n_q, 4, n_k], cnt [..., n_q, 4])``."""
    idx, cnt = [], []
    for lv in (1, 2, 4, 8):
        sel = levels == lv
        idx.append(torch.argsort((~sel).to(torch.uint8), dim=-1, stable=True))
        cnt.append(sel.sum(-1))
    return torch.stack(idx, -2), torch.stack(cnt, -1)
