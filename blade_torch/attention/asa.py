"""ASA: Adaptive block-Sparse Attention, energy lane.

Counterpart of ``blade/attention/asa.py``:

  1. Gilbert-rearrange tokens so spatio-temporal neighbours share 128-blocks
     (hoisted to the model when ``pre_arranged``).
  2. Predict a per-(batch, head) boolean block mask from a subsampled
     estimate of each key block's softmax mass (the "sum" predictor: flash
     attention with a one-hot block-pooling V), then the energy mask.
  3. Branch A: block-sparse flash attention over the mask.
     Branch B: dense flash attention against ``sample_gap``-mean-pooled K/V
     with a ``+log(sample_gap)`` score bias.
  4. Exact LSE merge of the two branches, then restore the token order.

Randomness (the predictor's token subsampling) comes from an explicit
``torch.Generator``; the offsets can also be injected.  The multilevel lane
and the "max" predictor are later slices of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from blade_torch.attention import gilbert
from blade_torch.attention import masks as M
from blade_torch.kernels.block_sparse_attn import (
    block_sparse_attention,
    flash_attention,
    flash_attention_wide_v,
)
from blade_torch.kernels.ref_attention import merge_attention

__all__ = ["ASAConfig", "predict_block_scores", "compute_mask",
           "adaptive_sparse_attention", "asa_attention", "BLOCK"]

BLOCK = 128  # token block of the masks: the sparse kernel's 128 x 128 tiles
ENERGY_THRESHOLD = 0.95


@dataclasses.dataclass(frozen=True)
class ASAConfig:
    """Geometry + sparsity hyperparameters of the energy lane (video-only
    tokens, as in Wan; the JAX config's multilevel and "max"-predictor
    fields belong to lanes not ported yet)."""

    latent_width: int
    latent_height: int
    latent_frames: int
    sample_tokens_per_block: int = 16
    min_retain_ratio: float = 0.05
    max_retain_ratio: float = 0.1
    sample_gap: int = 15
    # Tokens arrive already gilbert-arranged (the model permuted once after
    # patchify) -- skip the per-call permutes.
    pre_arranged: bool = False

    def permutations(self):
        return gilbert.gilbert_permutations(
            self.latent_width, self.latent_height, self.latent_frames)


@torch.no_grad()
def predict_block_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    cfg: ASAConfig,
    *,
    generator: Optional[torch.Generator] = None,
    offsets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Pooled block-score estimate ``[B, H, n_q, n_k]`` (f32, no gradient).

    Subsamples ``sample_tokens_per_block`` tokens per 128-block of Q and K
    (one offset set per (B, H) for Q, then one for K, drawn from
    ``generator`` in that order, or injected as ``offsets = (q_offs,
    k_offs)``) and pools each sampled query's softmax mass per key block.
    """
    qp = M.pad_to_block_multiple(q, BLOCK)
    kp = M.pad_to_block_multiple(k, BLOCK)
    tokens = cfg.sample_tokens_per_block
    q_offs, k_offs = offsets if offsets is not None else (None, None)
    q_s = M.sample_block_tokens(qp, BLOCK, tokens, generator=generator, offsets=q_offs)
    k_s = M.sample_block_tokens(kp, BLOCK, tokens, generator=generator, offsets=k_offs)
    scale = 1.0 / math.sqrt(q.shape[-1])
    # Row-softmax mass pooled per key block = flash attention with a one-hot
    # block-pooling V, lane-padded to a 128 multiple so one pass covers all
    # key blocks.
    b, h, ls, _ = k_s.shape
    nq = qp.shape[2] // BLOCK
    nk = kp.shape[2] // BLOCK
    nk_pad = max(128, -(-nk // 128) * 128)
    block_of = torch.arange(ls, device=k.device) // tokens
    pool = torch.nn.functional.one_hot(block_of, nk_pad).to(k_s.dtype)
    pool = pool.expand(b, h, ls, nk_pad).contiguous()
    out, _ = flash_attention_wide_v(q_s.contiguous(), k_s.contiguous(), pool,
                                    scale=scale)
    out = out[..., :nk]
    return out.reshape(b, h, nq, tokens, nk).mean(dim=3).float()


def compute_mask(q, k, cfg: ASAConfig, *, generator=None, offsets=None):
    """The boolean energy mask for (q, k), from the pooled score estimate."""
    scores = predict_block_scores(q, k, cfg, generator=generator, offsets=offsets)
    return M.energy_mask(
        scores,
        min_retain_ratio=cfg.min_retain_ratio,
        max_retain_ratio=cfg.max_retain_ratio,
        energy_threshold=ENERGY_THRESHOLD,
    )


def adaptive_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: ASAConfig,
    *,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
    offsets=None,
):
    """Energy-lane ASA over already-arranged ``[B, H, L, D]``.

    ``mask``: optional precomputed mask (cross-step reuse skips the
    predictor).  Returns ``(out, sparsity)`` where sparsity is
    ``1 - mask.mean() - 1/sample_gap``.
    """
    if mask is None:
        mask = compute_mask(q, k, cfg, generator=generator, offsets=offsets)
    out1, lse1 = block_sparse_attention(q, k, v, mask)

    # Low-res global branch: sample_gap-mean-pooled K/V with a +log(gap)
    # bias (each pooled key stands in for `gap` keys).
    gap = cfg.sample_gap
    kp = M.pad_to_block_multiple(k, gap)
    vp = M.pad_to_block_multiple(v, gap)
    k_pool = (kp.reshape(*kp.shape[:2], -1, gap, kp.shape[-1]).float().sum(dim=-2)
              * (1.0 / gap)).to(k.dtype)
    v_pool = (vp.reshape(*vp.shape[:2], -1, gap, vp.shape[-1]).float().sum(dim=-2)
              * (1.0 / gap)).to(v.dtype)
    out2, lse2 = flash_attention(q, k_pool, v_pool, scale=1.0 / math.sqrt(q.shape[-1]),
                                 bias=float(math.log(gap)))

    out, _ = merge_attention([out1, out2], [lse1, lse2])
    sparsity = 1.0 - M.mask_density(mask) - 1.0 / gap
    return out.to(q.dtype), sparsity


def asa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: ASAConfig,
    *,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
    return_mask: bool = False,
    offsets=None,
):
    """Full ASA: gilbert rearrange -> adaptive sparse attention -> restore.

    ``q, k, v``: ``[B, H, video_tokens, D]``.  ``mask``/``return_mask``
    support cross-step mask reuse (masks live in arranged-token
    coordinates).  Returns ``(out, sparsity[, mask])``.
    """
    rearrange = not cfg.pre_arranged
    if rearrange:
        perm, inv = cfg.permutations()
        q = gilbert.rearrange_tokens(q, perm)
        k = gilbert.rearrange_tokens(k, perm)
        v = gilbert.rearrange_tokens(v, perm)
    if mask is None:
        mask = compute_mask(q, k, cfg, generator=generator, offsets=offsets)
    out, sparsity = adaptive_sparse_attention(q, k, v, cfg, mask=mask)
    if rearrange:
        out = gilbert.unrearrange_tokens(out, inv)
    if return_mask:
        return out, sparsity, mask
    return out, sparsity
