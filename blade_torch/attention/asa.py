"""ASA: Adaptive block-Sparse Attention, energy and multilevel lanes.

Counterpart of ``blade/attention/asa.py``:

  1. Gilbert-rearrange tokens so spatio-temporal neighbours share 128-blocks
     (hoisted to the model when ``pre_arranged``; text tokens stay behind
     the video).
  2. Predict per-(batch, head) block scores from Q and K subsampled per
     block: the "sum" predictor (each key block's softmax mass: flash
     attention with a one-hot block-pooling V) or the reference's "max"
     predictor (renormalised max of the softmax per query and key block:
     ``kernels/pooled_predictor.py``).
  3. Energy lane (training, Wan serving): the energy mask; branch A is
     block-sparse flash attention over it, branch B dense flash attention
     against ``sample_gap``-mean-pooled K/V with a ``+log(sample_gap)``
     bias, merged exactly by LSE.
     Multilevel lane (CogVideoX serving, ``--mask_mode multilevel``): the
     scores rank each row's key blocks into levels {1, 2, 4, 8, 0} by
     percentile bands.  Where the fused lane covers the geometry
     (``fused_supported``) the scores are mean-pooled to
     ``multilevel_q_rows`` query rows and the per-level lists drive the
     fused multi-level kernel; elsewhere (e.g. Wan2.1-14B 720p) the int
     level mask at 128-row granularity is the mask artifact: on the card
     its lists, built inside each call, drive the same kernel in one carry;
     on the CPU it drives the per-level lane.  Both lanes are
     differentiable in q, k, v; the predictor runs without gradient (JAX's
     ``stop_gradient``).
  4. Restore the token order.

Randomness (the predictor's token subsampling) comes from an explicit
``torch.Generator``; the offsets can also be injected.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from blade_torch.attention import gilbert
from blade_torch.attention import masks as M
from blade_torch.kernels.block_sparse_attn import (
    block_sparse_attention,
    flash_attention,
    flash_attention_wide_v,
)
from blade_torch.kernels.multilevel_attn import fused_supported, multilevel_attention
from blade_torch.kernels.pooled_predictor import pooled_scores
from blade_torch.kernels.ref_attention import merge_attention
from blade_torch.utils import tracing

__all__ = ["ASAConfig", "predict_block_scores", "compute_mask", "compute_lists",
           "adaptive_sparse_attention", "asa_attention", "BLOCK"]

BLOCK = 128  # token block of the masks: the sparse kernel's 128 x 128 tiles


@dataclasses.dataclass(frozen=True)
class ASAConfig:
    """Geometry + sparsity hyperparameters of one model family.  The
    predictor defaults are the serving presets' ("sum", 16 tokens a block);
    JAX's dataclass defaults are the reference's ("max", 32)."""

    latent_width: int
    latent_height: int
    latent_frames: int
    # Text tokens behind the video in the attention sequence (CogVideoX's
    # joint attention); 0 for Wan.
    text_length: int = 0
    # Gilbert-rearrange tokens around the attention (off: masks are taken
    # in the given token order).
    use_rearrange: bool = True
    # Token block of the masks; the port's kernels and masks are built on
    # 128-token blocks (BLOCK), so no other value is taken.
    block_size: int = BLOCK
    sample_tokens_per_block: int = 16
    min_retain_ratio: float = 0.05
    max_retain_ratio: float = 0.1
    # Share of each row's predicted mass the energy mask keeps.
    energy_threshold: float = 0.95
    sample_gap: int = 15
    mask_mode: str = "energy"  # "energy" | "multilevel"
    mask_ratios: Optional[Dict[int, Tuple[float, float]]] = None
    # Tokens arrive already gilbert-arranged (the model permuted once after
    # patchify) -- skip the per-call permutes.
    pre_arranged: bool = False
    # Query rows per multilevel mask row (128 or 256).
    multilevel_q_rows: int = 128
    # "sum": each key block's softmax mass (matmul-reducible, rows sum to 1
    # by construction); "max": the reference's renormalised max pooling.
    predictor: str = "sum"

    def __post_init__(self):
        if self.block_size != BLOCK:
            raise ValueError(f"ASAConfig.block_size={self.block_size}: the port's masks and "
                             f"kernels are built on {BLOCK}-token blocks only")

    @property
    def video_tokens(self) -> int:
        return self.latent_width * self.latent_height * self.latent_frames

    @property
    def seq_len(self) -> int:
        return self.video_tokens + self.text_length

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
    k_offs)``) and pools the sampled softmax per (query block, key block):
    the mean of each key block's mass (``predictor="sum"``) or the
    renormalised max (``"max"``).
    """
    if cfg.predictor not in ("sum", "max"):
        raise ValueError(f"unknown ASA predictor {cfg.predictor!r}: 'sum' or 'max'")
    qp = M.pad_to_block_multiple(q, BLOCK)
    kp = M.pad_to_block_multiple(k, BLOCK)
    tokens = cfg.sample_tokens_per_block
    q_offs, k_offs = offsets if offsets is not None else (None, None)
    q_s = M.sample_block_tokens(qp, BLOCK, tokens, generator=generator, offsets=q_offs)
    k_s = M.sample_block_tokens(kp, BLOCK, tokens, generator=generator, offsets=k_offs)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if cfg.predictor == "max":
        return pooled_scores(q_s.contiguous(), k_s.contiguous(), tokens, scale)
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


def _coarsen_scores(scores: torch.Tensor, cfg: ASAConfig) -> torch.Tensor:
    """Mean-pool score rows to ``multilevel_q_rows`` granularity (the last
    row edge-padded when the row count does not divide)."""
    g = cfg.multilevel_q_rows // BLOCK
    if g == 1:
        return scores
    nq = scores.shape[-2]
    if nq % g:
        last = scores[..., -1:, :]
        scores = torch.cat([scores, last.expand(*scores.shape[:-2], g - nq % g,
                                                scores.shape[-1])], dim=-2)
    return scores.reshape(*scores.shape[:-2], -1, g, scores.shape[-1]).mean(dim=-2)


def _fused_lane_supported(cfg: ASAConfig, q, k) -> bool:
    return cfg.mask_mode == "multilevel" and fused_supported(
        q.shape[-1], k.shape[2], q.element_size())


def compute_lists(q, k, cfg: ASAConfig, *, generator=None, offsets=None):
    """Per-level block lists for the multilevel lane, the mask artifact on
    that lane: ``(idx [B, H, n_q, 4, cap], counts [B, H, n_q, 4])`` with
    ``cap = ceil(n_k / 128) * 128``."""
    with tracing.span("asa.predict"):
        scores = predict_block_scores(q, k, cfg, generator=generator, offsets=offsets)
    with tracing.span("asa.select"):
        n_kt = -(-k.shape[2] // BLOCK)
        return M.multilevel_lists(_coarsen_scores(scores, cfg), cfg.mask_ratios,
                                  cap=-(-n_kt // 128) * 128)


def compute_mask(q, k, cfg: ASAConfig, *, generator=None, offsets=None):
    """The data-dependent mask for (q, k) from the pooled score estimate:
    the boolean energy mask, or on the multilevel lane the int level mask
    (at ``multilevel_q_rows`` granularity when the fused lane supports the
    geometry, as in JAX)."""
    with tracing.span("asa.predict"):
        scores = predict_block_scores(q, k, cfg, generator=generator, offsets=offsets)
    with tracing.span("asa.select"):
        if cfg.mask_mode == "multilevel":
            if _fused_lane_supported(cfg, q, k):
                scores = _coarsen_scores(scores, cfg)
            return M.multilevel_mask(scores, cfg.mask_ratios)
        return M.energy_mask(
            scores,
            min_retain_ratio=cfg.min_retain_ratio,
            max_retain_ratio=cfg.max_retain_ratio,
            energy_threshold=cfg.energy_threshold,
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
    """ASA over already-arranged ``[B, H, L, D]``.

    ``mask``: optional precomputed mask artifact (cross-step reuse skips the
    predictor): the energy mask, or on the multilevel lane an ``(idx,
    counts)`` lists tuple (fused lane) or an int level mask.  Returns ``(out,
    sparsity)``: ``1 - mask.mean() - 1/sample_gap`` on the energy lane,
    ``1 - sum over levels of band / L`` on the multilevel lane.
    """
    if cfg.mask_mode == "multilevel":
        return _multilevel_lane(q, k, v, cfg, mask, generator, offsets)
    if mask is None:
        mask = compute_mask(q, k, cfg, generator=generator, offsets=offsets)
    # The energy clamp bounds every row's selection at int(n_k * max_retain)
    # blocks plus the two forced columns, a union of two rows at twice that;
    # only the forced fully-on last two rows exceed it, which is what the
    # bounded lane of the union lists (SPARSE_UNION) asks of its bound.
    n_k = mask.shape[-1]
    union_bound = 2 * (max(int(n_k * cfg.max_retain_ratio), 1) + 2)
    with tracing.span("asa.sparse"):
        out1, lse1 = block_sparse_attention(
            q, k, v, mask, union_bound=union_bound if union_bound < n_k else None)

    # Low-res global branch: sample_gap-mean-pooled K/V with a +log(gap)
    # bias (each pooled key stands in for `gap` keys).
    gap = cfg.sample_gap
    with tracing.span("asa.pooled"):
        kp = M.pad_to_block_multiple(k, gap)
        vp = M.pad_to_block_multiple(v, gap)
        k_pool = (kp.reshape(*kp.shape[:2], -1, gap, kp.shape[-1]).float().sum(dim=-2)
                  * (1.0 / gap)).to(k.dtype)
        v_pool = (vp.reshape(*vp.shape[:2], -1, gap, vp.shape[-1]).float().sum(dim=-2)
                  * (1.0 / gap)).to(v.dtype)
        out2, lse2 = flash_attention(q, k_pool, v_pool, scale=1.0 / math.sqrt(q.shape[-1]),
                                     bias=float(math.log(gap)))

    with tracing.span("asa.merge"):
        out, _ = merge_attention([out1, out2], [lse1, lse2])
        out = out.to(q.dtype)
    density = M.mask_density(mask)
    _count_blocks(lambda: density * mask.numel(), mask.numel())
    return out, 1.0 - density - 1.0 / gap


def _multilevel_lane(q, k, v, cfg, mask, generator, offsets):
    # An (idx, counts) tuple drives the fused lane; an int level mask carries
    # its row granularity in its shape (JAX asa.py:264-271).
    if mask is None:
        mask = (compute_lists if _fused_lane_supported(cfg, q, k) else compute_mask)(
            q, k, cfg, generator=generator, offsets=offsets)
    with tracing.span("asa.sparse"):
        if isinstance(mask, (tuple, list)):
            out, _ = multilevel_attention(q, k, v, lists=tuple(mask),
                                          q_rows=cfg.multilevel_q_rows)
            counts = mask[1]
            _count_blocks(lambda: counts[..., 0].sum(),
                          counts.shape[:-1].numel() * -(-k.shape[2] // BLOCK))
        else:
            n128 = -(-q.shape[2] // BLOCK)
            q_rows = BLOCK * -(-n128 // mask.shape[-2])
            out, _ = multilevel_attention(q, k, v, mask, q_rows=q_rows)
            _count_blocks(lambda: (mask == 1).sum(), mask.numel())
    ratios = cfg.mask_ratios or M.DEFAULT_MASK_RATIOS
    density = sum((hi - lo) / lv for lv, (lo, hi) in ratios.items() if lv != 0)
    return out, 1.0 - density


def _count_blocks(selected, total: int) -> None:
    """Counts one ASA call: its level-1 (full-resolution) key blocks
    selected (``selected()``, a device value) out of ``total``; a block
    recomputed in a backward counts as ``asa.recomputed_calls`` alone."""
    if not tracing.active():
        return
    if tracing.recomputing():
        tracing.count("asa.recomputed_calls")
        return
    tracing.count("asa.calls")
    tracing.count("asa.blocks_selected", selected())
    tracing.count("asa.blocks_total", total)


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

    ``q, k, v``: ``[B, H, text_length + video_tokens, D]`` with the text
    segment first (``text_length == 0`` for Wan).  ``mask``/``return_mask``
    support cross-step mask reuse (masks live in arranged-token
    coordinates; on the fused multilevel lane the artifact is the ``(idx,
    counts)`` lists tuple, on the per-level lane the int level mask).
    Returns ``(out, sparsity[, mask])``.
    """
    rearrange = cfg.use_rearrange and not cfg.pre_arranged
    if rearrange:
        perm, inv = cfg.permutations()
        q = gilbert.rearrange_tokens(q, perm, cfg.text_length)
        k = gilbert.rearrange_tokens(k, perm, cfg.text_length)
        v = gilbert.rearrange_tokens(v, perm, cfg.text_length)
    if mask is None:
        mask = (compute_lists if _fused_lane_supported(cfg, q, k) else compute_mask)(
            q, k, cfg, generator=generator, offsets=offsets)
    out, sparsity = adaptive_sparse_attention(q, k, v, cfg, mask=mask)
    if rearrange:
        out = gilbert.unrearrange_tokens(out, inv, cfg.text_length)
    if return_mask:
        return out, sparsity, mask
    return out, sparsity
