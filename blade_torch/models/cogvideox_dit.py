"""CogVideoX diffusion transformer (PyTorch).

Counterpart of ``blade/models/cogvideox_dit.py`` with the diffusers
``CogVideoXTransformer3DModel`` state-dict layout (CogVideoX-5B: 42 blocks,
dim 3072, 48 heads x 64): per-frame 2x2 patchify, joint text + video
self-attention with per-head q/k LayerNorm and 3-D RoPE on the video
segment only, LayerNormZero AdaLN (shift/scale/gate for video and text),
GELU(tanh) FFN over the joint sequence, AdaLN head.  Latents are
``[B, T, C, H, W]``; the output is the v-prediction (f32).

Numerics follow the JAX model: projections in ``dtype`` (bf16 on the card),
their weights stored in it (``layers.Linear``); LayerNorms, modulation,
gates, the time embedding and ``proj_out`` in f32 with f32 parameters; the
residual streams in ``dtype``.  The q/k
``deinterleave_perm`` is folded into ``to_q``/``to_k`` and ``norm_q``/
``norm_k`` once at load time, so RoPE runs in the rotate-half form.  The
q/k LayerNorm, video RoPE and head split run as one kernel
(``kernels/qk_norm_rope.py``), v's head split as ``heads_pack``.

The dense model (``token_perm=None``) attends over ``[text, video]``; with
``token_perm`` (ASA) the video tokens are gilbert-permuted once after
patchify and the joint sequence is ``[video, text]`` (``text_last``), so ASA
sees 128-block-aligned video first; the head output is un-permuted once.
``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, the counterpart of flax ``nn.remat``); ASA's
per-layer draws come from generators folded from a seed and the layer
index, so the recompute predicts the same masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from blade_torch.attention.integration import stack_masks
from blade_torch.kernels.norm_rope import heads_pack
from blade_torch.kernels.qk_norm_rope import qk_norm_rope
from blade_torch.models.layers import (
    FeedForward,
    Linear,
    PermutedLayerNorm,
    PermutedLinear,
    checkpoint_block,
    deinterleave_perm,
    dense_attention_fn,
    init_lecun_,
    rope_3d_tables,
    sinusoidal_timestep_embedding,
)
from blade_torch.utils import tracing

__all__ = ["CogVideoXConfig", "CogVideoXModel", "COGVIDEOX_5B", "COGVIDEOX_TINY"]


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    dim: int = 3072
    num_heads: int = 48
    num_layers: int = 42
    in_channels: int = 16
    out_channels: int = 16
    text_embed_dim: int = 4096
    time_embed_dim: int = 512
    patch_size: int = 2
    ffn_mult: int = 4
    eps: float = 1e-5
    rope_dims: Tuple[int, int, int] = (16, 24, 24)  # (t, h, w) of head_dim 64

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


COGVIDEOX_5B = CogVideoXConfig()
COGVIDEOX_TINY = CogVideoXConfig(dim=128, num_heads=2, num_layers=2, text_embed_dim=64,
                                 time_embed_dim=64)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Affine LayerNorm in f32 (returns f32)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


class LayerNormZero(nn.Module):
    """One affine LayerNorm shared by text and video, with a 6-way
    (shift/scale/gate x {video, text}) modulation from the time embedding."""

    def __init__(self, c: CogVideoXConfig, device=None):
        super().__init__()
        self.linear = Linear(c.time_embed_dim, 6 * c.dim, compute_dtype=torch.float32,
                             device=device)
        self.norm = nn.LayerNorm(c.dim, eps=c.eps, device=device)

    def forward(self, hidden, enc, temb, dtype):
        mod = self.linear(F.silu(temb.float()))
        shift, scale, gate, e_shift, e_scale, e_gate = (m[:, None] for m in mod.chunk(6, dim=-1))
        h = _layer_norm(self.norm, hidden) * (1 + scale) + shift
        e = _layer_norm(self.norm, enc) * (1 + e_scale) + e_shift
        return h.to(dtype), e.to(dtype), gate, e_gate


class CogJointAttention(nn.Module):
    """Joint self-attention over ``[text, video]`` (or ``[video, text]``
    with ``text_last``) with per-head q/k LayerNorm and video RoPE."""

    def __init__(self, c: CogVideoXConfig, dtype, device=None):
        super().__init__()
        self.c = c
        perm = deinterleave_perm(c.num_heads, c.head_dim)
        hperm = deinterleave_perm(1, c.head_dim)
        kw = dict(compute_dtype=dtype, device=device)
        self.to_q = PermutedLinear(c.dim, c.dim, perm, **kw)
        self.to_k = PermutedLinear(c.dim, c.dim, perm, **kw)
        self.to_v = Linear(c.dim, c.dim, **kw)
        self.to_out = nn.ModuleList([Linear(c.dim, c.dim, **kw)])
        self.norm_q = PermutedLayerNorm(c.head_dim, hperm, eps=1e-6, device=device)
        self.norm_k = PermutedLayerNorm(c.head_dim, hperm, eps=1e-6, device=device)

    def forward(self, hidden, enc, cos, sin, attention_fn, attn_kwargs, text_last):
        c = self.c
        n_vid, n_txt = hidden.shape[1], enc.shape[1]
        tracing.count("dit.qk_norm_rope.recomputed_calls" if tracing.recomputing()
                      else "dit.qk_norm_rope.calls")
        with tracing.span("dit.qkv"):
            x = torch.cat([hidden, enc] if text_last else [enc, hidden], dim=1)
            b, l, _ = x.shape
            nq, nk = self.norm_q, self.norm_k
            q, k = qk_norm_rope(self.to_q(x), self.to_k(x), nq.weight, nq.bias, nk.weight,
                                nk.bias, cos, sin, c.num_heads, 0 if text_last else n_txt,
                                n_vid, eps=nq.eps)
            v = heads_pack(self.to_v(x), c.num_heads)
        with tracing.span("dit.self_attn"):
            out = attention_fn(q, k, v, **attn_kwargs)
            aux = None
            if isinstance(out, tuple):
                out, aux = out
            out = self.to_out[0](out.transpose(1, 2).reshape(b, l, c.dim))
            if text_last:
                return out[:, :n_vid], out[:, n_vid:], aux
            return out[:, n_txt:], out[:, :n_txt], aux


class CogVideoXBlock(nn.Module):
    def __init__(self, c: CogVideoXConfig, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNormZero(c, device)
        self.attn1 = CogJointAttention(c, dtype, device)
        self.norm2 = LayerNormZero(c, device)
        self.ff = FeedForward(c.dim, c.ffn_mult * c.dim, compute_dtype=dtype, device=device)

    def forward(self, hidden, enc, temb, cos, sin, attention_fn, attn_kwargs, text_last):
        n_txt = enc.shape[1]
        with tracing.span("dit.block"):
            with tracing.span("dit.modulate"):
                n_h, n_e, gate, e_gate = self.norm1(hidden, enc, temb, self.dtype)
            attn_h, attn_e, aux = self.attn1(n_h, n_e, cos, sin, attention_fn, attn_kwargs,
                                             text_last)
            with tracing.span("dit.modulate"):
                hidden = hidden + (gate * attn_h.float()).to(hidden.dtype)
                enc = enc + (e_gate * attn_e.float()).to(enc.dtype)
                n_h, n_e, gate, e_gate = self.norm2(hidden, enc, temb, self.dtype)
            with tracing.span("dit.ffn"):
                ff = self.ff(torch.cat([n_e, n_h], dim=1))
            with tracing.span("dit.modulate"):
                hidden = hidden + (gate * ff[:, n_txt:].float()).to(hidden.dtype)
                enc = enc + (e_gate * ff[:, :n_txt].float()).to(enc.dtype)
            return hidden, enc, aux


class _PatchEmbed(nn.Module):
    def __init__(self, c: CogVideoXConfig, dtype, device=None):
        super().__init__()
        self.proj = nn.Conv2d(c.in_channels, c.dim, c.patch_size, stride=c.patch_size,
                              device=device)
        self.text_proj = Linear(c.text_embed_dim, c.dim, compute_dtype=dtype, device=device)


class _TimeEmbedding(nn.Module):
    def __init__(self, c: CogVideoXConfig, device=None):
        super().__init__()
        kw = dict(compute_dtype=torch.float32, device=device)
        self.linear_1 = Linear(c.dim, c.time_embed_dim, **kw)
        self.linear_2 = Linear(c.time_embed_dim, c.time_embed_dim, **kw)


class _AdaNormOut(nn.Module):
    def __init__(self, c: CogVideoXConfig, device=None):
        super().__init__()
        self.linear = Linear(c.time_embed_dim, 2 * c.dim, compute_dtype=torch.float32,
                             device=device)
        self.norm = nn.LayerNorm(c.dim, eps=c.eps, device=device)


class CogVideoXModel(nn.Module):
    """CogVideoX DiT: ``[B, T, C, H, W]`` latents + text embeddings ->
    v-prediction (f32).

    ``attention_fn(q, k, v, **attn_kwargs)`` runs every joint
    self-attention over ``[B, H, L, 64]``.  With
    ``attn_kwargs['collect_mask']`` the forward returns ``(v, masks)``, the
    per-layer mask artifacts stacked to ``[L, ...]``.
    """

    def __init__(self, cfg: CogVideoXConfig, *, dtype=torch.bfloat16,
                 attention_fn: Callable = dense_attention_fn,
                 token_perm: Optional[Tuple[Any, Any]] = None, remat: bool = False,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.attention_fn = attention_fn
        self.token_perm = token_perm
        if token_perm is not None:
            for name, idx in zip(("_perm_idx", "_inv_idx"), token_perm):
                self.register_buffer(name, torch.from_numpy(np.array(idx, np.int64)).to(device),
                                     persistent=False)
        c = cfg
        self.patch_embed = _PatchEmbed(c, dtype, device)
        self.time_embedding = _TimeEmbedding(c, device)
        self.transformer_blocks = nn.ModuleList([CogVideoXBlock(c, dtype, device)
                                                 for _ in range(c.num_layers)])
        self.norm_final = nn.LayerNorm(c.dim, eps=c.eps, device=device)
        self.norm_out = _AdaNormOut(c, device)
        self.proj_out = Linear(c.dim, c.patch_size ** 2 * c.out_channels,
                               compute_dtype=torch.float32, device=device)
        self._rope: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "CogVideoXModel":
        """flax-default random weights: lecun-normal projections and patch
        conv, zero biases, unit LayerNorm scales."""
        init_lecun_(self, generator)
        return self

    def _rope_tables(self, grid, device):
        key = (grid, str(device))
        if key not in self._rope:
            cos, sin = rope_3d_tables(self.cfg.head_dim, grid, dims_thw=self.cfg.rope_dims)
            if self.token_perm is not None:
                perm = np.asarray(self.token_perm[0])
                cos, sin = cos[perm], sin[perm]
            self._rope[key] = (torch.from_numpy(np.ascontiguousarray(cos)).to(device),
                               torch.from_numpy(np.ascontiguousarray(sin)).to(device))
        return self._rope[key]

    def _patchify(self, latents):
        """Per-frame Conv2d with kernel == stride, as one matmul over patch
        features (tokens t-major, then h, then w)."""
        c = self.cfg
        b, t, ch, h, w = latents.shape
        p = c.patch_size
        x = latents.to(self.dtype).reshape(b, t, ch, h // p, p, w // p, p)
        x = x.permute(0, 1, 3, 5, 2, 4, 6).reshape(b, t * (h // p) * (w // p), ch * p * p)
        proj = self.patch_embed.proj
        return F.linear(x, proj.weight.reshape(c.dim, -1).to(self.dtype),
                        proj.bias.to(self.dtype))

    def forward(self, latents, timestep, text_embeds, attn_kwargs=None):
        c = self.cfg
        attn_kwargs = dict(attn_kwargs or {})
        collect = bool(attn_kwargs.get("collect_mask", False))
        b, t, _, h, w = latents.shape
        p = c.patch_size
        gh, gw = h // p, w // p
        text_last = self.token_perm is not None

        with tracing.span("dit"):
            with tracing.span("dit.embed"):
                x = self._patchify(latents)
                enc = self.patch_embed.text_proj(text_embeds.to(self.dtype))
                te = self.time_embedding
                temb = te.linear_2(F.silu(te.linear_1(
                    sinusoidal_timestep_embedding(timestep, c.dim))))

                cos, sin = self._rope_tables((t, gh, gw), latents.device)
                if text_last:
                    x = x.index_select(1, self._perm_idx)

            auxes = []
            remat = self.remat and torch.is_grad_enabled()
            for i, blk in enumerate(self.transformer_blocks):
                args = (x, enc, temb, cos, sin, self.attention_fn,
                        dict(attn_kwargs, layer_index=i), text_last)
                x, enc, aux = checkpoint_block(blk, *args) if remat else blk(*args)
                if aux is not None:
                    auxes.append(aux)

            with tracing.span("dit.head"):
                # joint LayerNorm over [text, video], then the AdaLN head
                joint = _layer_norm(self.norm_final, torch.cat([enc, x], dim=1))
                hidden = joint[:, enc.shape[1]:]
                shift, scale = (m[:, None]
                                for m in self.norm_out.linear(F.silu(temb)).chunk(2, dim=-1))
                hidden = _layer_norm(self.norm_out.norm, hidden) * (1 + scale) + shift
                out = self.proj_out(hidden.to(self.dtype).float())
                if text_last:
                    out = out.index_select(1, self._inv_idx)
                # proj_out features are channel-major (C, p, p), as in diffusers
                out = out.reshape(b, t, gh, gw, c.out_channels, p, p)
                out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, t, c.out_channels, h, w)
            if collect:
                return out, stack_masks(auxes)
            return out
