"""Wan2.1 video diffusion transformer (PyTorch): text-to-video, and
image-to-video with ``image_dim`` set.

Counterpart of ``blade/models/wan_dit.py``, with the diffusers
``WanTransformer3DModel`` state-dict layout: patchify (1,2,2), per-block
AdaLN with a 6-way modulation table, video self-attention with 3-D RoPE and
RMS q/k norm, text cross-attention, GELU(tanh) FFN, modulated head.  The
model output is the flow-matching velocity.

Image to video (Wan2.1-I2V): the DiT reads ``in_channels`` = the latents
and the conditioning channels (``condition``: a first-frame mask and the
VAE-encoded image clip), concatenated before patchify; CLIP image features
go through the f32 image embedder (``condition_embedder.image_embedder``),
and every block's cross-attention adds an image branch over them
(``add_k_proj``, ``add_v_proj``, ``norm_added_k``): a second softmax
beside the text's, the two outputs summed in ``dtype`` before ``to_out``.

Numerics follow the JAX model: projections in ``dtype`` (bf16 on the card),
their weights stored in it (``layers.Linear``); LayerNorms, modulation,
gates, the time embedding and ``proj_out`` in f32 with f32 parameters; the
residual stream in ``dtype``.  A block's glue (its two modulated LayerNorms,
the cross-attention's LayerNorm, the residual and gated residual adds) and
the head's modulated LayerNorm run as the row kernels of
``kernels/adaln.py`` where autograd records nothing, with the same rounding
points, and as the expression they stand for otherwise.

Self-attention q/k run with the ``deinterleave_perm`` channel permutation
folded into ``to_q``/``to_k`` and ``norm_q``/``norm_k`` once at load time, so
``norm_rope_heads`` takes the relayout-free rotate-half form.  With
``token_perm`` set (ASA), tokens are permuted once after patchify and
restored once at ``proj_out``.  ``remat=True`` recomputes each block in the
backward (``torch.utils.checkpoint``, the counterpart of flax ``nn.remat``).
The model runs under ``torch.func.functional_call`` with a substituted
parameter dict (TDM's three roles over one base), and tolerates a base held
in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from blade_torch.attention.integration import stack_masks
from blade_torch.kernels.adaln import (
    add_norm_affine,
    add_norm_affine_reference,
    gated_add,
    gated_add_reference,
    norm_affine,
    norm_affine_reference,
)
from blade_torch.kernels.block_sparse_attn import flash_attention
from blade_torch.kernels.norm_rope import heads_pack, heads_unpack, norm_rope_heads
from blade_torch.models.layers import (
    FeedForward,
    Linear,
    PermutedLinear,
    PermutedRMSNorm,
    RMSNorm,
    TimestepEmbedder,
    checkpoint_block,
    deinterleave_perm,
    dense_attention_fn,
    init_lecun_,
    rope_3d_tables,
)
from blade_torch.utils import tracing

__all__ = ["WanConfig", "WanModel", "WAN_1_3B", "WAN_14B", "WAN_TINY", "WAN_I2V_14B",
           "WAN_I2V_TINY"]


@dataclasses.dataclass(frozen=True)
class WanConfig:
    dim: int = 1536
    ffn_dim: int = 8960
    num_layers: int = 30
    num_heads: int = 12
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    eps: float = 1e-6
    cross_attn_norm: bool = True
    # Image to video: the width of the CLIP image features and their tokens
    # (ViT-H/14: 1280 x 257); None = text to video, no image branch.
    image_dim: Optional[int] = None
    image_context_tokens: int = 257

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


WAN_1_3B = WanConfig()
# Wan2.1-T2V-14B (the Wan-AI/Wan2.1-T2V-14B-Diffusers transformer config):
# 40 blocks of width 5120, 40 heads of 128, FFN 13824.
WAN_14B = WanConfig(dim=5120, ffn_dim=13824, num_layers=40, num_heads=40)
WAN_TINY = WanConfig(dim=128, ffn_dim=256, num_layers=2, num_heads=2, text_dim=64,
                     freq_dim=32)
# Wan2.1-I2V-14B (Wan-AI/Wan2.1-I2V-14B-480P): the 14B DiT reading 36
# channels (16 latent, 4 mask, 16 encoded image) and 257 x 1280 CLIP tokens.
WAN_I2V_14B = dataclasses.replace(WAN_14B, in_channels=36, image_dim=1280)
WAN_I2V_TINY = dataclasses.replace(WAN_TINY, in_channels=36, image_dim=48,
                                   image_context_tokens=9)


# The block's glue (LayerNorms, modulation, residual adds): the row kernels,
# and the expression they stand for.
_FUSED_GLUE = (norm_affine, add_norm_affine, gated_add)
_PLAIN_GLUE = (norm_affine_reference, add_norm_affine_reference, gated_add_reference)


class WanSelfAttention(nn.Module):
    def __init__(self, c: WanConfig, dtype, device=None):
        super().__init__()
        self.c = c
        perm = deinterleave_perm(c.num_heads, c.head_dim)
        kw = dict(compute_dtype=dtype, device=device)
        self.to_q = PermutedLinear(c.dim, c.dim, perm, **kw)
        self.to_k = PermutedLinear(c.dim, c.dim, perm, **kw)
        self.to_v = Linear(c.dim, c.dim, **kw)
        self.to_out = nn.ModuleList([Linear(c.dim, c.dim, **kw)])
        self.norm_q = PermutedRMSNorm(c.dim, perm, eps=c.eps, device=device)
        self.norm_k = PermutedRMSNorm(c.dim, perm, eps=c.eps, device=device)

    def forward(self, x, cos, sin, attention_fn, attn_kwargs):
        c = self.c
        b, l, _ = x.shape
        with tracing.span("dit.qkv"):
            q = norm_rope_heads(self.to_q(x), self.norm_q.weight.float(), cos, sin,
                                c.num_heads, eps=c.eps)
            k = norm_rope_heads(self.to_k(x), self.norm_k.weight.float(), cos, sin,
                                c.num_heads, eps=c.eps)
            v = self.to_v(x).reshape(b, l, c.num_heads, c.head_dim).transpose(1, 2).contiguous()
        with tracing.span("dit.self_attn"):
            out = attention_fn(q, k, v, **attn_kwargs)
            aux = None
            if isinstance(out, tuple):
                out, aux = out
            out = out.transpose(1, 2).reshape(b, l, c.dim)
            return self.to_out[0](out), aux


class WanCrossAttention(nn.Module):
    """Text cross-attention over the context's (<= 512) tokens on the dense
    flash kernels (``flash_attention``: #1 forward, #5/#6 backward), heads
    split and merged by ``heads_pack`` / ``heads_unpack``; CPU tensors take
    their plain versions.  As in the JAX model, q . k and the softmax are in
    f32 and the kernel rounds P to bf16 for P @ V (the plain version keeps P
    in f32).

    With ``image_dim`` set, the image branch (span ``dit.cross_attn.image``)
    runs the same packed q over the image tokens' keys
    (``norm_added_k(add_k_proj(img))``) and values (``add_v_proj(img)``) in
    a second ``flash_attention`` call, its own softmax, and adds its output
    to the text branch's in ``dtype`` before ``to_out``."""

    def __init__(self, c: WanConfig, dtype, device=None):
        super().__init__()
        self.c = c
        kw = dict(compute_dtype=dtype, device=device)
        self.to_q = Linear(c.dim, c.dim, **kw)
        self.to_k = Linear(c.dim, c.dim, **kw)
        self.to_v = Linear(c.dim, c.dim, **kw)
        self.to_out = nn.ModuleList([Linear(c.dim, c.dim, **kw)])
        self.norm_q = RMSNorm(c.dim, eps=c.eps, device=device)
        self.norm_k = RMSNorm(c.dim, eps=c.eps, device=device)
        if c.image_dim is not None:
            self.add_k_proj = Linear(c.dim, c.dim, **kw)
            self.add_v_proj = Linear(c.dim, c.dim, **kw)
            self.norm_added_k = RMSNorm(c.dim, eps=c.eps, device=device)

    def forward(self, x, context, image_context=None):
        c = self.c
        recomputing = tracing.recomputing()
        tracing.count("dit.cross_attn.recomputed_calls" if recomputing
                      else "dit.cross_attn.calls")
        q = heads_pack(self.norm_q(self.to_q(x)), c.num_heads)
        k = heads_pack(self.norm_k(self.to_k(context)), c.num_heads)
        v = heads_pack(self.to_v(context), c.num_heads)
        out, _ = flash_attention(q, k, v)  # scale 1 / sqrt(head_dim)
        if image_context is not None:
            with tracing.span("dit.cross_attn.image"):
                if not recomputing:
                    tracing.count("dit.cross_attn.image_calls")
                k = heads_pack(self.norm_added_k(self.add_k_proj(image_context)), c.num_heads)
                v = heads_pack(self.add_v_proj(image_context), c.num_heads)
                out = out + flash_attention(q, k, v)[0]
        return self.to_out[0](heads_unpack(out))


class WanBlock(nn.Module):
    def __init__(self, c: WanConfig, dtype, device=None):
        super().__init__()
        self.c = c
        self.scale_shift_table = nn.Parameter(torch.zeros(1, 6, c.dim, device=device))
        self.attn1 = WanSelfAttention(c, dtype, device)
        self.attn2 = WanCrossAttention(c, dtype, device)
        # diffusers' `norm2` is the cross-attention LayerNorm (flax `norm3`).
        self.norm2 = (nn.LayerNorm(c.dim, eps=c.eps, elementwise_affine=True,
                                   device=device)
                      if c.cross_attn_norm else nn.Identity())
        self.ffn = FeedForward(c.dim, c.ffn_dim, compute_dtype=dtype, device=device)

    def forward(self, x, context, temb6, cos, sin, attention_fn, attn_kwargs,
                image_context=None):
        c = self.c
        # Where autograd records nothing, the glue runs as the row kernels
        # (CPU tensors: their plain versions); otherwise as the expression
        # they stand for, whose gradient autograd takes.
        fused = not torch.is_grad_enabled()
        if not tracing.recomputing():
            tracing.count("dit.modulate.fused_calls" if fused else "dit.modulate.autograd_calls")
        norm, add_norm, gated = _FUSED_GLUE if fused else _PLAIN_GLUE
        with tracing.span("dit.block"):
            with tracing.span("dit.modulate"):
                e = (self.scale_shift_table + temb6).float()
                shift1, scale1, gate1, shift2, scale2, gate2 = e.unbind(1)
                h = norm(x, 1 + scale1, shift1, c.eps)
            attn, aux = self.attn1(h, cos, sin, attention_fn, attn_kwargs)
            with tracing.span("dit.modulate"):
                if c.cross_attn_norm:
                    n2 = self.norm2
                    x, n = add_norm(x, attn, gate1, n2.weight.float(), n2.bias.float(), n2.eps)
                else:
                    x = n = gated(x, attn, gate1)
            with tracing.span("dit.cross_attn"):
                cross = self.attn2(n, context, image_context)
            with tracing.span("dit.modulate"):
                x, h = add_norm(x, cross, None, 1 + scale2, shift2, c.eps)
            with tracing.span("dit.ffn"):
                f = self.ffn(h)
            with tracing.span("dit.modulate"):
                x = gated(x, f, gate2)
            return x, aux


class _TextEmbedder(nn.Module):
    def __init__(self, text_dim, dim, dtype, device=None):
        super().__init__()
        self.linear_1 = Linear(text_dim, dim, compute_dtype=dtype, device=device)
        self.linear_2 = Linear(dim, dim, compute_dtype=dtype, device=device)

    def forward(self, t):
        return self.linear_2(F.gelu(self.linear_1(t), approximate="tanh"))


class _ImageEmbedder(nn.Module):
    """diffusers ``WanImageEmbedding``, all in f32: LayerNorm(image_dim) ->
    Linear(image_dim, image_dim) -> exact GELU -> Linear(image_dim, dim) ->
    LayerNorm(dim), LayerNorm eps 1e-5."""

    def __init__(self, image_dim, dim, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(image_dim, eps=1e-5, device=device)
        self.ff = FeedForward(image_dim, image_dim, out_dim=dim, compute_dtype=torch.float32,
                              approximate="none", device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, img):
        return self.norm2(self.ff(self.norm1(img.float())))


class _ConditionEmbedder(nn.Module):
    def __init__(self, c: WanConfig, dtype, device=None):
        super().__init__()
        self.text_embedder = _TextEmbedder(c.text_dim, c.dim, dtype, device)
        self.time_embedder = TimestepEmbedder(c.dim, c.freq_dim, device=device)
        self.time_proj = Linear(c.dim, 6 * c.dim, compute_dtype=torch.float32,
                                device=device)
        if c.image_dim is not None:
            self.image_embedder = _ImageEmbedder(c.image_dim, c.dim, device)


class WanModel(nn.Module):
    """Wan DiT over latent video ``[B, C, T, H, W]`` -> velocity (f32).

    ``attention_fn(q, k, v, **attn_kwargs)`` runs every block's
    self-attention over ``[B, H, L, D]`` in token order ``(t, h, w)``
    t-major (or in ``token_perm`` order).  With
    ``attn_kwargs['collect_mask']`` the forward returns ``(velocity,
    masks [L, ...])``, the stand-in for flax's ``sow``.  With ``image_dim``
    set, ``image_embeds [B, image_context_tokens, image_dim]`` and
    ``condition [B, in_channels - out_channels, T, H, W]`` are required.
    """

    def __init__(self, cfg: WanConfig, *, dtype=torch.bfloat16,
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
        pt, ph, pw = c.patch_size
        self.patch_embedding = nn.Conv3d(c.in_channels, c.dim, kernel_size=c.patch_size,
                                         stride=c.patch_size, device=device)
        self.condition_embedder = _ConditionEmbedder(c, dtype, device)
        self.blocks = nn.ModuleList([WanBlock(c, dtype, device)
                                     for _ in range(c.num_layers)])
        self.scale_shift_table = nn.Parameter(torch.zeros(1, 2, c.dim, device=device))
        self.proj_out = Linear(c.dim, pt * ph * pw * c.out_channels,
                               compute_dtype=torch.float32, device=device)
        self._rope: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "WanModel":
        """flax-default random weights: lecun-normal projections, zero
        biases, unit norm scales, N(0, 0.02) modulation tables."""
        init_lecun_(self, generator)
        for blk in self.blocks:
            blk.scale_shift_table.normal_(0.0, 0.02, generator=generator)
        self.scale_shift_table.normal_(0.0, 0.02, generator=generator)
        return self

    def _rope_tables(self, grid, device):
        key = (grid, str(device))
        if key not in self._rope:
            cos, sin = rope_3d_tables(self.cfg.head_dim, grid)
            if self.token_perm is not None:
                perm = np.asarray(self.token_perm[0])
                cos, sin = cos[perm], sin[perm]
            self._rope[key] = (torch.from_numpy(np.ascontiguousarray(cos)).to(device),
                               torch.from_numpy(np.ascontiguousarray(sin)).to(device))
        return self._rope[key]

    def _patchify(self, latents):
        """Conv3d with kernel == stride, as one matmul over patch features."""
        c = self.cfg
        b, ch, t, h, w = latents.shape
        pt, ph, pw = c.patch_size
        gt, gh, gw = t // pt, h // ph, w // pw
        x = latents.to(self.dtype).reshape(b, ch, gt, pt, gh, ph, gw, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, gt * gh * gw, ch * pt * ph * pw)
        wgt = self.patch_embedding.weight.reshape(c.dim, -1).to(self.dtype)
        return F.linear(x, wgt, self.patch_embedding.bias.to(self.dtype))

    def forward(self, latents, timestep, text_embeds, attn_kwargs=None, image_embeds=None,
                condition=None):
        c = self.cfg
        if (image_embeds is None or condition is None) != (c.image_dim is None):
            raise ValueError("image_embeds and condition are required iff image_dim is set "
                             f"(image_dim={c.image_dim})")
        attn_kwargs = dict(attn_kwargs or {})
        collect = bool(attn_kwargs.get("collect_mask", False))
        b, _, t, h, w = latents.shape
        pt, ph, pw = c.patch_size
        gt, gh, gw = t // pt, h // ph, w // pw

        with tracing.span("dit"):
            with tracing.span("dit.embed"):
                if condition is not None:
                    latents = torch.cat([latents, condition.to(latents.dtype)], dim=1)
                x = self._patchify(latents)
                ce = self.condition_embedder
                ctx = ce.text_embedder(text_embeds.to(self.dtype))
                temb = ce.time_embedder(timestep)
                temb6 = ce.time_proj(F.silu(temb)).reshape(b, 6, c.dim)

                cos, sin = self._rope_tables((gt, gh, gw), latents.device)
                if self.token_perm is not None:
                    x = x.index_select(1, self._perm_idx)
            img = None
            if image_embeds is not None:
                with tracing.span("dit.image_embed"):
                    img = ce.image_embedder(image_embeds).to(self.dtype)

            auxes = []
            remat = self.remat and torch.is_grad_enabled()
            for i, blk in enumerate(self.blocks):
                args = (x, ctx, temb6, cos, sin, self.attention_fn,
                        dict(attn_kwargs, layer_index=i))
                if img is not None:
                    args += (img,)
                x, aux = checkpoint_block(blk, *args) if remat else blk(*args)
                if aux is not None:
                    auxes.append(aux)

            with tracing.span("dit.head"):
                shift, scale = (self.scale_shift_table + temb[:, None, :]).float().unbind(1)
                norm = norm_affine_reference if torch.is_grad_enabled() else norm_affine
                out = self.proj_out(norm(x, 1 + scale, shift, c.eps).float())
                if self.token_perm is not None:
                    out = out.index_select(1, self._inv_idx)
                out = out.reshape(b, gt, gh, gw, pt, ph, pw, c.out_channels)
                out = out.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(b, c.out_channels, t, h, w)
            if collect:
                return out, stack_masks(auxes)
            return out
