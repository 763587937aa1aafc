"""Shared building blocks for the port's video DiT.

Counterpart of ``blade/models/layers.py``.  Conventions kept from the JAX
package: ``Linear`` layers compute in the module's ``dtype`` (bf16 on the
card) while norms, softmax, modulation and the time embedding run in f32;
rotary tables are static per geometry.  Parameter names follow the
diffusers state-dict layout.  Parameters are f32, except that a ``Linear``
stores its weight and bias in the dtype it computes in (see
:class:`Linear`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from blade_torch.utils import tracing

__all__ = [
    "Linear",
    "PermutedLinear",
    "RMSNorm",
    "PermutedRMSNorm",
    "PermutedLayerNorm",
    "FeedForward",
    "sinusoidal_timestep_embedding",
    "TimestepEmbedder",
    "rope_3d_tables",
    "apply_rope_half",
    "deinterleave_perm",
    "dense_attention_fn",
    "init_lecun_",
    "checkpoint_block",
]


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (inputs cast, like
    flax ``Dense(dtype=bf16, param_dtype=f32)``) and stores its weight and
    bias in that dtype.  The forward rounds f32 parameters to
    ``compute_dtype`` anyway, so storing them rounded gives bit-identical
    results: loading an f32 state dict rounds on copy, and random init
    draws in f32 first (:func:`init_lecun_`).  A bf16 layer thus holds half
    the bytes of f32 and needs no cast a call; an f32 layer (time
    embedding, modulation projection, ``proj_out``) keeps f32.  A parameter
    substituted through ``torch.func.functional_call`` is still cast."""

    def __init__(self, in_features, out_features, bias=True, *,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=compute_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), b)


def _permute_rows_on_load(module, state_dict, prefix, names, perm):
    for name in names:
        key = prefix + name
        if key in state_dict:
            state_dict[key] = state_dict[key][perm.to(state_dict[key].device)]


def _unpermute_rows_on_save(destination, prefix, names, inv):
    for name in names:
        key = prefix + name
        if key in destination:
            destination[key] = destination[key][inv.to(destination[key].device)]


class PermutedLinear(Linear):
    """``Linear`` whose output channels are stored permuted by ``out_perm``.

    The permutation is folded into the weight rows and bias ONCE, when a
    state dict is loaded; ``state_dict()`` un-permutes, so checkpoints keep
    the diffusers layout.  (The JAX ``PermutedDense`` gathers the kernel
    columns on every trace instead.)
    """

    def __init__(self, in_features, out_features, out_perm: np.ndarray, **kw):
        super().__init__(in_features, out_features, **kw)
        self._perm = torch.as_tensor(np.asarray(out_perm), dtype=torch.long)
        self._inv = torch.argsort(self._perm)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        _permute_rows_on_load(self, state_dict, prefix, ("weight", "bias"), self._perm)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        _unpermute_rows_on_save(destination, prefix, ("weight", "bias"), self._inv)


class RMSNorm(nn.Module):
    """RMS norm over the last axis, f32 internals, learned scale ``weight``;
    returns the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


class PermutedRMSNorm(RMSNorm):
    """``RMSNorm`` whose scale is stored permuted (folded at load time, see
    :class:`PermutedLinear`); the RMS statistic is permutation-invariant."""

    def __init__(self, dim: int, feature_perm: np.ndarray, eps: float = 1e-6,
                 device=None):
        super().__init__(dim, eps, device)
        self._perm = torch.as_tensor(np.asarray(feature_perm), dtype=torch.long)
        self._inv = torch.argsort(self._perm)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        _permute_rows_on_load(self, state_dict, prefix, ("weight",), self._perm)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        _unpermute_rows_on_save(destination, prefix, ("weight",), self._inv)


class PermutedLayerNorm(nn.LayerNorm):
    """Affine ``LayerNorm`` (f32 internals, returns f32) whose scale and
    bias are stored permuted by ``feature_perm`` (folded at load time, see
    :class:`PermutedLinear`); mean and variance are permutation-invariant."""

    def __init__(self, dim: int, feature_perm: np.ndarray, eps: float = 1e-6,
                 device=None):
        super().__init__(dim, eps=eps, device=device)
        self._perm = torch.as_tensor(np.asarray(feature_perm), dtype=torch.long)
        self._inv = torch.argsort(self._perm)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        _permute_rows_on_load(self, state_dict, prefix, ("weight", "bias"), self._perm)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        _unpermute_rows_on_save(destination, prefix, ("weight", "bias"), self._inv)


class _GeluProj(nn.Module):
    """diffusers ``GELU`` activation block (``approximate`` 'tanh' or
    'none'): ``proj``."""

    def __init__(self, dim, inner, compute_dtype, device=None, approximate="tanh"):
        super().__init__()
        self.proj = Linear(dim, inner, compute_dtype=compute_dtype, device=device)
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(self.proj(x), approximate=self.approximate)


class FeedForward(nn.Module):
    """GELU(tanh) MLP (exact GELU with ``approximate="none"``) from ``dim``
    to ``out_dim`` (default ``dim``); keys ``net.0.proj`` and ``net.2``
    (diffusers)."""

    def __init__(self, dim: int, inner_dim: int, *, compute_dtype=torch.bfloat16,
                 device=None, out_dim: Optional[int] = None, approximate: str = "tanh"):
        super().__init__()
        self.net = nn.ModuleList([
            _GeluProj(dim, inner_dim, compute_dtype, device, approximate),
            nn.Identity(),
            Linear(inner_dim, out_dim or dim, compute_dtype=compute_dtype, device=device),
        ])

    def forward(self, x):
        return self.net[2](self.net[0](x))


def sinusoidal_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``[B] -> [B, dim]`` sinusoidal features ``[cos | sin]`` (f32, even dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedder(nn.Module):
    """sinusoidal -> Linear -> SiLU -> Linear, all f32 (feeds modulation);
    keys ``linear_1``/``linear_2`` (diffusers ``time_embedder``)."""

    def __init__(self, hidden_dim: int, freq_dim: int = 256, device=None):
        super().__init__()
        self.freq_dim = freq_dim
        self.linear_1 = Linear(freq_dim, hidden_dim, compute_dtype=torch.float32,
                               device=device)
        self.linear_2 = Linear(hidden_dim, hidden_dim, compute_dtype=torch.float32,
                               device=device)

    def forward(self, t):
        x = sinusoidal_timestep_embedding(t, self.freq_dim)
        return self.linear_2(F.silu(self.linear_1(x)))


def rope_3d_tables(head_dim: int, grid_thw: Tuple[int, int, int], *,
                   dims_thw: Optional[Tuple[int, int, int]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Static 3-D rotary cos/sin tables ``[T*H*W, head_dim/2]`` (f32 numpy).

    The rotary half-dims ``c = head_dim/2`` split over (t, h, w) as
    ``(c - 2*(c//3), c//3, c//3)`` (Wan) or as half of ``dims_thw``
    (CogVideoX: ``(16, 24, 24)`` of 64), theta 10000; tokens are t-major
    then h then w.
    """
    t_len, h_len, w_len = grid_thw
    c = head_dim // 2
    if dims_thw is None:
        ch = cw = c // 3
        ct = c - 2 * ch
    else:
        if sum(dims_thw) != head_dim:
            raise ValueError(f"dims_thw {dims_thw} must sum to head_dim {head_dim}")
        ct, ch, cw = (n // 2 for n in dims_thw)

    def axis_freqs(n, cdim):
        inv = 1.0 / (10000.0 ** (np.arange(cdim, dtype=np.float64) / cdim))
        return np.outer(np.arange(n, dtype=np.float64), inv)

    ft = axis_freqs(t_len, ct)
    fh = axis_freqs(h_len, ch)
    fw = axis_freqs(w_len, cw)
    angles = np.concatenate(
        [
            np.broadcast_to(ft[:, None, None, :], (t_len, h_len, w_len, ct)),
            np.broadcast_to(fh[None, :, None, :], (t_len, h_len, w_len, ch)),
            np.broadcast_to(fw[None, None, :, :], (t_len, h_len, w_len, cw)),
        ],
        axis=-1,
    ).reshape(t_len * h_len * w_len, c)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of ``x [..., L, D]`` by tables ``[L, D/2]`` (f32
    math, returns x's dtype): channel ``i`` pairs with ``i + D/2``.  Equal to
    the checkpoint's interleaved-pair RoPE on channels permuted by
    :func:`deinterleave_perm`."""
    half = x.shape[-1] // 2
    xf = x.float()
    re, im = xf[..., :half], xf[..., half:]
    return torch.cat([re * cos - im * sin, re * sin + im * cos], dim=-1).to(x.dtype)


def deinterleave_perm(num_heads: int, head_dim: int) -> np.ndarray:
    """Channel permutation mapping interleaved rotary pairs ``(0,1),(2,3),...``
    to split halves within each head's slot of a packed projection.  Folded
    into the q/k projections and norm scales it turns the checkpoint's
    interleaved-pair RoPE into rotate-half RoPE; attention is invariant to a
    common q/k channel permutation, so nothing downstream unpermutes."""
    d = head_dim
    deint = np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])
    return (np.arange(num_heads)[:, None] * d + deint[None, :]).reshape(-1)


def dense_attention_fn(q, k, v, **_):
    """Dense attention: the port's flash kernel on the card, its plain
    version on the CPU."""
    from blade_torch.kernels.block_sparse_attn import flash_attention

    out, _ = flash_attention(q, k, v)
    return out


@torch.no_grad()
def init_lecun_(module: nn.Module, generator: torch.Generator) -> None:
    """Random init matching flax's defaults: every Linear / Conv weight
    ``N(0, 1/fan_in)`` (lecun normal), biases zero.  Norm scales and other
    parameters are left to their module's own init.  The draws are f32 and
    rounded to a weight stored in another dtype, so the same generator
    gives the same model whatever the storage."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            w = torch.empty(m.weight.shape, dtype=torch.float32, device=m.weight.device)
            m.weight.copy_(w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator))
            if m.bias is not None:
                m.bias.zero_()


def _call_block(blk, state, *args):
    return torch.func.functional_call(blk, state, args)


def checkpoint_block(blk: nn.Module, *args):
    """``blk(*args)``, recomputed in the backward (``torch.utils.checkpoint``,
    the counterpart of flax ``nn.remat``).  The block's tensors go in
    explicitly: under an outer ``functional_call`` the recompute must see the
    substituted parameters, which are gone from the module by then.  Every
    random draw comes from an explicit generator, so the global RNG state
    needs no stashing.  Every call of the block after the first is the
    backward's recomputation, marked so (``tracing.recompute``)."""
    state = dict(blk.named_parameters())
    state.update(blk.named_buffers())
    calls = []

    def call(*a):
        with tracing.recompute(bool(calls)):
            calls.append(None)
            return _call_block(*a)

    return checkpoint(call, blk, state, *args, use_reentrant=False,
                      preserve_rng_state=False)
