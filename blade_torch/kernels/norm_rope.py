"""Fused RMS-norm + rotate-half RoPE + head split for the Wan q/k lane.

Counterpart of ``blade/kernels/norm_rope.py::norm_rope_heads``:
``x [B, S, D] -> rms(x) * scale -> [B, H, S, d] -> y * cos_f + roll(y, d/2)
* sin_f`` with the full-width tables ``cos_f = [cos|cos]``,
``sin_f = [-sin|sin]``.  ``x``'s channels arrive de-interleave-permuted
(``layers.deinterleave_perm`` folded into ``to_q``/``to_k``), which makes
rotate-half equal to the checkpoint's interleaved-pair RoPE.

The CUDA kernel is ``csrc/norm_rope.cu``; CPU tensors take the plain
version ``_norm_rope_reference``.  On the card the kernel's gradient
(``dx``, ``dscale``) is autograd through the plain version, recomputed in
the backward, exactly as JAX's custom VJP takes ``jax.vjp`` of its XLA
reference (there is no Pallas backward kernel to port).

Also the counterparts of JAX's ``heads_pack`` / ``heads_unpack``: the
``[B, S, H*d] <-> [B, H, S, d]`` relayouts, two CUDA copy kernels (any
dtype, any shape) bound in one ``torch.autograd.Function`` pair, each the
other's backward.  Wan's q/k head split is fused into
``norm_rope_heads`` and its V's is a strided copy, as in JAX; CogVideoX's V
takes ``heads_pack``.
"""

from __future__ import annotations

import torch

from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream

__all__ = ["norm_rope_heads", "rope_full_tables", "heads_pack", "heads_unpack"]

_norm_rope_kernel = CudaKernel(
    "norm_rope", "bt_norm_rope", "pppppiiiifp",
    source="blade_torch/csrc/norm_rope.cu",
    replaces="blade/kernels/norm_rope.py:102",  # _norm_rope_kernel
)

_heads_pack_kernel = CudaKernel(
    "heads_pack", "bt_heads_pack", "ppiiiiip",
    source="blade_torch/csrc/norm_rope.cu",
    replaces="blade/kernels/norm_rope.py:192",  # _pack_kernel
)
_heads_unpack_kernel = CudaKernel(
    "heads_unpack", "bt_heads_unpack", "ppiiiiip",
    source="blade_torch/csrc/norm_rope.cu",
    replaces="blade/kernels/norm_rope.py:198",  # _unpack_kernel
)


def rope_full_tables(cos: torch.Tensor, sin: torch.Tensor):
    """Half-width tables ``[L, d/2]`` -> full-width roll-form tables
    ``cos_f = [cos|cos]``, ``sin_f = [-sin|sin]`` (both ``[L, d]``)."""
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def _norm_rope_reference(x, scale, cos, sin, num_heads, eps):
    """Plain version: rms * scale -> head split -> roll-form rope (f32)."""
    b, s, dim = x.shape
    d = dim // num_heads
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale.float()
    y = y.reshape(b, s, num_heads, d).transpose(1, 2)
    cos_f, sin_f = rope_full_tables(cos.float(), sin.float())
    rolled = torch.roll(y, d // 2, dims=-1)
    return (y * cos_f + rolled * sin_f).to(x.dtype)


def _norm_rope_cuda(x, scale, cos, sin, num_heads, eps):
    check_inputs("norm_rope_heads", x, dtype=torch.bfloat16)
    check_inputs("norm_rope_heads", scale, cos, sin, dtype=torch.float32)
    b, s, dim = x.shape
    d = dim // num_heads
    if dim % 8 or d % 8 or dim // 8 > 1024:
        raise ValueError(f"norm_rope_heads: kernel needs D % 8 == 0, d % 8 == 0 "
                         f"and D <= 8192 (D={dim}, d={d})")
    out = torch.empty((b, num_heads, s, d), dtype=x.dtype, device=x.device)
    _norm_rope_kernel(x.data_ptr(), scale.data_ptr(), cos.data_ptr(),
                      sin.data_ptr(), out.data_ptr(), b, s, dim, num_heads,
                      float(eps), cuda_stream(x.device))
    return out


class _NormRope(torch.autograd.Function):
    """The CUDA kernel forward; backward = vjp of the plain version."""

    @staticmethod
    def forward(ctx, x, scale, cos, sin, num_heads, eps):
        ctx.save_for_backward(x, scale, cos, sin)
        ctx.num_heads, ctx.eps = num_heads, eps
        return _norm_rope_cuda(x, scale, cos, sin, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, cos, sin = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            sr = scale.detach().requires_grad_(True)
            out = _norm_rope_reference(xr, sr, cos, sin, ctx.num_heads, ctx.eps)
            dx, dscale = torch.autograd.grad(out, (xr, sr), g)
        return dx, dscale, None, None, None, None


def norm_rope_heads(
    x: torch.Tensor,
    scale: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``x [B, S, D]`` (bf16 on the card), ``scale [D]`` f32, ``cos``/``sin``
    ``[S, d/2]`` f32 -> ``[B, H, S, d]`` in ``x``'s dtype; differentiable in
    ``x`` and ``scale``."""
    b, s, dim = x.shape
    if dim % num_heads or scale.shape != (dim,):
        raise ValueError(f"norm_rope_heads: bad shapes x {tuple(x.shape)}, "
                         f"scale {tuple(scale.shape)}, heads {num_heads}")
    d = dim // num_heads
    if cos.shape != (s, d // 2) or sin.shape != (s, d // 2):
        raise ValueError(f"norm_rope_heads: tables must be [{s}, {d // 2}]")
    if not x.is_cuda:
        return _norm_rope_reference(x, scale, cos, sin, num_heads, eps)
    return _NormRope.apply(x, scale, cos, sin, num_heads, float(eps))


def _heads_pack_reference(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of the pack kernel: a strided copy into a new tensor."""
    b, s, dim = x.shape
    out = torch.empty((b, num_heads, s, dim // num_heads), dtype=x.dtype, device=x.device)
    return out.copy_(x.reshape(b, s, num_heads, -1).transpose(1, 2))


def _heads_unpack_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the unpack kernel."""
    b, h, s, d = x.shape
    out = torch.empty((b, s, h * d), dtype=x.dtype, device=x.device)
    return out.copy_(x.transpose(1, 2).reshape(b, s, h * d))


def _heads_pack_impl(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    if not x.is_cuda:
        return _heads_pack_reference(x, num_heads)
    if not x.is_contiguous():
        raise ValueError("heads_pack: the input must be contiguous")
    b, s, dim = x.shape
    d = dim // num_heads
    out = torch.empty((b, num_heads, s, d), dtype=x.dtype, device=x.device)
    if out.numel():
        _heads_pack_kernel(x.data_ptr(), out.data_ptr(), b, s, num_heads, d,
                           x.element_size(), cuda_stream(x.device))
    return out


def _heads_unpack_impl(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return _heads_unpack_reference(x)
    if not x.is_contiguous():
        raise ValueError("heads_unpack: the input must be contiguous")
    b, h, s, d = x.shape
    out = torch.empty((b, s, h * d), dtype=x.dtype, device=x.device)
    if out.numel():
        _heads_unpack_kernel(x.data_ptr(), out.data_ptr(), b, h, s, d, x.element_size(),
                             cuda_stream(x.device))
    return out


class _HeadsPack(torch.autograd.Function):
    """``heads_pack``; its backward is ``heads_unpack`` (a relayout's vjp is
    its inverse)."""

    @staticmethod
    def forward(ctx, x, num_heads):
        return _heads_pack_impl(x, num_heads)

    @staticmethod
    def backward(ctx, g):
        return _heads_unpack_impl(g.contiguous()), None


class _HeadsUnpack(torch.autograd.Function):
    """``heads_unpack``; its backward is ``heads_pack``."""

    @staticmethod
    def forward(ctx, x):
        ctx.num_heads = x.shape[1]
        return _heads_unpack_impl(x)

    @staticmethod
    def backward(ctx, g):
        return _heads_pack_impl(g.contiguous(), ctx.num_heads)


def heads_pack(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[B, S, H*d] -> [B, H, S, d]`` as one copy pass (bit exact),
    differentiable; the inverse of :func:`heads_unpack`."""
    if x.dim() != 3 or num_heads <= 0 or x.shape[-1] % num_heads:
        raise ValueError(f"heads_pack: x {tuple(x.shape)} must be [B, S, H*d] with "
                         f"H = {num_heads} dividing the last axis")
    return _HeadsPack.apply(x, num_heads)


def heads_unpack(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, S, d] -> [B, S, H*d]`` as one copy pass (bit exact),
    differentiable; the inverse of :func:`heads_pack`."""
    if x.dim() != 4:
        raise ValueError(f"heads_unpack: x {tuple(x.shape)} must be [B, H, S, d]")
    return _HeadsUnpack.apply(x)
