"""Wan's block glue as row kernels: AdaLN's LayerNorm and modulation, the
residual and gated residual adds, and the cross-attention's LayerNorm.

- ``norm_affine(x, w, b, eps) -> h``: ``h = LN(x) * w + b``, rounded to
  ``x``'s dtype;
- ``add_norm_affine(x, y, gate, w, b, eps) -> (x', h)``: ``x' = x +
  round(gate * y)`` (``x + y`` with ``gate`` None), rounded, then ``h`` of
  ``x'`` as ``norm_affine``;
- ``gated_add(x, y, gate) -> x'``: ``x' = x + round(gate * y)``, rounded.

``x`` and ``y`` are ``[B, S, D]`` in the residual stream's dtype (bf16 on
the card).  ``w``, ``b`` and ``gate`` are f32 tables: ``[B, D]`` (or
``[1, D]``), one row a sample, as the modulation's ``1 + scale``, ``shift``
and ``gate``; or ``[D]``, one row for every sample, as a LayerNorm's own
weight and bias.  The LayerNorm has no affine of its own and runs in f32.

The plain versions (``*_reference``) are the expression the Wan block
writes, one torch operation a step in f32 (``F.layer_norm`` of ``x.float()``,
``* w``, ``+ b``; a ``[D]`` weight and bias go into ``F.layer_norm`` as its
affine, as the cross-attention's LayerNorm does); CPU tensors take them.
CUDA tensors launch ``csrc/adaln.cu``, forward only: a call that autograd
would record raises.  The block takes the kernels where autograd records
nothing and the plain versions otherwise (``models/wan_dit.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream

__all__ = ["norm_affine", "add_norm_affine", "gated_add", "norm_affine_reference",
           "add_norm_affine_reference", "gated_add_reference"]

# No TPU kernel: the JAX model leaves the block's glue to XLA.
_norm_affine_kernel = CudaKernel(
    "norm_affine", "bt_norm_affine", "ppipipiiifp",
    source="blade_torch/csrc/adaln.cu",
    replaces="blade/models/wan_dit.py:220",  # LayerNorm and modulation (XLA)
)
_add_norm_affine_kernel = CudaKernel(
    "add_norm_affine", "bt_add_norm_affine", "pppipipippiiifp",
    source="blade_torch/csrc/adaln.cu",
    replaces="blade/models/wan_dit.py:224",  # (gated) residual and LayerNorm (XLA)
)
_gated_add_kernel = CudaKernel(
    "gated_add", "bt_gated_add", "pppipiiip",
    source="blade_torch/csrc/adaln.cu",
    replaces="blade/models/wan_dit.py:239",  # gated residual (XLA)
)


def norm_affine_reference(x, w, b, eps):
    """Plain version of :func:`norm_affine`."""
    xf = x.float()
    if w.dim() == 1:
        return F.layer_norm(xf, xf.shape[-1:], w.float(), b.float(), eps).to(x.dtype)
    return (F.layer_norm(xf, xf.shape[-1:], eps=eps) * w[:, None] + b[:, None]).to(x.dtype)


def gated_add_reference(x, y, gate):
    """Plain version of :func:`gated_add`."""
    return x + (gate[..., None, :] * y.float()).to(x.dtype)


def add_norm_affine_reference(x, y, gate, w, b, eps):
    """Plain version of :func:`add_norm_affine`."""
    x = x + y if gate is None else gated_add_reference(x, y, gate)
    return x, norm_affine_reference(x, w, b, eps)


def _rows(fn, *rows):
    """Whether the rows lie on the card; raise unless every one is ``[B, S,
    D]`` of the first one's shape."""
    x = rows[0]
    if x.dim() != 3 or any(r.shape != x.shape for r in rows):
        raise ValueError(f"{fn}: x and y must be one [B, S, D] shape, got "
                         f"{[tuple(r.shape) for r in rows]}")
    return x.is_cuda


def _check_forward_only(fn, *tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{fn} is forward-only on the card: call it under torch.no_grad()")


def _table(fn, t, x):
    """``(t, sample stride)`` of a f32 table of ``x``'s width D: ``[D]``
    shares one row (stride 0), ``[1, D]`` too, ``[B, D]`` gives a row a
    sample.  Its rows must be contiguous and 16-byte aligned."""
    bsz, _, dim = x.shape
    if t.dim() == 1:
        t = t[None]
    if t.dim() != 2 or t.shape[1] != dim or t.shape[0] not in (1, bsz):
        raise ValueError(f"{fn}: a table must be [{dim}] or [B, {dim}] with B 1 or "
                         f"{bsz}, got {tuple(t.shape)}")
    if t.dtype != torch.float32 or t.device != x.device:
        raise TypeError(f"{fn}: tables must be float32 on {x.device}, got {t.dtype} on "
                        f"{t.device}")
    stride = t.stride(0) if t.shape[0] > 1 else 0
    if t.stride(1) != 1 or stride % 4 or t.data_ptr() % 16:
        raise ValueError(f"{fn}: a table's rows must be contiguous and 16-byte aligned")
    return t, stride


def _shape_args(x, eps=None):
    bsz, s, dim = x.shape
    if dim % 8 or dim > 8192:
        raise ValueError(f"the row kernels need D % 8 == 0 and D <= 8192 (D={dim})")
    return (bsz, s, dim) + (() if eps is None else (float(eps),)) + (cuda_stream(x.device),)


def norm_affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """``LN(x) * w + b`` in f32, rounded to ``x``'s dtype (module doc)."""
    if not _rows("norm_affine", x):
        return norm_affine_reference(x, w, b, eps)
    _check_forward_only("norm_affine", x, w, b)
    check_inputs("norm_affine", x, dtype=torch.bfloat16)
    (w, ws), (b, bs) = _table("norm_affine", w, x), _table("norm_affine", b, x)
    h = torch.empty_like(x)
    if x.numel():
        _norm_affine_kernel(x.data_ptr(), w.data_ptr(), ws, b.data_ptr(), bs, h.data_ptr(),
                            *_shape_args(x, eps))
    return h


def add_norm_affine(x: torch.Tensor, y: torch.Tensor, gate, w: torch.Tensor, b: torch.Tensor,
                    eps: float):
    """``(x', h)``: ``x' = x + round(gate * y)`` (or ``x + y``) rounded, and
    ``norm_affine(x', w, b, eps)``, in one pass (module doc)."""
    if not _rows("add_norm_affine", x, y):
        return add_norm_affine_reference(x, y, gate, w, b, eps)
    _check_forward_only("add_norm_affine", x, y, gate, w, b)
    check_inputs("add_norm_affine", x, y, dtype=torch.bfloat16)
    g, gs = (None, 0) if gate is None else _table("add_norm_affine", gate, x)
    (w, ws), (b, bs) = _table("add_norm_affine", w, x), _table("add_norm_affine", b, x)
    xo, h = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        _add_norm_affine_kernel(x.data_ptr(), y.data_ptr(), None if g is None else g.data_ptr(),
                                gs, w.data_ptr(), ws, b.data_ptr(), bs, xo.data_ptr(),
                                h.data_ptr(), *_shape_args(x, eps))
    return xo, h


def gated_add(x: torch.Tensor, y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``x + round(gate * y)``, rounded to ``x``'s dtype (module doc)."""
    if not _rows("gated_add", x, y):
        return gated_add_reference(x, y, gate)
    _check_forward_only("gated_add", x, y, gate)
    check_inputs("gated_add", x, y, dtype=torch.bfloat16)
    g, gs = _table("gated_add", gate, x)
    out = torch.empty_like(x)
    if x.numel():
        _gated_add_kernel(x.data_ptr(), y.data_ptr(), g.data_ptr(), gs, out.data_ptr(),
                          *_shape_args(x))
    return out
