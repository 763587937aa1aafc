"""CogVideoX's q/k lane in one kernel: per-head LayerNorm, rotate-half RoPE
on the video rows only, and the head split, for q and k together.

``qk_norm_rope(q_proj, k_proj, q_weight, q_bias, k_weight, k_bias, cos, sin,
num_heads, vid_start, n_vid)`` takes the two projection outputs
``[B, L, H*d]`` and gives ``q, k [B, H, L, d]``: for each head row
``LayerNorm(x) * weight + bias`` in f32, rounded to the projections' dtype;
on rows ``vid_start .. vid_start + n_vid - 1`` then rotate-half RoPE by the
tables ``cos``/``sin [n_vid, d/2]`` in f32, rounded again.  The channels
arrive de-interleave-permuted (``layers.deinterleave_perm``, folded into
``to_q``/``to_k`` and the norms' weight and bias), so rotate-half equals the
checkpoint's interleaved-pair RoPE.  Which rows are video is an argument,
so one call serves ``[text, video]`` and ASA's ``[video, text]``.

The plain version, ``_qk_norm_rope_reference``, is the composition the
JAX model writes (``blade/models/cogvideox_dit.py:137-151``: no Pallas
kernel) and CPU tensors take it.  CUDA tensors launch
``csrc/qk_norm_rope.cu``: the forward kernel, and for the input gradient the
dx kernel (the rotation by -theta, both bf16 roundings passed as autograd
passes them, LayerNorm's input gradient in f32).  The gradient of the
norms' weight and bias, needed only when they are trained, is autograd
through the plain version, recomputed in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from blade_torch.kernels._build import CudaKernel, check_inputs, cuda_stream
from blade_torch.models.layers import apply_rope_half

__all__ = ["qk_norm_rope"]

HEAD_DIM = 64  # the kernels' head width (CogVideoX's)

_fwd_kernel = CudaKernel(
    "qk_norm_rope", "bt_qk_norm_rope", "ppppppppppiiiiifp",
    source="blade_torch/csrc/qk_norm_rope.cu",
    replaces="blade/models/cogvideox_dit.py:137",  # q/k LayerNorm + video RoPE (XLA)
)
_dx_kernel = CudaKernel(
    "qk_norm_rope_dx", "bt_qk_norm_rope_dx", "ppppppppppiiiiifp",
    source="blade_torch/csrc/qk_norm_rope.cu",
    replaces="blade/models/cogvideox_dit.py:137",  # its gradient (XLA autodiff)
)


def _qk_norm_rope_reference(q_proj, k_proj, q_weight, q_bias, k_weight, k_bias, cos, sin,
                            num_heads, vid_start, n_vid, eps):
    """Plain version: head split, LayerNorm in f32, cast, RoPE on the video
    rows by slices and ``cat``."""
    b, l, dim = q_proj.shape
    d = dim // num_heads
    vid_end = vid_start + n_vid

    def one(x, weight, bias):
        t = x.reshape(b, l, num_heads, d).transpose(1, 2)
        t = F.layer_norm(t.float(), (d,), weight.float(), bias.float(), eps).to(x.dtype)
        t_vid = apply_rope_half(t[:, :, vid_start:vid_end], cos, sin)
        return torch.cat([t[:, :, :vid_start], t_vid, t[:, :, vid_end:]], dim=2)

    return one(q_proj, q_weight, q_bias), one(k_proj, k_weight, k_bias)


def _launch_args(x, num_heads, vid_start, n_vid, eps):
    b, l, _ = x.shape
    return b, l, num_heads, vid_start, n_vid, float(eps), cuda_stream(x.device)


def _qk_cuda(q_proj, k_proj, q_weight, q_bias, k_weight, k_bias, cos, sin, num_heads,
             vid_start, n_vid, eps):
    b, l, _ = q_proj.shape
    q = torch.empty((b, num_heads, l, HEAD_DIM), dtype=q_proj.dtype, device=q_proj.device)
    k = torch.empty_like(q)
    _fwd_kernel(q_proj.data_ptr(), k_proj.data_ptr(), q_weight.data_ptr(), q_bias.data_ptr(),
                k_weight.data_ptr(), k_bias.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                q.data_ptr(), k.data_ptr(), *_launch_args(q_proj, num_heads, vid_start, n_vid,
                                                          eps))
    return q, k


def _qk_dx_cuda(gq, gk, q_proj, k_proj, q_weight, k_weight, cos, sin, num_heads, vid_start,
                n_vid, eps):
    check_inputs("qk_norm_rope", gq, gk, dtype=torch.bfloat16)
    dq, dk = torch.empty_like(q_proj), torch.empty_like(k_proj)
    _dx_kernel(gq.data_ptr(), gk.data_ptr(), q_proj.data_ptr(), k_proj.data_ptr(),
               q_weight.data_ptr(), k_weight.data_ptr(), cos.data_ptr(), sin.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), *_launch_args(q_proj, num_heads, vid_start, n_vid,
                                                          eps))
    return dq, dk


class _QkNormRope(torch.autograd.Function):
    """The forward kernel; backward: the dx kernel for the projections, the
    plain version's vjp for the norms' weight and bias when asked."""

    @staticmethod
    def forward(ctx, q_proj, k_proj, q_weight, q_bias, k_weight, k_bias, cos, sin, num_heads,
                vid_start, n_vid, eps):
        ctx.save_for_backward(q_proj, k_proj, q_weight, q_bias, k_weight, k_bias, cos, sin)
        ctx.args = (num_heads, vid_start, n_vid, eps)
        return _qk_cuda(q_proj, k_proj, q_weight, q_bias, k_weight, k_bias, cos, sin,
                        num_heads, vid_start, n_vid, eps)

    @staticmethod
    def backward(ctx, gq, gk):
        q_proj, k_proj, q_weight, q_bias, k_weight, k_bias, cos, sin = ctx.saved_tensors
        need = ctx.needs_input_grad
        gq, gk = gq.contiguous(), gk.contiguous()
        dq = dk = None
        if need[0] or need[1]:
            dq, dk = _qk_dx_cuda(gq, gk, q_proj, k_proj, q_weight, k_weight, cos, sin,
                                 *ctx.args)
        dparams = [None] * 4
        if any(need[2:6]):
            with torch.enable_grad():
                params = [p.detach().requires_grad_(n)
                          for p, n in zip((q_weight, q_bias, k_weight, k_bias), need[2:6])]
                outs = _qk_norm_rope_reference(q_proj.detach(), k_proj.detach(), *params, cos,
                                               sin, *ctx.args)
                wanted = [i for i, p in enumerate(params) if p.requires_grad]
                grads = torch.autograd.grad(outs, [params[i] for i in wanted], (gq, gk))
            for i, g in zip(wanted, grads):
                dparams[i] = g
        return (dq if need[0] else None, dk if need[1] else None, *dparams,
                None, None, None, None, None, None)


def qk_norm_rope(
    q_proj: torch.Tensor,
    k_proj: torch.Tensor,
    q_weight: torch.Tensor,
    q_bias: torch.Tensor,
    k_weight: torch.Tensor,
    k_bias: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    vid_start: int,
    n_vid: int,
    *,
    eps: float = 1e-6,
):
    """``q_proj``, ``k_proj [B, L, H*d]`` (bf16 on the card), the norms'
    ``weight``/``bias [d]``, ``cos``/``sin [n_vid, d/2]`` f32 -> ``(q, k)``,
    each ``[B, H, L, d]`` in the projections' dtype; differentiable in the
    projections and the norms' parameters.  On the card ``d`` is 64."""
    b, l, dim = q_proj.shape
    if k_proj.shape != q_proj.shape or num_heads <= 0 or dim % num_heads:
        raise ValueError(f"qk_norm_rope: bad shapes q {tuple(q_proj.shape)}, "
                         f"k {tuple(k_proj.shape)}, heads {num_heads}")
    d = dim // num_heads
    if any(p.shape != (d,) for p in (q_weight, q_bias, k_weight, k_bias)):
        raise ValueError(f"qk_norm_rope: the norms' weight and bias must be [{d}]")
    if not (0 <= vid_start and 0 <= n_vid and vid_start + n_vid <= l):
        raise ValueError(f"qk_norm_rope: video rows {vid_start}+{n_vid} outside {l}")
    if cos.shape != (n_vid, d // 2) or sin.shape != (n_vid, d // 2):
        raise ValueError(f"qk_norm_rope: tables must be [{n_vid}, {d // 2}]")
    if not q_proj.is_cuda:
        return _qk_norm_rope_reference(q_proj, k_proj, q_weight, q_bias, k_weight, k_bias,
                                       cos, sin, num_heads, vid_start, n_vid, eps)
    if d != HEAD_DIM or num_heads > 64:
        raise ValueError(f"qk_norm_rope: the kernel takes heads of {HEAD_DIM}, at most 64 "
                         f"(d={d}, heads={num_heads})")
    params = [p.float() for p in (q_weight, q_bias, k_weight, k_bias)]
    check_inputs("qk_norm_rope", q_proj, k_proj, dtype=torch.bfloat16)
    check_inputs("qk_norm_rope", *params, cos, sin, dtype=torch.float32)
    return _QkNormRope.apply(q_proj, k_proj, *params, cos, sin, num_heads, vid_start, n_vid,
                             float(eps))
