"""Gradients of the port's attention and norm+RoPE against the JAX package.

The JAX side is ``jax.vjp`` of ``blade.kernels.block_sparse_attn``'s
``block_sparse_attention`` / ``flash_attention``, which run their Pallas
backward kernels (``_sparse_dq_kernel``, ``_sparse_dkv_kernel``,
``_dense_dq_kernel``, ``_dense_dkv_kernel``) in interpret mode on the CPU;
the port's side is its autograd path on CPU tensors (the plain forward and
``attention_backward_reference``).  Both take a cotangent on ``out`` AND on
``lse``, Lq = Lk = 300 (ragged), d = 128, a bias, and a mask with one empty
row.  f32 on both sides: 1e-5 absolute covers summation order and exp2
against exp on gradients of magnitude <~ 2 (measured ~1e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.kernels import block_sparse_attn as jbsa
from blade.kernels.norm_rope import norm_rope_heads as j_norm_rope_heads
from blade.models.layers import rope_3d_tables
from blade_torch.kernels import ref_attention as tref
from blade_torch.kernels.block_sparse_attn import (
    block_sparse_attention,
    flash_attention,
    flash_attention_wide_v,
)
from blade_torch.kernels.norm_rope import _norm_rope_reference, norm_rope_heads

ATOL = 1e-5


def _inputs(seed, lq=300, lk=300, d=128, h=2):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((1, h, n, d)).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    g_lse = rng.standard_normal((1, h, lq)).astype(np.float32)
    return q, k, v, g, g_lse


def _mask(seed, lq=300, lk=300, h=2):
    n_qt, n_kt = -(-lq // 128), -(-lk // 128)
    mask = np.random.default_rng(seed).random((1, h, n_qt, n_kt)) > 0.4
    mask[..., -1] = True  # the ragged tail block
    mask[0, 1, 1] = False  # one empty row
    return mask


def _port_grads(fn, q, k, v, g, g_lse):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = fn(qt, kt, vt)
    torch.autograd.backward((out, lse), (torch.from_numpy(g), torch.from_numpy(g_lse)))
    return out.detach(), lse.detach(), qt.grad, kt.grad, vt.grad


def _jax_grads(fn, q, k, v, g, g_lse):
    (out, lse), vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (out, lse) + tuple(vjp((jnp.asarray(g), jnp.asarray(g_lse))))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def test_sparse_gradients_match_jax_pallas_backward():
    q, k, v, g, g_lse = _inputs(0)
    mask = _mask(1)
    bias = math.log(3.0)
    want = _jax_grads(lambda a, b, c: jbsa.block_sparse_attention(
        a, b, c, jnp.asarray(mask), bias=bias, interpret=True), q, k, v, g, g_lse)
    got = _port_grads(lambda a, b, c: block_sparse_attention(
        a, b, c, torch.from_numpy(mask), bias=bias), q, k, v, g, g_lse)
    for a, b in zip(got, want):
        _close(a, b)
    # the empty row: out 0, lse -1e30, and no gradient into its queries
    assert float(got[0][0, 1, 128:256].abs().max()) == 0.0
    assert float(got[2][0, 1, 128:256].abs().max()) == 0.0


@pytest.mark.parametrize("lk,bias", [(300, 0.7), (10, math.log(30.0))])
def test_dense_gradients_match_jax_pallas_backward(lk, bias):
    q, k, v, g, g_lse = _inputs(2, lk=lk)
    want = _jax_grads(lambda a, b, c: jbsa.flash_attention(
        a, b, c, bias=bias, interpret=True), q, k, v, g, g_lse)
    got = _port_grads(lambda a, b, c: flash_attention(a, b, c, bias=bias),
                      q, k, v, g, g_lse)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_backward_reference_matches_autograd_of_plain_forward(masked, monkeypatch):
    """The plain backward, chunked over rows, against torch autograd through
    the plain forward (same f32 math): 2e-5 absolute."""
    q, k, v, g, g_lse = (torch.from_numpy(x) for x in _inputs(3, lq=300, lk=260, d=32))
    mask = torch.from_numpy(_mask(4, lq=300, lk=260)) if masked else None
    qa, ka, va = (x.clone().requires_grad_(True) for x in (q, k, v))
    if masked:
        out, lse = tref.block_masked_attention(qa, ka, va, mask, block_k=128, bias=0.3)
    else:
        out, lse = tref.dense_attention_with_lse(qa, ka, va, bias=0.3)
    live = (lse > tref.NEG_INF / 2).float()  # autograd of the empty row's lse is 0
    torch.autograd.backward((out, lse * live), (g, g_lse))
    monkeypatch.setattr(tref, "_CHUNK_ELEMS", 2 * 260 * 128)  # several chunks
    dq, dk, dv = tref.attention_backward_reference(
        q, k, v, out.detach(), lse.detach(), g, g_lse, block_mask=mask, block_k=128,
        scale=1.0 / math.sqrt(32), bias=0.3)
    for a, b in ((dq, qa.grad), (dk, ka.grad), (dv, va.grad)):
        _close(a, b, atol=2e-5)


def test_wide_v_is_forward_only():
    q = torch.randn(1, 1, 16, 32, requires_grad=True)
    pool = torch.zeros(1, 1, 16, 128)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_wide_v(q, q, pool)
    with torch.no_grad():
        flash_attention_wide_v(q, q, pool)


def test_norm_rope_gradients_match_jax_vjp():
    """``dx`` and ``dscale`` of norm+RoPE with d = 128, so JAX takes its fused
    path (Pallas forward, vjp of the XLA reference backward): 1e-4 absolute
    on gradients of magnitude <~ 10 (f32 rsqrt and sums in another order)."""
    rng = np.random.default_rng(5)
    s, dim, heads = 60, 256, 2
    x = rng.standard_normal((1, s, dim)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    cos, sin = rope_3d_tables(128, (3, 4, 5))
    g = rng.standard_normal((1, heads, s, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: j_norm_rope_heads(a, b, jnp.asarray(cos), jnp.asarray(sin),
                                                    heads, interpret=True),
                     jnp.asarray(x), jnp.asarray(scale))
    jdx, jdscale = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    out = norm_rope_heads(xt, st, torch.from_numpy(cos), torch.from_numpy(sin), heads)
    out.backward(torch.from_numpy(g))
    _close(xt.grad, jdx, atol=1e-4)
    _close(st.grad, jdscale, atol=1e-4)
    # the CPU path is the plain version itself
    ref = _norm_rope_reference(xt.detach(), st.detach(), torch.from_numpy(cos),
                               torch.from_numpy(sin), heads, 1e-6)
    torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)
