"""The gradients of the port's ``multilevel_attention`` against ``jax.grad``
of the JAX package's, on the CPU, f32, the same numpy inputs: dQ, dK and dV
of ``sum(sin(out)) + 0.05 * sum(lse)``, the loss of
``tests/test_multilevel_attn.py``.

* The fused lane driven by lists at ``q_rows`` 256, d 64, over a ragged
  ``Lk`` = 901 (not a multiple of 8, so the last pooled row of every level
  mixes the last key with its edge-padded copies), with one empty mask row,
  against JAX's fused lane in interpret mode (its Pallas forward and
  ``gather_backward`` kernels).
* Both lanes from levels and from lists, ``q_rows`` 128 and 256, d 64 and
  128, against ``jax.grad`` of ``multilevel_block_attention_reference``
  (pure jnp; the sequence a multiple of 256).

The port's CPU path runs its autograd Functions with the plain per-pass
backward (four passes against the merged lse, the row repetition, the
un-pooling), not torch autograd through the plain forward.  Tolerance
1e-3 abs/rel, JAX's own for its gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.attention import masks as JM
from blade.attention.asa import _fused_lane_params
from blade.kernels.multilevel_attn import multilevel_attention as j_multilevel
from blade.kernels.ref_attention import multilevel_block_attention_reference
from blade_torch.kernels.multilevel_attn import levels_to_lists
from blade_torch.kernels.multilevel_attn import multilevel_attention as t_multilevel

RATIOS = {1: (0.0, 0.25), 2: (0.25, 0.5), 4: (0.5, 0.75), 8: (0.75, 0.9), 0: (0.9, 1.0)}


def _inputs(l, d, seed):
    rng = np.random.default_rng(seed)
    return rng, [rng.standard_normal((1, 2, l, d)).astype(np.float32) for _ in range(3)]


def _jax_grads(fn, q, k, v):
    def loss(q, k, v):
        out, lse = fn(q, k, v)
        return jnp.sum(jnp.sin(out)) + 0.05 * jnp.sum(lse)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in grads]


def _port_grads(q, k, v, **kw):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = t_multilevel(tq, tk, tv, **kw)
    loss = torch.sin(out).sum() + 0.05 * lse.sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (tq, tk, tv))]


def _assert_grads(got, want):
    for g, w, name in zip(got, want, "qkv"):
        assert np.abs(w).max() > 0.1, name
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-3, err_msg=f"d{name}")


def test_fused_lane_gradients_match_jax_interpret_at_a_ragged_length():
    l, d, q_rows = 901, 64, 256
    rng, (q, k, v) = _inputs(l, d, 0)
    n_kt, n_q = -(-l // 128), -(-l // q_rows)
    cap, _, _ = _fused_lane_params(l, RATIOS)
    idx, cnt = JM.multilevel_lists(jnp.asarray(rng.random((1, 2, n_q, n_kt), np.float32)),
                                   RATIOS, cap=cap)
    cnt = cnt.at[0, 1, 1].set(0)  # one empty row
    want = _jax_grads(lambda q, k, v: j_multilevel(q, k, v, None, lists=(idx, cnt),
                                                   interpret=True, fused=True, q_rows=q_rows),
                      q, k, v)
    got = _port_grads(q, k, v, lists=(torch.from_numpy(np.array(idx)),
                                      torch.from_numpy(np.array(cnt))), q_rows=q_rows)
    _assert_grads(got, want)
    empty = slice(q_rows, 2 * q_rows)
    assert np.abs(got[0][0, 1, empty]).max() == 0.0


@pytest.mark.parametrize("source,q_rows,d,fused", [
    ("levels", 128, 128, None),
    ("lists", 128, 64, None),
    ("lists", 256, 64, None),
    ("lists", 256, 128, None),
    ("levels", 128, 64, False),
    ("levels", 128, 128, False),
])
def test_gradients_match_jax_reference(source, q_rows, d, fused):
    l = 768
    rng, (q, k, v) = _inputs(l, d, q_rows + d)
    n_kt, n_q = l // 128, l // q_rows
    levels = np.array(JM.multilevel_mask(
        jnp.asarray(rng.random((1, 2, n_q, n_kt), np.float32)), RATIOS))
    assert all((levels == lv).any() for lv in (0, 1, 2, 4, 8))
    per_tile = np.repeat(levels, q_rows // 128, axis=2)  # the reference's 128-row mask
    want = _jax_grads(lambda q, k, v: multilevel_block_attention_reference(
        q, k, v, jnp.asarray(per_tile)), q, k, v)
    t_levels = torch.from_numpy(levels)
    kw = (dict(lists=levels_to_lists(t_levels)) if source == "lists"
          else dict(levels=t_levels))
    _assert_grads(_port_grads(q, k, v, q_rows=q_rows, fused=fused, **kw), want)
