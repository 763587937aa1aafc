"""The per-level multilevel lane's gradients against ``jax.grad`` of the JAX
package's per-level lane in interpret mode (its binary sparse backward and
the three pooled ``gather_backward`` passes, each against its level's own
lse, merged by XLA autodiff), on the CPU, f32: d 128 over a ragged ``Lk`` =
645 (not a multiple of 8), loss ``sum(sin(out)) + 0.05 * sum(lse)``,
tolerance 1e-3 abs/rel.  And the plain pooled backward
(``pooled_level_backward_reference``, the kernels' plain version) against
torch autograd of the plain pooled forward at every level, with a
non-zero LSE cotangent, a ragged pooled tail and an empty mask row.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.attention import masks as JM
from blade.kernels.multilevel_attn import multilevel_attention as j_multilevel
from blade_torch.kernels.multilevel_attn import multilevel_attention as t_multilevel
from blade_torch.kernels.ref_attention import (
    pooled_level_attention_reference,
    pooled_level_backward_reference,
)

RATIOS = {1: (0.0, 0.25), 2: (0.25, 0.5), 4: (0.5, 0.75), 8: (0.75, 0.9), 0: (0.9, 1.0)}


def test_per_level_lane_gradients_match_jax_interpret_at_a_ragged_length():
    l, d = 645, 128
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, l, d)).astype(np.float32) for _ in range(3))
    n_kt = -(-l // 128)
    levels = JM.multilevel_mask(jnp.asarray(rng.random((1, 2, n_kt, n_kt), np.float32)),
                                RATIOS)

    def loss(q, k, v):
        out, lse = j_multilevel(q, k, v, levels, interpret=True, fused=False)
        return jnp.sum(jnp.sin(out)) + 0.05 * jnp.sum(lse)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = t_multilevel(tq, tk, tv, torch.from_numpy(np.array(levels)), fused=False)
    got = torch.autograd.grad(torch.sin(out).sum() + 0.05 * lse.sum(), (tq, tk, tv))
    for g, w, name in zip(got, want, "qkv"):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.1, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3, rtol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("level", [2, 4, 8])
def test_plain_pooled_backward_matches_autograd(level):
    g = torch.Generator().manual_seed(level)
    bh, lq, n_kt, d, seg = 2, 300, 5, 64, 128 // level
    pvl = -(-(n_kt * 128 - 77) // level)  # a ragged tail of dead pooled rows
    q = torch.randn(bh, lq, d, generator=g, requires_grad=True)
    k_pool = torch.randn(bh, n_kt * seg, d, generator=g, requires_grad=True)
    v_pool = torch.randn(bh, n_kt * seg, d, generator=g, requires_grad=True)
    mask = torch.rand(bh, -(-lq // 128), n_kt, generator=g) < 0.5
    mask[0, 1] = False  # an empty row
    mask[1, 0] = True  # a row selecting every block
    kw = dict(level=level, scale=1.0 / math.sqrt(d), pooled_valid_len=pvl)
    out, lse = pooled_level_attention_reference(q, k_pool, v_pool, mask, **kw)
    g_out, g_lse = torch.randn(out.shape, generator=g), torch.randn(lse.shape, generator=g)
    live = lse > -1e29  # autograd's lse of an empty row is a constant
    want = torch.autograd.grad((out * g_out).sum() + (lse * g_lse * live).sum(),
                               (q, k_pool, v_pool))
    got = pooled_level_backward_reference(q.detach(), k_pool.detach(), v_pool.detach(),
                                          out.detach(), lse.detach(), g_out, g_lse, mask,
                                          **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert got[0][0, 128:256].abs().max() == 0 and got[1][:, pvl:].abs().max() == 0
