"""The per-level lane of multi-level attention against the JAX package, on
the CPU: the lane the 14B 720p geometry (591 key blocks) takes, where the
fused lane does not reach.

* The whole lane: the port's ``multilevel_attention(..., fused=False)``
  (plain block-sparse level 1, the plain pooled-level passes over the
  edge-padded pyramid, the f32 LSE merge) against JAX's
  ``multilevel_attention(..., interpret=True, fused=False)``, whose pooled
  levels run the resident-pyramid Pallas kernel (``_vmem_level_kernel``)
  in interpret mode.  Ragged lengths 450 and 1100 (pooled tail rows that mix
  real and edge-repeated tokens), d 64 and 128, and one empty mask row.
* One level at a time: the port's ``pooled_level_attention`` against JAX's
  ``pooled_level_attention(interpret=True)`` at levels 2, 4 and 8 on the
  resident-pyramid kernel, and at levels 2 and 4 on the HBM-gather kernel
  (``_sparse_fwd_kernel``) by setting JAX's ``VMEM_PYRAMID_BUDGET`` to 0
  for the test, as those levels run at the 14B geometry.

Tolerance 3e-5 in f32: JAX's own fused-against-per-level bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.attention import masks as JM
from blade.kernels import multilevel_attn as jml
from blade.kernels.ref_attention import mean_pool_kv
from blade_torch.attention import masks as TM
from blade_torch.kernels import multilevel_attn as tml
from blade_torch.kernels.pack import _records
from blade_torch.kernels.ref_attention import NEG_INF

RATIOS = {1: (0.0, 0.25), 2: (0.25, 0.5), 4: (0.5, 0.75), 8: (0.75, 0.9), 0: (0.9, 1.0)}
TOL = 3e-5


def _qkv(seed, lead, l, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((*lead, l, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("l,d", [(450, 64), (1100, 128)])
def test_per_level_lane_matches_jax(l, d):
    q, k, v = _qkv(l + d, (1, 2), l, d)
    n = -(-l // 128)
    # any level mask will do for the lane; the last block (the ragged tail)
    # is pooled in some rows
    levels = np.random.default_rng(l).choice(np.array([0, 1, 2, 4, 8], np.int32),
                                             (1, 2, n, n))
    levels[0, 0, :, -1] = np.resize([2, 4, 8, 1], n)
    levels[0, 1, 1] = 0  # one empty mask row
    assert set(np.unique(levels)) == {0, 1, 2, 4, 8}
    j_out, j_lse = jml.multilevel_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(levels),
        interpret=True, fused=False)
    assert not tml.fused_supported(d, 257 * 128)
    t_out, t_lse = tml.multilevel_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(levels), fused=False)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=TOL, rtol=TOL)
    assert t_out[0, 1, 128:256].abs().max().item() == 0.0
    assert (t_lse[0, 1, 128:256] <= NEG_INF / 2).all()


@pytest.mark.parametrize("level,budget", [(2, None), (4, None), (8, None), (2, 0), (4, 0)])
def test_pooled_level_matches_jax(monkeypatch, level, budget):
    """Budget 0 sends JAX's pass to the HBM-gather kernel; None keeps the
    resident-pyramid kernel.  A ragged 450-row sequence: the last pooled row
    at level 4 and 8 mixes real and edge-repeated tokens."""
    if budget is not None:
        monkeypatch.setattr(jml, "VMEM_PYRAMID_BUDGET", budget)
    l, d = 450, 64
    q, k, v = _qkv(level, (2,), l, d)
    n = -(-l // 128)
    mask = np.random.default_rng(level + 1).random((2, n, n)) < 0.5
    mask[1, 2] = False  # an empty row
    mask[0, 0] = True  # a row with every block
    kp = JM.pad_to_block_multiple(jnp.asarray(k), 128, axis=1)
    vp = JM.pad_to_block_multiple(jnp.asarray(v), 128, axis=1)
    k_pool, v_pool = mean_pool_kv(kp, level), mean_pool_kv(vp, level)
    qp = jnp.pad(jnp.asarray(q), ((0, 0), (0, n * 128 - l), (0, 0)))
    pvl = -(-l // level)
    j_out, j_lse = jml.pooled_level_attention(
        qp, k_pool, v_pool, jnp.asarray(mask), level=level, scale=d ** -0.5,
        pooled_valid_len=pvl, interpret=True)
    rec = _records(torch.from_numpy(np.array(k_pool)), torch.from_numpy(np.array(v_pool)),
                   128 // level)
    t_out, t_lse = tml.pooled_level_attention(
        torch.from_numpy(q), rec, torch.from_numpy(mask), level=level, scale=d ** -0.5,
        pooled_valid_len=pvl)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out)[:, :l], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[:, :l], atol=TOL, rtol=TOL)
    assert t_out[1, 256:384].abs().max().item() == 0.0
    assert (t_lse[1, 256:384] == NEG_INF).all()


def test_per_level_lane_is_the_default_past_256_blocks():
    """``fused=None`` picks the per-level lane for 257 key blocks (head dim
    32, which the fused lane does not take either); it equals the lane forced
    with ``fused=False`` and refuses a mask that is not at 128-row rows."""
    l, d = 257 * 128 - 40, 32
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, (1, 1), l, d))
    q = q[..., :256, :].contiguous()
    scores = torch.rand(1, 1, 2, 257, generator=torch.Generator().manual_seed(4))
    levels = TM.multilevel_mask(scores, RATIOS)
    out, lse = tml.multilevel_attention(q, k, v, levels)
    want_out, want_lse = tml.multilevel_attention(q, k, v, levels, fused=False)
    torch.testing.assert_close(out, want_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    assert torch.isfinite(out).all() and out.shape == (1, 1, 256, d)
    with pytest.raises(ValueError, match="128-row level mask"):
        tml.multilevel_attention(q, k, v, levels[..., :1, :])
