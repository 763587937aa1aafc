"""The glue around the port's attention backward kernels against the JAX package.

* ``attention_delta`` (``delta = rowsum(dO * O)``, on the card
  ``bt_attn_delta``) on CPU tensors takes its plain version; it is held
  against JAX's own expression (``jnp.sum(g.astype(f32) * o.astype(f32),
  -1)``, as ``blade/kernels/block_sparse_attn.py::_bwd_call`` computes it)
  on the same values, bf16 and f32 inputs, ragged row counts, d 64 and 128.
  Tolerance: 1e-5 of each row's sum of |dO * O| (f32 sums in another order).
* ``backward_lists`` (the sparse backward's lists of a block mask and of its
  transpose, which the dQ and dK/dV kernels walk) equals
  ``blade.attention.masks.mask_to_block_lists`` of the mask and of its
  transpose bit for bit, with empty rows, key blocks no row selected,
  full rows and ragged block counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.attention.masks import mask_to_block_lists as j_mask_to_block_lists
from blade_torch.kernels import _build
from blade_torch.kernels.block_sparse_attn import attention_delta, backward_lists


@pytest.mark.parametrize("shape,d,dtype", [
    ((1, 2, 300), 128, "bfloat16"),
    ((2, 3, 17), 64, "bfloat16"),
    ((4, 1001), 64, "float32"),
    ((1, 12, 130), 128, "float32"),
])
def test_delta_matches_jax(shape, d, dtype):
    rng = np.random.default_rng(sum(shape) + d)
    o, g = (rng.standard_normal((*shape, d)).astype(np.float32) for _ in range(2))
    to, tg = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (o, g))
    jo, jg = (jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)) for t in (to, tg))
    want = np.asarray(jnp.sum(jg.astype(jnp.float32) * jo.astype(jnp.float32), -1))
    before = _build.KERNELS["attn_delta"].launches
    got = attention_delta(to, tg)
    assert _build.KERNELS["attn_delta"].launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == tuple(shape)
    bound = 1e-5 * np.abs(to.float().numpy() * tg.float().numpy()).sum(-1)
    assert (np.abs(got.numpy() - want) <= bound).all()


@pytest.mark.parametrize("bh,n_qt,n_kt,keep", [
    (2, 3, 3, 0.6),
    (3, 9, 9, 0.9),
    (2, 5, 3, 0.3),
    (1, 4, 7, 0.05),
    (2, 11, 2, 1.0),
])
def test_backward_lists_match_jax(bh, n_qt, n_kt, keep):
    rng = np.random.default_rng(bh * 100 + n_qt * 10 + n_kt)
    mask = rng.random((bh, n_qt, n_kt)) < keep
    mask[0, 0] = False  # an empty row
    mask[-1, :, 0] = False  # a key block that no row selected
    mask[-1, -1] = True  # a full row
    got = backward_lists(torch.from_numpy(mask))
    want = (*j_mask_to_block_lists(jnp.asarray(mask)),
            *j_mask_to_block_lists(jnp.asarray(mask.transpose(0, 2, 1))))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
