"""``heads_pack`` / ``heads_unpack`` of the port against the JAX package, on
the CPU: the ``[B, S, H*d] <-> [B, H, S, d]`` relayouts are bit exact
(JAX's Pallas copies in interpret mode), each other's inverse, and each
other's gradient (a relayout's vjp is its inverse).  No tolerance: copies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.kernels.norm_rope import heads_pack as j_heads_pack
from blade.kernels.norm_rope import heads_unpack as j_heads_unpack
from blade_torch.kernels.norm_rope import heads_pack, heads_unpack


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heads_pack_unpack_match_jax_bit_exact(dtype):
    """JAX's Pallas path needs d % 128 == 0 and a row tile of S (64 here)."""
    x = np.random.default_rng(0).standard_normal((2, 64, 3 * 128)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    want = j_heads_pack(jx, 3, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = heads_pack(tx, 3)
    assert got.shape == (2, 3, 64, 128) and got.dtype == tx.dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    back = heads_unpack(got)
    np.testing.assert_array_equal(
        back.float().numpy(), np.asarray(j_heads_unpack(want, interpret=True), np.float32))
    assert torch.equal(back, tx)


@pytest.mark.parametrize("b,s,h,d,dtype", [
    (1, 7, 3, 5, torch.float32),   # no tile of JAX's: any shape
    (2, 1, 1, 8, torch.bfloat16),
    (1, 33, 4, 6, torch.float16),
    (1, 9, 2, 3, torch.int8),
])
def test_heads_pack_any_shape_round_trip(b, s, h, d, dtype):
    x = (torch.arange(b * s * h * d) % 101).to(dtype).reshape(b, s, h * d)
    packed = heads_pack(x, h)
    assert torch.equal(packed, x.reshape(b, s, h, d).transpose(1, 2))
    assert torch.equal(heads_unpack(packed), x)


def test_heads_pack_unpack_gradients_are_each_others_transpose():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 10, 4 * 6, generator=g, requires_grad=True)
    w = torch.randn(2, 4, 10, 6, generator=g)
    (heads_pack(x, 4) * w).sum().backward()
    assert torch.equal(x.grad, heads_unpack(w))
    p = torch.randn(2, 4, 10, 6, generator=g, requires_grad=True)
    u = torch.randn(2, 10, 24, generator=g)
    (heads_unpack(p) * u).sum().backward()
    assert torch.equal(p.grad, heads_pack(u, 4))
    # and JAX's custom VJP pair gives the same
    jx = jnp.asarray(np.tile(x.detach().numpy(), (1, 7, 16))[:, :64, :384])
    jg = jax.grad(lambda a: jnp.sum(j_heads_pack(a, 3, interpret=True) ** 2))(jx)
    tx = torch.from_numpy(np.array(jx)).requires_grad_(True)
    (heads_pack(tx, 3) ** 2).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))


def test_heads_pack_rejects_bad_shapes():
    with pytest.raises(ValueError):
        heads_pack(torch.zeros(1, 4, 10), 3)
    with pytest.raises(ValueError):
        heads_unpack(torch.zeros(4, 10, 2))
