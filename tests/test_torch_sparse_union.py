"""The union-gathered sparse forward (``SPARSE_UNION``) against the JAX
package, on the CPU.

``masks.union_block_lists`` must match JAX's bit for bit (indices, counts
and validity bits, list tails included), with and without the bounded
``topk`` lane.  ``block_sparse_attention`` with the flag set runs the plain
version of the union kernel on the lists the port builds, against JAX's
``block_sparse_attention`` with its flag set and its Pallas union kernel in
interpret mode: f32 both sides, 2e-5 (JAX's own tolerance for that path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blade.kernels.block_sparse_attn as JBSA
from blade.attention import masks as jmasks
from blade_torch.attention import masks as tmasks
from blade_torch.kernels import block_sparse_attn as TBSA

ATOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_lists_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bound", [None, 6, 40])
def test_union_block_lists_bit_exact(bound):
    """Random masks with an empty and a full row; ``bound`` 6 lets rows over
    it through (identity lists), 40 is past n_k (the argsort lane)."""
    mask = np.random.default_rng(3).random((2, 3, 10, 16)) < 0.3
    mask[0, 1, 4] = False
    mask[0, 1, 5] = False  # an empty union row
    mask[1, 2, 7] = True  # a full row
    want = jmasks.union_block_lists(jnp.asarray(mask), group=2, bound=bound)
    got = tmasks.union_block_lists(_t(mask), group=2, bound=bound)
    _assert_lists_equal(got, want)
    assert got[1][0, 1, 2] == 0


def test_union_block_lists_bounded_lane_on_energy_masks():
    """The bound the energy lane passes: the clamp bounds every union row
    except the forced fully-on last two rows, which exceed it."""
    rng = np.random.default_rng(4)
    nk = 64
    scores = rng.random((1, 3, 16, nk)).astype(np.float32) ** 4
    scores /= scores.sum(-1, keepdims=True)
    mask = np.asarray(jmasks.energy_mask(scores, min_retain_ratio=0.05,
                                         max_retain_ratio=0.2))
    bound = 2 * (int(nk * 0.2) + 2)
    want = jmasks.union_block_lists(jnp.asarray(mask), group=2, bound=bound)
    got = tmasks.union_block_lists(_t(mask), group=2, bound=bound)
    _assert_lists_equal(got, want)
    assert (got[1][..., -1] == nk).all() and (got[1][..., :-1] <= bound).all()


def _qkv(seed, lq, lk, d, h=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, h, n, d)).astype(np.float32) for n in (lq, lk, lk))


def _jax_union(q, k, v, mask, bound=None):
    old = JBSA.SPARSE_UNION
    try:
        JBSA.SPARSE_UNION = True
        return JBSA.block_sparse_attention(q, k, v, jnp.asarray(mask), interpret=True,
                                           union_bound=bound)
    finally:
        JBSA.SPARSE_UNION = old


def _port(q, k, v, mask, union, bound=None, grad=False):
    old = TBSA.SPARSE_UNION
    try:
        TBSA.SPARSE_UNION = union
        qt, kt, vt = (_t(a).requires_grad_(grad) for a in (q, k, v))
        out, lse = TBSA.block_sparse_attention(qt, kt, vt, _t(mask), union_bound=bound)
        if not grad:
            return out, lse
        (out.square().sum() + lse.sum()).backward()
        return out, lse, (qt.grad, kt.grad, vt.grad)
    finally:
        TBSA.SPARSE_UNION = old


@pytest.mark.parametrize("lq,lk,d", [(384, 500, 64), (300, 256, 128), (384, 512, 128)])
def test_union_forward_matches_jax(lq, lk, d):
    """An odd mask-row count (3), ragged keys and an empty row (head 1, mask
    row 1, whose pair partner selects blocks).  JAX's union kernel gives
    such a row out NaN and lse +inf at d = 64's scale 1/8 (its result hangs
    on how -1e30 * scale * log2(e) rounds; at 1/sqrt(128) it is out 0, lse
    -1e30), so at d = 64 the empty row is held to the empty-row contract and
    the other rows to JAX."""
    q, k, v = _qkv(lq + d, lq, lk, d)
    n_qt, n_kt = -(-lq // 128), -(-lk // 128)
    mask = np.random.default_rng(lk).random((1, 2, n_qt, n_kt)) < 0.5
    mask[..., 0] = True
    mask[0, 1, 1] = False  # an empty row
    jout, jlse = (np.asarray(a) for a in _jax_union(q, k, v, mask))
    out, lse = (a.numpy() for a in _port(q, k, v, mask, union=True))
    keep = np.ones(lq, bool)
    if d < 128:
        keep[128:256] = False
        assert not np.isfinite(jout[0, 1, 128:256]).any()
    np.testing.assert_allclose(out[..., keep, :], jout[..., keep, :], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse[..., keep], jlse[..., keep], atol=ATOL, rtol=0)
    assert np.abs(out[0, 1, 128:256]).max() == 0.0
    assert (lse[0, 1, 128:256] == -1e30).all()


def test_union_forward_with_bound_on_an_energy_mask():
    """The energy lane's call: its mask and its union bound."""
    q, k, v = _qkv(9, 1100, 1100, 64)
    rng = np.random.default_rng(10)
    scores = rng.random((1, 2, 9, 9)).astype(np.float32) ** 4
    mask = np.asarray(jmasks.energy_mask(scores / scores.sum(-1, keepdims=True),
                                         min_retain_ratio=0.05, max_retain_ratio=0.2))
    bound = 2 * (max(int(9 * 0.2), 1) + 2)
    assert bound < 9
    jout, jlse = _jax_union(q, k, v, mask, bound)
    out, lse = _port(q, k, v, mask, union=True, bound=bound)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL, rtol=0)


def test_union_flag_changes_the_forward_path_only():
    """Out, lse and the gradients of the union path equal the row path's (the
    backward rebuilds the plain lists from the mask, as in JAX)."""
    q, k, v = _qkv(11, 300, 390, 64)
    mask = np.random.default_rng(12).random((1, 2, 3, 4)) < 0.5
    mask[0, 0, 2] = False
    union = _port(q, k, v, mask, union=True, grad=True)
    rows = _port(q, k, v, mask, union=False, grad=True)
    torch.testing.assert_close(union[0], rows[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(union[1], rows[1], atol=1e-6, rtol=0)
    for a, b in zip(union[2], rows[2]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert TBSA.SPARSE_UNION is False and TBSA.QGROUP == JBSA.QGROUP == 2


def test_union_lists_pad_an_odd_row_count():
    mask = torch.rand(2, 5, 7) < 0.4
    entries, counts = TBSA._union_lists(mask, None)
    assert entries.shape == (2, 3, 7) and counts.shape == (2, 3)
    bits = entries >> 16
    live = torch.arange(7) < counts[..., None]
    assert ((bits[:, 2] & 2) == 0).all()  # the padded row selects nothing
    assert ((bits[live] > 0)).all()  # every listed block is some row's


def _forced_rows_mask(rng, lead, n_q, n_k, p):
    """A random mask whose last two rows select every block, as both ASA
    lanes force them."""
    mask = rng.random((*lead, n_q, n_k)) < p
    mask[..., -2:, :] = True
    return mask


def _row_walks(entries, counts):
    """What the union walk's CTA of mask row 2 i + r takes: the blocks of
    the pair's first ``counts`` entries whose bit r is set, in list order."""
    walks = []
    for i, (row, cnt) in enumerate(zip(entries.tolist(), counts.tolist())):
        for r in range(TBSA.QGROUP):
            walks.append([e & 0xFFFF for e in row[:cnt] if (e >> (16 + r)) & 1])
    return walks


@pytest.mark.parametrize("kind,bound", [
    ("random", None), ("random", "tight"), ("energy", None), ("energy", "lane"),
])
@pytest.mark.parametrize("n_q", [9, 10])
def test_union_walk_takes_exactly_each_rows_blocks(kind, bound, n_q):
    """The invariant the union kernel's walk relies on: in each pair's list
    (built by ``_union_lists``, an odd row count padded with an empty row),
    the entries whose bit r is set are mask row 2 i + r's selected blocks,
    ascending; the pad row takes none.  With a bound, the pairs over it
    (the forced full rows) are rewritten as identity lists and still give
    every row its own blocks.  The lists equal ``blade``'s
    ``union_block_lists`` on the same padded mask."""
    rng = np.random.default_rng(n_q + (kind == "energy"))
    n_k = 24
    if kind == "random":
        mask = _forced_rows_mask(rng, (2, 3), n_q, n_k, 0.3)
        mask[0, 1, 2] = False  # an empty row beside a partner that selects blocks
    else:
        scores = rng.random((2, 3, n_q, n_k)).astype(np.float32) ** 4
        mask = np.asarray(jmasks.energy_mask(scores / scores.sum(-1, keepdims=True),
                                             min_retain_ratio=0.05, max_retain_ratio=0.2))
    bh_mask = mask.reshape(6, n_q, n_k)
    padded = np.concatenate([bh_mask, np.zeros((6, n_q % 2, n_k), bool)], axis=1)
    union = padded.reshape(6, -1, 2, n_k).any(axis=2).sum(-1)
    if bound == "tight":  # the largest union a pair without a forced row makes
        bound = int(union[union < n_k].max())
    elif bound == "lane":
        bound = 2 * (int(n_k * 0.2) + 2)
    entries, counts = TBSA._union_lists(_t(bh_mask), bound)
    idx, cnt, bits = jmasks.union_block_lists(jnp.asarray(padded), group=2, bound=bound)
    np.testing.assert_array_equal(entries.numpy(),
                                  np.asarray(idx) | (np.asarray(bits) << 16))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(cnt))
    if bound is not None:  # the pairs with a forced row: identity lists
        assert bound < n_k and (counts[:, -1] == n_k).all()
        assert ((counts.numpy() <= bound) | (union == n_k)).all()
    for h in range(6):
        walks = _row_walks(entries[h], counts[h])
        assert len(walks) == padded.shape[1]
        for row, walk in enumerate(walks):
            assert walk == np.flatnonzero(padded[h, row]).tolist(), (h, row)
    assert walks[-1] == [] or n_q % 2 == 0
