"""The port's multilevel lane against the JAX package, on the CPU: the level
masks and per-level lists (bit for bit), the pyramid pack (bit for bit, f32
and bf16) and the plain multi-level attention against the dense multi-level
reference (f32, 1e-5).  The comparisons with JAX's fused Pallas kernel
(interpret mode, ~30 s of compilation a configuration) are in
``test_torch_multilevel_fused.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.attention import masks as JM
from blade.kernels import multilevel_attn as jml
from blade.kernels.pack import pack_kv as j_pack_kv
from blade.kernels.ref_attention import (
    multilevel_block_attention_reference as j_ml_reference,
)
from blade_torch.attention import masks as TM
from blade_torch.kernels import multilevel_attn as tml
from blade_torch.kernels.pack import pack_kv_pyramid
from blade_torch.kernels.ref_attention import (
    multilevel_block_attention_reference as t_ml_reference,
)

RATIOS = {1: (0.0, 0.25), 2: (0.25, 0.5), 4: (0.5, 0.75), 8: (0.75, 0.9), 0: (0.9, 1.0)}


def _scores(seed, shape, ties):
    rng = np.random.default_rng(seed)
    s = rng.random(shape).astype(np.float32)
    if ties:  # coarse values: many ties, which the stable sorts must break alike
        s = np.floor(s * 4) / 4
    return s


@pytest.mark.parametrize("nq,nk,ratios,ties,force", [
    (48, 64, None, False, True),
    (5, 139, None, True, True),
    (70, 139, None, False, True),
    (6, 9, RATIOS, True, True),
    (7, 5, RATIOS, False, False),
    (3, 3, None, True, True),
])
def test_multilevel_masks_and_lists_bit_exact(nq, nk, ratios, ties, force):
    scores = _scores(nq * 1000 + nk, (2, 3, nq, nk), ties)
    want = np.asarray(JM.multilevel_mask(jnp.asarray(scores), ratios, force_last2=force))
    got = TM.multilevel_mask(torch.from_numpy(scores), ratios, force_last2=force)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert TM.multilevel_rank_bands(nk, ratios) == JM.multilevel_rank_bands(nk, ratios)
    cap = -(-nk // 128) * 128
    for c in (cap, nk):
        j_idx, j_cnt = JM.multilevel_lists(jnp.asarray(scores), ratios, cap=c,
                                           force_last2=force)
        t_idx, t_cnt = TM.multilevel_lists(torch.from_numpy(scores), ratios, cap=c,
                                           force_last2=force)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    # the lists are the level mask, level by level
    hits = TM.multilevel_lists(torch.from_numpy(scores), ratios, cap=nk, force_last2=force)
    for li, level in enumerate((1, 2, 4, 8)):
        idx, cnt = TM.mask_to_block_lists(got == level)
        np.testing.assert_array_equal(hits[1][..., li].numpy(), cnt.numpy())


@pytest.mark.parametrize("bh,lk,d,dtype", [
    (3, 300, 64, np.float32),
    (2, 450, 128, np.float32),
    (1, 17776, 64, np.float32),
    (2, 256, 64, jnp.bfloat16),
])
def test_pyramid_pack_matches_jax(bh, lk, d, dtype):
    """Edge padding, chained f32 pooling and one rounding a level: the
    plain pyramid pack equals JAX's ``pack_kv(pyramid=True)`` (row-packed
    records; JAX's zero records past its 16-block chunk are not kept)."""
    rng = np.random.default_rng(lk + d)
    k = rng.standard_normal((bh, lk, d)).astype(np.float32)
    v = rng.standard_normal((bh, lk, d)).astype(np.float32)
    kj = JM.pad_to_block_multiple(jnp.asarray(k, dtype), 128, axis=1)
    vj = JM.pad_to_block_multiple(jnp.asarray(v, dtype), 128, axis=1)
    want = j_pack_kv(kj, vj, lane_pack=False, pyramid=True, interpret=True)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = pack_kv_pyramid(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt))
    n_kt = -(-lk // 128)
    for level, g, w in zip((1, 2, 4, 8), got, want):
        rows = 2 * n_kt * 128 // level
        assert g.shape == (bh, rows, d)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w[:, :rows], np.float32),
                                      err_msg=f"level {level}")


def _qkv(seed, h, l, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, l, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("l,d,q_rows", [(512, 64, 128), (1024, 64, 256), (768, 128, 256),
                                        (640, 128, 128)])
def test_plain_multilevel_matches_jax_reference(l, d, q_rows):
    """Lists at ``q_rows`` granularity == JAX's dense multi-level reference
    over the 128-row level mask with each row repeated (f32, 1e-5)."""
    q, k, v = _qkv(l + d, 2, l, d)
    nk = l // 128
    scores = _scores(l * d, (1, 2, l // q_rows, nk), False)
    levels = JM.multilevel_mask(jnp.asarray(scores), RATIOS)
    levels128 = jnp.repeat(levels, q_rows // 128, axis=-2)
    want_out, want_lse = j_ml_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        levels128)
    lists = TM.multilevel_lists(torch.from_numpy(scores), RATIOS, cap=128)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tml.multilevel_attention(tq, tk, tv, lists=lists, q_rows=q_rows)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)
    # the int-mask entry point and the port's own dense reference agree
    out_m, lse_m = tml.multilevel_attention(tq, tk, tv, torch.from_numpy(np.array(levels)),
                                            q_rows=q_rows)
    np.testing.assert_allclose(out_m.numpy(), out.numpy(), atol=1e-6, rtol=1e-6)
    ref_out, ref_lse = t_ml_reference(tq, tk, tv, torch.from_numpy(np.array(levels128)))
    np.testing.assert_allclose(ref_out.numpy(), np.asarray(want_out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ref_lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)


def test_fused_supported_matches_jax_and_unsupported_raises():
    for d in (32, 64, 128, 256):
        for lk in (128, 17776, 32760, 32768, 32769, 75600):
            for itemsize in (2, 4):
                assert tml.fused_supported(d, lk, itemsize) == \
                    jml.fused_supported(d, lk, itemsize), (d, lk, itemsize)
    # past 256 key blocks the per-level lane runs; it takes no lists and
    # only 128-row mask rows, as in JAX
    q = torch.zeros(1, 1, 128, 64)
    k = torch.zeros(1, 1, 257 * 128, 64)
    with pytest.raises(ValueError, match="require the fused lane"):
        tml.multilevel_attention(q, k, k, lists=(None, None))
    with pytest.raises(ValueError, match="q_rows != 128"):
        tml.multilevel_attention(q, k, k, torch.ones(1, 1, 1, 257, dtype=torch.int32),
                                 q_rows=256)
    with pytest.raises(ValueError, match="require the fused lane"):
        tml.multilevel_attention(q, q, q, lists=(None, None), fused=False)
    # the lane is differentiable (the gradients: test_torch_multilevel_grad.py)
    qg = torch.randn(1, 1, 256, 64, requires_grad=True)
    lists = TM.multilevel_lists(torch.rand(1, 1, 2, 2), cap=128)
    out_g, lse_g = tml.multilevel_attention(qg, qg, qg, lists=lists)
    assert out_g.requires_grad and lse_g.requires_grad
    (grad,) = torch.autograd.grad(out_g.sum() + lse_g.sum(), qg)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    with torch.no_grad():
        out, lse = tml.multilevel_attention(qg, qg, qg, lists=lists)
    assert out.shape == (1, 1, 256, 64) and lse.shape == (1, 1, 256)
    assert torch.equal(out, out_g) and torch.equal(lse, lse_g)


def test_empty_row_and_forced_rows():
    """A row with every count 0 gives out 0 and lse -1e30; the forced last
    two rows attend at level 1 to every key (== dense attention there)."""
    from blade_torch.kernels.ref_attention import NEG_INF, dense_attention_with_lse

    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 2, 600, 64))
    lists = TM.multilevel_lists(torch.rand(1, 2, 5, 5, generator=torch.Generator()
                                           .manual_seed(1)), RATIOS, cap=128)
    idx, cnt = lists[0].clone(), lists[1].clone()
    cnt[0, 1, 1] = 0
    out, lse = tml.multilevel_attention(q, k, v, lists=(idx, cnt), q_rows=128)
    assert out[0, 1, 128:256].abs().max().item() == 0.0
    assert (lse[0, 1, 128:256] == NEG_INF).all()
    dense_out, dense_lse = dense_attention_with_lse(q, k, v)
    torch.testing.assert_close(out[..., 384:, :], dense_out[..., 384:, :], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(lse[..., 384:], dense_lse[..., 384:], atol=1e-5, rtol=1e-5)
