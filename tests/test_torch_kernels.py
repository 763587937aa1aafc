"""The port's kernel modules against the JAX package, on the CPU.

Each module that holds a CUDA kernel is checked through its plain PyTorch
version (the path CPU tensors take) against the JAX function on the same
numpy-seeded inputs; the JAX side runs its Pallas kernels in interpret mode.
Tolerances: f32 on both sides, so 2e-5 absolute on outputs of magnitude
<= ~3 covers summation-order and exp2-vs-exp differences; ``pack_kv`` is a
pure copy and compared bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.kernels import block_sparse_attn as jbsa
from blade.kernels import ref_attention as jref
from blade.kernels.norm_rope import norm_rope_heads as j_norm_rope_heads
from blade.kernels.pack import pack_kv as j_pack_kv
from blade.models.layers import deinterleave_perm, rope_3d_tables
from blade_torch.kernels import _build, adaln, ref_attention as tref
from blade_torch.kernels import block_sparse_attn as tbsa
from blade_torch.kernels.block_sparse_attn import (
    block_sparse_attention,
    flash_attention,
    flash_attention_wide_v,
)
from blade_torch.attention.masks import multilevel_lists
from blade_torch.kernels.multilevel_attn import multilevel_attention
from blade_torch.kernels.norm_rope import (
    _norm_rope_reference,
    heads_pack,
    heads_unpack,
    norm_rope_heads,
)
from blade_torch.kernels.pack import pack_kv, pack_kv_pyramid
from blade_torch.kernels.pooled_predictor import pooled_scores
from blade_torch.kernels.qk_norm_rope import qk_norm_rope

ATOL = 2e-5


def _qkv(seed, b, h, lq, lk, d, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, dv or d)).astype(np.float32)
    return q, k, v


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def test_ref_dense_matches_jax_with_bias():
    q, k, v = _qkv(0, 1, 2, 70, 90, 32)
    jo, jl = jref.dense_attention_with_lse(q, k, v, bias=0.3)
    to, tl = tref.dense_attention_with_lse(_t(q), _t(k), _t(v), bias=0.3)
    _close(to, jo)
    _close(tl, jl)


def test_ref_block_masked_matches_jax_with_explicit_block_k():
    q, k, v = _qkv(1, 1, 2, 300, 130, 32)
    mask = np.random.default_rng(2).random((1, 2, 3, 3)) > 0.5  # block_k 64
    mask[0, 1, 2] = False  # one empty row
    jo, jl = jref.block_masked_attention(q, k, v, mask, block_k=64, bias=0.1)
    to, tl = tref.block_masked_attention(_t(q), _t(k), _t(v), _t(mask), block_k=64, bias=0.1)
    _close(to, jo)
    _close(tl, jl)
    assert float(tl[0, 1, 256:].max()) == np.float32(tref.NEG_INF)
    assert float(to[0, 1, 256:].abs().max()) == 0.0


def test_ref_chunking_changes_no_value(monkeypatch):
    q, k, v = _qkv(3, 1, 2, 300, 260, 16)
    mask = np.random.default_rng(4).random((1, 2, 3, 3)) > 0.4
    whole = tref.dense_attention_with_lse(_t(q), _t(k), _t(v))
    whole_m = tref.block_masked_attention(_t(q), _t(k), _t(v), _t(mask), block_k=128)
    monkeypatch.setattr(tref, "_CHUNK_ELEMS", 2 * 260 * 40)
    parts = tref.dense_attention_with_lse(_t(q), _t(k), _t(v))
    parts_m = tref.block_masked_attention(_t(q), _t(k), _t(v), _t(mask), block_k=128)
    for a, b in ((whole, parts), (whole_m, parts_m)):
        torch.testing.assert_close(a[0], b[0], atol=1e-6, rtol=0)
        torch.testing.assert_close(a[1], b[1], atol=1e-6, rtol=0)


def test_ref_merge_and_pool_match_jax():
    rng = np.random.default_rng(5)
    o1, o2 = rng.standard_normal((2, 1, 2, 40, 16)).astype(np.float32)
    l1, l2 = rng.standard_normal((2, 1, 2, 40)).astype(np.float32)
    l2[0, 0, :3] = tref.NEG_INF  # an empty branch row
    jo, jl = jref.merge_attention([o1, o2], [l1, l2])
    to, tl = tref.merge_attention([_t(o1), _t(o2)], [_t(l1), _t(l2)])
    _close(to, jo, 1e-6)
    _close(tl, jl, 1e-6)
    x = rng.standard_normal((1, 2, 48, 16)).astype(np.float32)
    _close(tref.mean_pool_kv(_t(x), 4), jref.mean_pool_kv(x, 4), 1e-6)


def test_flash_attention_with_bias_matches_jax():
    q, k, v = _qkv(6, 1, 2, 200, 300, 128)
    jo, jl = jbsa.flash_attention(q, k, v, bias=math.log(30.0), interpret=True)
    to, tl = flash_attention(_t(q), _t(k), _t(v), bias=math.log(30.0))
    _close(to, jo)
    _close(tl, jl)


def test_flash_attention_wide_v_matches_jax():
    q, k, _ = _qkv(7, 1, 2, 256, 256, 128)
    # the sum predictor's V: one-hot block pooling, 16 tokens a block, lane
    # padded to Dv = 256
    pool = np.eye(256, dtype=np.float32)[np.arange(256) // 16]
    v = np.broadcast_to(pool, (1, 2, 256, 256)).copy()
    jo, jl = jbsa.flash_attention_wide_v(q, k, v, interpret=True)
    to, tl = flash_attention_wide_v(_t(q), _t(k), _t(v))
    assert to.shape == (1, 2, 256, 256)
    _close(to, jo)
    _close(tl, jl)


def test_flash_attention_wide_v_640_matches_jax():
    """The Wan2.1-14B predictor's V width (5 x 128 lanes), ragged lengths."""
    q, k, v = _qkv(14, 1, 2, 200, 300, 128, dv=640)
    jo, jl = jbsa.flash_attention_wide_v(q, k, v, interpret=True)
    to, tl = flash_attention_wide_v(_t(q), _t(k), _t(v))
    assert to.shape == (1, 2, 200, 640)
    _close(to, jo)
    _close(tl, jl)


def test_block_sparse_ragged_with_empty_row_matches_jax():
    q, k, v = _qkv(8, 1, 2, 300, 330, 128)  # 3 q blocks, 3 ragged k blocks
    mask = np.random.default_rng(9).random((1, 2, 3, 3)) > 0.5
    mask[..., 2] |= True  # the ragged tail block is exercised
    mask[0, 0, 1] = False  # empty row
    jo, jl = jbsa.block_sparse_attention(q, k, v, jnp.asarray(mask), interpret=True)
    to, tl = block_sparse_attention(_t(q), _t(k), _t(v), _t(mask))
    _close(to, jo)
    _close(tl, jl)
    assert float(to[0, 0, 128:256].abs().max()) == 0.0
    assert float(tl[0, 0, 128:256].max()) == np.float32(tref.NEG_INF)


def test_pack_kv_bit_exact_against_jax():
    rng = np.random.default_rng(10)
    k = rng.standard_normal((2, 16 * 128, 128)).astype(np.float32)
    v = rng.standard_normal((2, 16 * 128, 128)).astype(np.float32)
    jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    want = np.asarray(j_pack_kv(jk, jv, lane_pack=False, interpret=True).astype(jnp.float32))
    tk, tv = _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16)
    got = pack_kv(tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # ragged key length: the last record's missing rows are zeros
    ragged = pack_kv(tk[:, :2000], tv[:, :2000]).float().numpy()
    assert ragged.shape == want.shape
    lo, hi = 15 * 256, 16 * 256
    np.testing.assert_array_equal(ragged[:, :lo], want[:, :lo])
    np.testing.assert_array_equal(ragged[:, lo:lo + 80], want[:, lo:lo + 80])
    assert not ragged[:, lo + 80:lo + 128].any() and not ragged[:, hi - 48:hi].any()


def test_norm_rope_heads_matches_jax_fused_path():
    rng = np.random.default_rng(11)
    heads, d, s = 2, 128, 64  # d = 128 and a 64-row tile: JAX's fused kernel
    x = rng.standard_normal((1, s, heads * d)).astype(np.float32)
    perm = deinterleave_perm(heads, d)
    scale = (1.0 + 0.1 * rng.standard_normal(heads * d)).astype(np.float32)[perm]
    cos, sin = rope_3d_tables(d, (4, 4, 4))
    want = j_norm_rope_heads(x, scale, cos, sin, heads, eps=1e-6, interpret=True)
    got = norm_rope_heads(_t(x), _t(scale), _t(cos), _t(sin), heads, eps=1e-6)
    assert got.shape == (1, heads, s, d)
    _close(got, want, 1e-5)
    torch.testing.assert_close(
        got, _norm_rope_reference(_t(x), _t(scale), _t(cos), _t(sin), heads, 1e-6))


def test_cpu_tensors_take_the_plain_versions_without_launching():
    _build.reset_launch_counts()
    q, k, v = (_t(a).requires_grad_(True) for a in _qkv(12, 1, 1, 64, 64, 64))
    outs = flash_attention(q, k, v) + block_sparse_attention(
        q, k, v, torch.ones(1, 1, 1, 1, dtype=torch.bool))
    sum(o.sum() for o in outs).backward()  # the backward too
    pack_kv(k[0].detach(), v[0].detach())
    pack_kv_pyramid(k[0].detach(), v[0].detach())
    outs = (multilevel_attention(q, k, v, lists=multilevel_lists(torch.rand(1, 1, 1, 1),
                                                                 cap=128))
            + multilevel_attention(q, k, v, torch.full((1, 1, 1, 1), 2, dtype=torch.int32),
                                   fused=False))  # both lanes, and their backward
    sum(o.sum() for o in outs).backward()
    with torch.no_grad():
        pooled_scores(q[..., :32, :].detach(), k[..., :32, :].detach(), 16)
        heads_unpack(heads_pack(q[0].detach(), 1))
    ones, zeros, tables = torch.ones(64), torch.zeros(64), torch.zeros(40, 32)
    outs = qk_norm_rope(q[0], k[0], ones, zeros, ones, zeros, tables, tables, 1, 12, 40)
    sum(o.sum() for o in outs).backward()  # the q/k lane and its gradient
    old, tbsa.SPARSE_UNION = tbsa.SPARSE_UNION, True
    try:
        outs = block_sparse_attention(q, k, v, torch.ones(1, 1, 1, 1, dtype=torch.bool))
        sum(o.sum() for o in outs).backward()
    finally:
        tbsa.SPARSE_UNION = old
    x, gate = q[0].detach(), torch.ones(1, 64)  # Wan's block glue
    adaln.norm_affine(x, gate, gate, 1e-6)
    adaln.add_norm_affine(x, x, gate, gate, gate, 1e-6)
    adaln.gated_add(x, x, gate)
    assert set(_build.KERNELS) == {"dense_fwd", "sparse_fwd", "pack_kv", "norm_rope",
                                   "dense_dq", "dense_dkv", "sparse_dq", "sparse_dkv",
                                   "pack_kv_pyramid", "multilevel_fwd", "pooled_level_fwd",
                                   "pooled_predictor", "sparse_union_fwd", "heads_pack",
                                   "heads_unpack", "pooled_level_dq", "pooled_level_dkv",
                                   "attn_delta", "qk_norm_rope", "qk_norm_rope_dx",
                                   "norm_affine", "add_norm_affine", "gated_add"}
    assert all(kern.launches == 0 for kern in _build.KERNELS.values())


def test_kernel_sources_and_build_flags():
    assert _build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
    root = _build.CSRC.parent.parent
    for kern in _build.KERNELS.values():
        src = root / kern.source
        assert src.exists() and f" {kern.symbol}(" in src.read_text()
        for where in kern.replaces.split("; "):  # one CUDA kernel may port two
            path, line = where.split(":")
            tpu_line = (root / path).read_text().splitlines()[int(line) - 1]
            if kern.name == "attn_delta":  # no TPU kernel: JAX's delta, in XLA
                assert "delta = jnp.sum(g_out" in tpu_line, tpu_line
                continue
            if kern.name.startswith("qk_norm_rope"):  # no TPU kernel: CogVideoX's q/k, XLA
                assert "q, k, v = heads(q), heads(k), heads(v)" in tpu_line, tpu_line
                continue
            if kern.source.endswith("adaln.cu"):  # no TPU kernel: Wan's block glue, XLA
                assert {"norm_affine": "h = ln()(x)", "add_norm_affine": "x = x + (gate1 *",
                        "gated_add": "x = x + (gate2 *"}[kern.name] in tpu_line, tpu_line
                continue
            assert tpu_line.startswith("def _") and "kernel" in tpu_line, tpu_line
    with pytest.raises(ValueError):
        block_sparse_attention(*(_t(a) for a in _qkv(13, 1, 1, 64, 64, 64)),
                               torch.ones(1, 1, 2, 1, dtype=torch.bool))
