"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skipped without a GPU.  On the card run
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q``
(``--noconftest`` because the suite's conftest imports JAX, which the port's
machines need not have).  Inputs are bf16 on the card, as on the main path.
Tolerances: attention outputs 2e-2 absolute (bf16 output rounding and the
kernel's bf16 P @ V at |out| <~ 4), lse 5e-3 (f32 sums in another order),
norm_rope 2e-2 (bf16 output rounding), both pack modes bit for bit (the
pyramid pools in f32 in the same order as its plain version).  CogVideoX's
q/k lane: its LayerNorm and its input gradient within one bf16 ulp at each
head row's largest value (the LayerNorm's sums in another order can turn
one rounding), the rotation after it bit for bit (rounded as the plain
version's separate operations are), the norms' parameter gradients exact
(the plain version's vjp).  The backward
kernels (the 128-row ones and the pooled-level ones of the multilevel
backward) are held to 2e-2 * max |ref| per gradient against the plain
backward: p and ds are rounded to bf16 before each product (relative
2^-9 a term) and the gradients to bf16 on output; delta = rowsum(dO * O)
to 1e-5 of each row's sum of |dO * O| (f32 sums in another order).  Wan's
text cross-attention on those kernels is held to the same 2e-2 of the
largest value, output and gradients, against the f32 expression it replaced.
The level carry (a level mask past the fused lane's rule in one #11 carry)
is held to the fused lane's tolerances against the plain function and to
four bf16 ulps at the largest output against the per-level lane, which
rounds each level's output before its merge.  Wan's block glue (LayerNorm
and modulation, the gated residuals): residual outputs bit for bit, normed
outputs within one bf16 ulp at each row's largest value.
"""

import math

import numpy as np
import pytest
import torch

from blade_torch.kernels import _build
from blade_torch.kernels.block_sparse_attn import (
    _delta_reference,
    _dense_cuda,
    attention_backward,
    attention_delta,
    block_sparse_attention,
    flash_attention,
    flash_attention_wide_v,
)
from blade_torch.attention.masks import multilevel_lists, multilevel_mask
from blade_torch.kernels.multilevel_attn import (
    fused_supported,
    levels_to_lists,
    multilevel_attention,
    pooled_level_attention,
    pooled_level_backward,
)
from blade_torch.kernels.norm_rope import _norm_rope_reference, norm_rope_heads
from blade_torch.kernels.pack import (
    _pack_kv_pyramid_reference,
    _pack_kv_reference,
    pack_kv,
    pack_kv_pyramid,
)
from blade_torch.kernels.ref_attention import (
    NEG_INF,
    attention_backward_reference,
    block_masked_attention,
    dense_attention_with_lse,
    multilevel_lists_attention,
    pooled_level_attention_reference,
    pooled_level_backward_reference,
)
from blade_torch.utils import tracing

pytestmark = pytest.mark.cuda

OUT_TOL, LSE_TOL, NORM_TOL = 2e-2, 5e-3, 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("lq,lk,d,dv,bias,heads", [
    (200, 300, 128, 128, math.log(30.0), 3),
    (1000, 37, 128, 128, 0.0, 3),
    (256, 256, 128, 256, 0.0, 3),
    (130, 70, 64, 64, 0.5, 3),
    (128, 256, 64, 128, 0.0, 3),
    # the Wan2.1-14B predictor's V width: two 256-column chunks and a 128 tail
    (300, 520, 128, 640, 0.0, 3),
    # the CogVideoX predictor's V width at d = 64
    (333, 290, 64, 256, 0.0, 3),
    # rows and keys off every tile width; the pooled branch's key count and bias
    (1000, 1092, 128, 128, math.log(30.0), 3),
    # 3 x 200 CTAs: more than one wave on 132 SMs, at both head dims
    (300, 256, 128, 128, 0.0, 200),
    (300, 256, 64, 256, 0.0, 200),
    # tails of 64 and 192 columns, and dv < d
    (200, 300, 128, 320, 0.0, 3),
    (150, 200, 64, 192, 0.2, 3),
    (100, 129, 128, 64, 0.0, 3),
    # Wan2.1-I2V-14B 480p's image branch: 32,760 queries of 40 heads over 257
    # image keys (the last key tile holds one)
    (32760, 257, 128, 128, 0.0, 40),
])
def test_dense_kernel_matches_plain(dev, lq, lk, d, dv, bias, heads):
    gen = torch.Generator(device=dev).manual_seed(lq + lk + d + dv + heads)
    q, k = _rand(gen, 1, heads, lq, d, dev=dev), _rand(gen, 1, heads, lk, d, dev=dev)
    v = _rand(gen, 1, heads, lk, dv, dev=dev)
    if dv == d:
        fn = flash_attention
    elif dv % 128 == 0:
        fn = flash_attention_wide_v
    else:  # the kernel's own entry: JAX's wide-V path takes multiples of 128 only
        def fn(q, k, v, bias):
            return _dense_cuda(q, k, v, 1.0 / math.sqrt(d), bias)
    before = _build.KERNELS["dense_fwd"].launches
    out, lse = fn(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert _build.KERNELS["dense_fwd"].launches == before + 1
    ref_out, ref_lse = dense_attention_with_lse(q, k, v, bias=bias)
    assert out.shape == (1, heads, lq, dv) and lse.dtype == torch.float32
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, ref_lse) <= LSE_TOL


@pytest.mark.parametrize("lq,lk,d,heads", [
    (300, 330, 128, 2), (512, 512, 128, 2), (260, 200, 64, 2),
    # 13 and 14 key blocks, ragged lq and lk: the full row's list wraps the
    # ring of 3 (d 128) or 4 (d 64) stages several times
    (1600, 1600, 128, 2), (1700, 1650, 64, 2),
    # 2 x 40 x 5 mask rows: more CTAs than one wave on 132 SMs
    (600, 700, 128, 40),
])
def test_sparse_kernel_matches_plain(dev, lq, lk, d, heads):
    gen = torch.Generator(device=dev).manual_seed(lq * lk + d)
    q, k, v = (_rand(gen, 2, heads, n, d, dev=dev) for n in (lq, lk, lk))
    n_qt, n_kt = -(-lq // 128), -(-lk // 128)
    mask = torch.rand((2, heads, n_qt, n_kt), generator=gen, device=dev) > 0.5
    mask[..., -1] = True  # the ragged tail block
    mask[0, 1, 0] = True  # every block, next to
    mask[0, 1, 1] = False  # an empty row
    before = _build.KERNELS["sparse_fwd"].launches
    out, lse = block_sparse_attention(q, k, v, mask, bias=0.25)
    torch.cuda.synchronize()
    assert _build.KERNELS["sparse_fwd"].launches == before + 1
    ref_out, ref_lse = block_masked_attention(q, k, v, mask, block_k=128, bias=0.25)
    assert torch.isfinite(out.float()).all()
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, ref_lse) <= LSE_TOL
    assert out[0, 1, 128:256].abs().max().item() == 0.0
    assert lse[0, 1, 128:256].max().item() == torch.tensor(NEG_INF).item()


@pytest.mark.parametrize("bh,lk,d", [
    (3, 2048, 128), (3, 1000, 128), (3, 333, 64),
    (12, 32760, 128),  # Wan 480p: 256 blocks, a ragged last one
    (66000, 100, 64),  # more heads than one grid column holds (65535)
    (2, 300, 24),      # a row width with no compiled form
])
def test_pack_kernel_bit_exact(dev, bh, lk, d):
    gen = torch.Generator(device=dev).manual_seed(lk + d)
    k, v = _rand(gen, bh, lk, d, dev=dev), _rand(gen, bh, lk, d, dev=dev)
    before = _build.KERNELS["pack_kv"].launches
    got = pack_kv(k, v)
    torch.cuda.synchronize()
    assert _build.KERNELS["pack_kv"].launches == before + 1
    assert torch.equal(got, _pack_kv_reference(k, v))


@pytest.mark.parametrize("bh,lk,d", [(3, 300, 64), (2, 450, 128), (1, 17776, 64),
                                     (2, 256, 128)])
def test_pyramid_pack_kernel_bit_exact(dev, bh, lk, d):
    gen = torch.Generator(device=dev).manual_seed(lk * 3 + d)
    k, v = _rand(gen, bh, lk, d, dev=dev), _rand(gen, bh, lk, d, dev=dev)
    before = _build.KERNELS["pack_kv_pyramid"].launches
    got = pack_kv_pyramid(k, v)
    torch.cuda.synchronize()
    assert _build.KERNELS["pack_kv_pyramid"].launches == before + 1
    for level, g, w in zip((1, 2, 4, 8), got, _pack_kv_pyramid_reference(k, v)):
        assert torch.equal(g, w), f"level {level}"


ML_RATIOS = {1: (0.0, 0.25), 2: (0.25, 0.5), 4: (0.5, 0.75), 8: (0.75, 0.9), 0: (0.9, 1.0)}
# Per-level counts of the long row of _walk_lists at 65 key blocks: each past
# the most segments a ring holds at that level (4 stages x 1/2/4/8 segments
# a stage at d = 64, 3 stages at d = 128); the last, ragged block at level 8.
ML_LONG_ROW = [5, 9, 17, 34]


def _walk_lists(gen, n_q, n_kt, dev):
    """Lists whose rows walk the multilevel kernel's corners: random levels
    everywhere but in head 0, where row 0 lists every block in bands of
    levels 1, 2, 4, 8 (ML_LONG_ROW at 65 blocks: longer than the ring at
    every level), row 1 lists pooled levels only and row 2 only the last
    (ragged) block at level 8."""
    choices = torch.tensor([0, 1, 2, 4, 8], device=dev)
    levels = choices[torch.randint(0, 5, (1, 2, n_q, n_kt), generator=gen, device=dev)]
    cuts = [0, 5, 14, 31, n_kt] if n_kt >= 65 else [round(i * n_kt / 4) for i in range(5)]
    for lv, lo, hi in zip((1, 2, 4, 8), cuts, cuts[1:]):
        levels[0, 0, 0, lo:hi] = lv
    levels[0, 0, 1] = choices[2 + torch.randint(0, 3, (n_kt,), generator=gen, device=dev)]
    levels[0, 0, 2] = 0
    levels[0, 0, 2, -1] = 8
    return levels_to_lists(levels)


@pytest.mark.parametrize("l,d,q_rows,ratios,cap", [
    (900, 64, 128, ML_RATIOS, 128),     # ragged, every level, q_rows 128
    (1100, 128, 256, ML_RATIOS, 128),   # d 128, q_rows 256
    (1288, 64, 256, None, 256),         # the default bands; JAX's cog list cap
    (4000, 128, 128, None, 128),        # 32 key blocks
    (640, 64, 256, ML_RATIOS, 128),     # whole blocks, text-free
    # _walk_lists (cap n_kt): lists longer than the ring at every level, a
    # row of pooled levels only, a row of one level-8 segment; lk ragged, so
    # the last level-8 segment is part-live (14 of 16 rows at 8300, 1 at 900)
    (8300, 64, 128, "walks", None),
    (8300, 128, 256, "walks", None),
    (8300, 64, 256, "walks", None),
    (8300, 128, 128, "walks", None),
    (900, 128, 128, "walks", None),
    (900, 64, 256, "walks", None),
])
def test_multilevel_kernel_matches_plain(dev, l, d, q_rows, ratios, cap):
    """Forced last-two rows, one empty row and ragged tails included; the
    plain version runs on the same bf16 inputs (and the same bf16-rounded
    pyramid) in f32."""
    gen = torch.Generator(device=dev).manual_seed(l + d + q_rows)
    q, k, v = (_rand(gen, 1, 2, l, d, dev=dev) for _ in range(3))
    n_q, n_kt = -(-l // q_rows), -(-l // 128)
    if ratios == "walks":
        idx, cnt = _walk_lists(gen, n_q, n_kt, dev)
        if n_kt >= 65:
            assert cnt[0, 0, 0].tolist() == ML_LONG_ROW
    else:
        scores = torch.rand((1, 2, n_q, n_kt), generator=gen, device=dev)
        idx, cnt = multilevel_lists(scores, ratios, cap=cap)
    cnt[0, 1, 0] = 0  # an empty row
    names = ("multilevel_fwd", "pack_kv_pyramid")
    before = [_build.KERNELS[n].launches for n in names]
    out, lse = multilevel_attention(q, k, v, lists=(idx, cnt), q_rows=q_rows)
    torch.cuda.synchronize()
    assert [_build.KERNELS[n].launches for n in names] == [b + 1 for b in before]
    ref_out, ref_lse = multilevel_lists_attention(q, k, v, (idx, cnt), q_rows=q_rows)
    assert torch.isfinite(out.float()).all()
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, ref_lse) <= LSE_TOL
    assert out[0, 1, :q_rows].abs().max().item() == 0.0
    assert lse[0, 1, :q_rows].max().item() == torch.tensor(NEG_INF).item()


@pytest.mark.parametrize("d,q_rows", [(64, 256), (128, 128)])
def test_multilevel_kernel_is_deterministic(dev, d, q_rows):
    """Two calls on the same inputs give bit-identical out and lse."""
    l = 8300
    gen = torch.Generator(device=dev).manual_seed(d + q_rows)
    q, k, v = (_rand(gen, 1, 2, l, d, dev=dev) for _ in range(3))
    lists = _walk_lists(gen, -(-l // q_rows), -(-l // 128), dev)
    first = multilevel_attention(q, k, v, lists=lists, q_rows=q_rows)
    second = multilevel_attention(q, k, v, lists=lists, q_rows=q_rows)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("level,lq,lk,d,bh", [
    (2, 300, 1100, 128, 3),   # ragged keys: the last pooled rows past ceil(lk/2) masked
    (4, 1000, 1100, 64, 3),   # pooled tail row mixing real and edge-repeated keys
    (8, 260, 900, 128, 3),
    (8, 640, 4000, 64, 3),
    (4, 520, 640, 128, 3),    # whole blocks
    (2, 700, 2000, 64, 3),    # level 2 at d 64
    # lists longer than the ring: the full row walks 8, 6 and 7 ring tiles
    # of 2, 4 and 8 segments through 3 (d 128) or 4 (d 64) stages
    (2, 400, 2000, 128, 3),
    (4, 300, 3000, 64, 3),
    (8, 300, 7000, 128, 3),
    # 60 x 6 mask rows: more CTAs than one wave on 132 SMs
    (4, 700, 1500, 128, 60),
])
def test_pooled_level_kernel_matches_plain(dev, level, lq, lk, d, bh):
    """One row with one block (the last: a ring tile with one slot filled),
    one empty row next to one with every block included; the
    plain version reads the same bf16 pooled records in f32."""
    gen = torch.Generator(device=dev).manual_seed(level * 1000 + lq + lk + d + bh)
    q = _rand(gen, bh, lq, d, dev=dev)
    k, v = _rand(gen, bh, lk, d, dev=dev), _rand(gen, bh, lk, d, dev=dev)
    rec = pack_kv_pyramid(k, v)[{2: 1, 4: 2, 8: 3}[level]]
    n_qt, n_kt = -(-lq // 128), -(-lk // 128)
    mask = torch.rand((bh, n_qt, n_kt), generator=gen, device=dev) < 0.4
    mask[0, 0] = False
    mask[0, 0, -1] = True  # one block
    mask[1, 1] = False  # an empty row
    mask[1, 0] = True  # every block
    mask[2, 0] = True  # every block
    seg, pvl = 128 // level, -(-lk // level)
    before = _build.KERNELS["pooled_level_fwd"].launches
    out, lse = pooled_level_attention(q, rec, mask, level=level, scale=d ** -0.5,
                                      pooled_valid_len=pvl)
    torch.cuda.synchronize()
    assert _build.KERNELS["pooled_level_fwd"].launches == before + 1
    r = rec.view(bh, n_kt, 2, seg, d)
    ref_out, ref_lse = pooled_level_attention_reference(
        q, r[:, :, 0].reshape(bh, -1, d), r[:, :, 1].reshape(bh, -1, d), mask, level=level,
        scale=d ** -0.5, pooled_valid_len=pvl)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, ref_lse) <= LSE_TOL
    assert out[1, 128:256].abs().max().item() == 0.0
    assert lse[1, 128:256].max().item() == torch.tensor(NEG_INF).item()


def test_per_level_lane_matches_plain(dev):
    """``multilevel_attention(..., fused=False)`` on the card: level 1
    through pack_kv + the sparse kernel, each pooled level through one
    pooled-level launch over one pyramid pack; against the same lane's plain
    versions on the same bf16 inputs."""
    gen = torch.Generator(device=dev).manual_seed(5)
    l, d = 1100, 128
    q, k, v = (_rand(gen, 1, 2, l, d, dev=dev) for _ in range(3))
    levels = multilevel_mask(torch.rand((1, 2, 9, 9), generator=gen, device=dev), ML_RATIOS)
    levels[0, 1, 3] = 0  # an empty row
    names = ("pack_kv", "sparse_fwd", "pack_kv_pyramid", "pooled_level_fwd", "multilevel_fwd")
    before = [_build.KERNELS[n].launches for n in names]
    out, lse = multilevel_attention(q, k, v, levels, fused=False)
    torch.cuda.synchronize()
    assert [_build.KERNELS[n].launches - b for n, b in zip(names, before)] == [1, 1, 1, 3, 0]
    ref_out, ref_lse = multilevel_attention(*(t.cpu() for t in (q, k, v)), levels.cpu(),
                                            fused=False)
    assert _err(out.cpu(), ref_out) <= OUT_TOL
    assert _err(lse.cpu(), ref_lse) <= LSE_TOL
    assert out[0, 1, 384:512].abs().max().item() == 0.0


# Past the fused lane's rule (258 key blocks), a 128-row level mask on the
# card takes the level carry: its four lists in one #11 carry.
CARRY_LK = 257 * 128 + 37
CARRY_FWD = ("multilevel_fwd", "pack_kv_pyramid", "sparse_fwd", "pack_kv", "pooled_level_fwd")


def _carry_inputs(dev, d):
    gen = torch.Generator(device=dev).manual_seed(CARRY_LK + d)
    q, k, v = (_rand(gen, 1, 2, CARRY_LK, d, dev=dev) for _ in range(3))
    n = -(-CARRY_LK // 128)
    levels = multilevel_mask(torch.rand((1, 2, n, n), generator=gen, device=dev), ML_RATIOS)
    assert not fused_supported(d, CARRY_LK)
    return gen, q, k, v, levels


@pytest.mark.parametrize("d", [128, 64])
def test_level_carry_matches_plain_past_the_fused_rule(dev, d):
    """``multilevel_attention(q, k, v, levels)`` past 256 key blocks: one
    pyramid pack and one #11 launch, none of the per-level lane's; out and
    lse within the fused lane's tolerances of the plain f32 function over
    the mask's lists, and within bf16 rounding of ``fused=False`` (four
    ulps at its largest output: one rounding against four merged ones);
    one ``asa.level_carry_calls`` under a profiler, no per-level call."""
    from torch.profiler import ProfilerActivity, profile

    _, q, k, v, levels = _carry_inputs(dev, d)
    before = [_build.KERNELS[n].launches for n in CARRY_FWD]
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out, lse = multilevel_attention(q, k, v, levels)
        torch.cuda.synchronize()
    got = tracing.counters()
    tracing.reset()
    assert [_build.KERNELS[n].launches - b for n, b in zip(CARRY_FWD, before)] == [1, 1, 0, 0, 0]
    assert got.get("asa.level_carry_calls") == 1 and "asa.per_level_calls" not in got
    ref_out, ref_lse = multilevel_lists_attention(q, k, v, levels_to_lists(levels), q_rows=128)
    assert torch.isfinite(out.float()).all()
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, ref_lse) <= LSE_TOL
    lane_out, lane_lse = multilevel_attention(q, k, v, levels, fused=False)
    assert _err(out, lane_out) <= 2 ** -6 * lane_out.float().abs().max().item()
    assert _err(lse, lane_lse) <= LSE_TOL


@pytest.mark.parametrize("d", [128, 64])
def test_level_carry_backward_matches_plain(dev, d):
    """dQ, dK, dV through the level carry (the fused lane's backward against
    the one merged ``(out, lse)``) against torch autograd of the plain f32
    function on the same bf16 inputs, 16 mask rows at a time (the loss sums
    over query rows, so the chunks' gradients add up), with exact backward
    launch counts."""
    gen, q, k, v, levels = _carry_inputs(dev, d)
    g_out = _rand(gen, 1, 2, CARRY_LK, d, dev=dev)
    g_lse = torch.randn((1, 2, CARRY_LK), generator=gen, device=dev)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    names = ("pack_kv", "sparse_dq", "sparse_dkv", "pooled_level_dq", "pooled_level_dkv",
             "attn_delta")
    before = [_build.KERNELS[n].launches for n in names]
    out, lse = multilevel_attention(*leaves, levels)
    got = torch.autograd.grad((out, lse), leaves, (g_out, g_lse))
    torch.cuda.synchronize()
    assert [_build.KERNELS[n].launches - b for n, b in zip(names, before)] == [0, 1, 1, 3, 3, 1]
    idx, cnt = levels_to_lists(levels)
    plain = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    qf, kf, vf = plain
    for m0 in range(0, idx.shape[2], 16):
        r0, r1 = m0 * 128, min(CARRY_LK, (m0 + 16) * 128)
        o, s = multilevel_lists_attention(
            qf[:, :, r0:r1], kf, vf, (idx[:, :, m0:m0 + 16], cnt[:, :, m0:m0 + 16]), q_rows=128)
        torch.autograd.backward((o, s), (g_out[:, :, r0:r1].float(), g_lse[:, :, r0:r1]))
    for g, w in zip(got, (t.grad for t in plain)):
        assert torch.isfinite(g.float()).all()
        assert _err(g, w) <= BWD_REL * w.abs().max().item()


@pytest.mark.parametrize("level,lq,lk,d", [
    (2, 300, 1100, 128),
    (4, 1000, 1101, 64),   # pooled tail row mixing real and edge-repeated keys
    (8, 260, 900, 128),
    (8, 640, 4000, 64),
    (4, 520, 640, 128),
    (2, 390, 777, 64),
])
def test_pooled_level_backward_kernels_match_plain(dev, level, lq, lk, d):
    """Both pooled backward kernels against the plain pooled backward on the
    same bf16 records, with a non-zero LSE cotangent, one empty row, one row
    selecting every block and one block no query tile selects (its pooled
    dK/dV exactly 0); p is recomputed from a level-own lse."""
    gen = torch.Generator(device=dev).manual_seed(level * 999 + lq + lk + d)
    bh = 3
    q = _rand(gen, bh, lq, d, dev=dev)
    k, v = _rand(gen, bh, lk, d, dev=dev), _rand(gen, bh, lk, d, dev=dev)
    rec = pack_kv_pyramid(k, v)[{2: 1, 4: 2, 8: 3}[level]]
    n_qt, n_kt = -(-lq // 128), -(-lk // 128)
    mask = torch.rand((bh, n_qt, n_kt), generator=gen, device=dev) < 0.4
    mask[1, 1] = False  # an empty row
    mask[2, 0] = True  # every block
    mask[0, :, 1] = False  # a block no query tile selects
    seg, pvl = 128 // level, -(-lk // level)
    kw = dict(level=level, scale=d ** -0.5, pooled_valid_len=pvl)
    out, lse = pooled_level_attention(q, rec, mask, **kw)
    g_out = _rand(gen, bh, lq, d, dev=dev)
    g_lse = torch.randn((bh, lq), generator=gen, device=dev)
    names = ("pooled_level_dq", "pooled_level_dkv")
    before = [_build.KERNELS[n].launches for n in names]
    dq, dk, dv = pooled_level_backward(q, rec, out, lse, g_out, g_lse, mask, **kw)
    torch.cuda.synchronize()
    assert [_build.KERNELS[n].launches for n in names] == [b + 1 for b in before]
    r = rec.view(bh, n_kt, 2, seg, d)
    want = pooled_level_backward_reference(
        q, r[:, :, 0].reshape(bh, -1, d), r[:, :, 1].reshape(bh, -1, d), out, lse, g_out,
        g_lse, mask, **kw)
    for got, ref in zip((dq, dk, dv), want):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        assert _err(got, ref) <= BWD_REL * ref.float().abs().max().item()
    assert dq[1, 128:256].float().abs().max().item() == 0.0
    for g in (dk, dv):
        assert g[0, seg:2 * seg].float().abs().max().item() == 0.0
        assert g[:, pvl:].float().abs().sum().item() == 0.0  # dead pooled rows, if any


@pytest.mark.parametrize("lane,q_rows,l,d", [
    ("fused", 128, 1100, 128),
    ("fused", 256, 901, 64),
    ("per-level", 128, 1101, 128),
])
def test_multilevel_backward_matches_plain(dev, lane, q_rows, l, d):
    """dQ, dK, dV of ``multilevel_attention`` on the card against the same
    Functions' plain per-pass backward on the CPU (f32, the same bf16
    inputs), with exact backward launch counts."""
    gen = torch.Generator(device=dev).manual_seed(l + q_rows + d)
    q, k, v = (_rand(gen, 1, 2, l, d, dev=dev) for _ in range(3))
    n_kt = -(-l // 128)
    scores = torch.rand((1, 2, -(-l // q_rows), n_kt), generator=gen, device=dev)
    if lane == "fused":
        masks = {"lists": multilevel_lists(scores, ML_RATIOS, cap=128), "q_rows": q_rows}
    else:
        masks = {"levels": multilevel_mask(scores, ML_RATIOS), "fused": False}
    g_out = _rand(gen, 1, 2, l, d, dev=dev)
    g_lse = torch.randn((1, 2, l), generator=gen, device=dev)

    def grads(device, dtype):
        leaves = [t.to(device, dtype).requires_grad_(True) for t in (q, k, v)]
        kw = {n: (tuple(t.to(device) for t in m) if isinstance(m, tuple) else
                  m.to(device) if torch.is_tensor(m) else m) for n, m in masks.items()}
        out, lse = multilevel_attention(*leaves, **kw)
        return torch.autograd.grad((out, lse), leaves, (g_out.to(device, dtype),
                                                        g_lse.to(device)))

    names = ("pack_kv", "sparse_dq", "sparse_dkv", "pooled_level_dq", "pooled_level_dkv",
             "attn_delta")
    before = [_build.KERNELS[n].launches for n in names]
    got = grads(dev, torch.bfloat16)
    torch.cuda.synchronize()
    # The backward packs nothing (its kernels read K/V in place); the
    # per-level forward's level 1 packs once.  The fused lane's backward
    # shares one delta among its four passes; the per-level lane's level 1
    # and three pooled levels each take their own.
    pack, delta = (0, 1) if lane == "fused" else (1, 4)
    assert [_build.KERNELS[n].launches - b for n, b in zip(names, before)] == \
        [pack, 1, 1, 3, 3, delta]
    want = grads(torch.device("cpu"), torch.float32)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        assert _err(g.cpu(), w) <= BWD_REL * w.abs().max().item()


@pytest.mark.parametrize("s,dim,heads", [
    (504, 1536, 12), (100, 256, 2), (64, 128, 2),
    (61, 5120, 40),    # the Wan2.1-14B width: four warps a row
    (503, 1536, 12),   # 1006 rows: the last CTA's 8 row slots not filled
    (300, 1536, 24),   # d = 64 at the 1.3B width
    (50, 96, 4),       # d = 24 and d = 8: the partner read element by
    (40, 64, 8),       # element (d / 8 not a power of two from 2 to 32)
])
def test_norm_rope_kernel_matches_plain(dev, s, dim, heads):
    gen = torch.Generator(device=dev).manual_seed(s + dim)
    x = _rand(gen, 2, s, dim, dev=dev)
    scale = 1.0 + 0.1 * torch.randn(dim, generator=gen, device=dev)
    d = dim // heads
    ang = torch.rand((s, d // 2), generator=gen, device=dev) * 6.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    got = norm_rope_heads(x, scale, cos, sin, heads)
    torch.cuda.synchronize()
    want = _norm_rope_reference(x, scale, cos, sin, heads, 1e-6)
    assert got.shape == (2, heads, s, d)
    assert _err(got, want) <= NORM_TOL


def test_kernels_are_forward_only(dev):
    """Only the predictor's wide-V flash stays forward-only; the dense and
    sparse kernels now have backward kernels."""
    q = torch.randn(1, 1, 64, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    pool = torch.zeros(1, 1, 64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_wide_v(q, q, pool)
    with torch.no_grad():
        flash_attention_wide_v(q, q, pool)
    out, _ = flash_attention(q, q, q)
    out.float().sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()


BWD_REL = 2e-2


@pytest.mark.parametrize("lq,lk,d,bias,masked,heads", [
    (300, 300, 128, 0.7, True, (2, 2)),
    (520, 260, 128, 0.0, True, (2, 2)),
    (300, 300, 128, 0.7, False, (2, 2)),
    (1000, 37, 128, math.log(30.0), False, (2, 2)),
    (260, 200, 64, 0.25, True, (2, 2)),
    (130, 70, 64, 0.5, False, (2, 2)),
    # The dense pair: the key counts of the pooled branches (Wan 480p at d
    # 128, +log 30; CogVideoX at d 64, +log 15), lq a multiple of neither
    # 64 nor 128, and 300 heads: several waves of CTAs for both kernels.
    (1000, 1092, 128, math.log(30.0), False, (1, 3)),
    (1000, 1186, 64, math.log(15.0), False, (1, 3)),
    (333, 37, 64, 0.0, False, (2, 2)),
    (200, 450, 128, 0.1, False, (2, 2)),
    (700, 600, 128, 0.0, False, (4, 75)),
    (300, 520, 64, 0.3, False, (4, 75)),
    # The sparse pair's list walks: lists longer than the ring (a mask kept
    # at 0.9, lq = lk >= 1100: 9-11 blocks a list against 2 blocks of ring),
    # ragged lq != lk at both d (last query blocks of 104, 26 and 66 rows,
    # last key blocks of 20 and 60 keys), and more CTAs than one wave.
    (1100, 1100, 128, 0.2, 0.9, (2, 2)),
    (1300, 1300, 64, 0.0, 0.9, (1, 3)),
    (1000, 1300, 128, 0.0, True, (2, 2)),
    (1050, 1300, 128, 0.4, True, (2, 2)),
    (1090, 700, 64, 0.4, True, (2, 2)),
    (700, 600, 128, 0.0, True, (4, 75)),
    (300, 520, 64, 0.3, True, (4, 75)),
])
def test_backward_kernels_match_plain(dev, lq, lk, d, bias, masked, heads):
    """``masked``: False (dense), True (a block mask kept at 0.5) or the share
    of blocks kept."""
    gen = torch.Generator(device=dev).manual_seed(lq * 7 + lk + d)
    q, k, v = (_rand(gen, *heads, n, d, dev=dev).requires_grad_(True) for n in (lq, lk, lk))
    g_out = _rand(gen, *heads, lq, d, dev=dev)
    g_lse = torch.randn((*heads, lq), generator=gen, device=dev)
    mask = None
    if masked:
        keep = 0.5 if masked is True else masked
        mask = torch.rand((*heads, -(-lq // 128), -(-lk // 128)), generator=gen,
                          device=dev) > 1.0 - keep
        mask[..., -1] = True  # the ragged tail block
        mask[0, 1, 1] = False  # an empty row: never exp2 of its -1e30 lse
        mask[0, 0, :, 0] = False  # a key block that no row selected
    names = ("sparse_dq", "sparse_dkv") if masked else ("dense_dq", "dense_dkv")
    names += ("attn_delta", "pack_kv")
    before = [_build.KERNELS[n].launches for n in names]
    out, lse = block_sparse_attention(q, k, v, mask, bias=bias)
    dq, dk, dv = torch.autograd.grad((out, lse), (q, k, v), (g_out, g_lse))
    torch.cuda.synchronize()
    # One launch each of the pair and of delta; only the sparse forward packs.
    assert [_build.KERNELS[n].launches - b for n, b in zip(names, before)] == \
        [1, 1, 1, int(mask is not None)]
    q, k, v, out, lse = (t.detach() for t in (q, k, v, out, lse))
    scale = 1.0 / math.sqrt(d)
    want = attention_backward_reference(q, k, v, out, lse, g_out, g_lse, block_mask=mask,
                                        block_k=128, scale=scale, bias=bias)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        assert _err(got, ref) <= BWD_REL * ref.float().abs().max().item()
    if masked:
        assert dq[0, 1, 128:256].float().abs().max().item() == 0.0
        assert dk[0, 0, :128].float().abs().max().item() == 0.0
        assert dv[0, 0, :128].float().abs().max().item() == 0.0
    else:
        # A row given the empty-row LSE gets p = 0: no gradient, and nothing
        # of it in dK / dV.
        lse[0, 0, lq // 2] = NEG_INF
        got = attention_backward(q, k, v, out, lse, g_out, g_lse, None, scale=scale,
                                 bias=bias)
        want = attention_backward_reference(q, k, v, out, lse, g_out, g_lse, scale=scale,
                                            bias=bias)
        for g, ref in zip(got, want):
            assert torch.isfinite(g.float()).all()
            assert _err(g, ref) <= BWD_REL * ref.float().abs().max().item()
        assert got[0][0, 0, lq // 2].float().abs().max().item() == 0.0


@pytest.mark.parametrize("lq,lk,d", [(1000, 1092, 128), (700, 1186, 64), (333, 300, 128)])
def test_dense_backward_kernels_are_deterministic(dev, lq, lk, d):
    """No atomics: two calls give bit-identical dQ, dK and dV."""
    gen = torch.Generator(device=dev).manual_seed(lq + lk + d)
    q, k, v, g_out = (_rand(gen, 2, 3, n, d, dev=dev) for n in (lq, lk, lk, lq))
    g_lse = torch.randn((2, 3, lq), generator=gen, device=dev)
    out, lse = flash_attention(q, k, v)
    first = attention_backward(q, k, v, out, lse, g_out, g_lse, None, scale=d ** -0.5)
    second = attention_backward(q, k, v, out, lse, g_out, g_lse, None, scale=d ** -0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lq,lk,d", [(1100, 1100, 128), (700, 1186, 64), (333, 300, 128)])
def test_sparse_backward_kernels_are_deterministic(dev, lq, lk, d):
    """The sparse pair's twin: no atomics, two calls bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(lq + lk + d + 1)
    q, k, v, g_out = (_rand(gen, 2, 3, n, d, dev=dev) for n in (lq, lk, lk, lq))
    g_lse = torch.randn((2, 3, lq), generator=gen, device=dev)
    mask = torch.rand((2, 3, -(-lq // 128), -(-lk // 128)), generator=gen, device=dev) > 0.4
    out, lse = block_sparse_attention(q, k, v, mask)
    first = attention_backward(q, k, v, out, lse, g_out, g_lse, mask, scale=d ** -0.5)
    second = attention_backward(q, k, v, out, lse, g_out, g_lse, mask, scale=d ** -0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,d", [((2, 3, 333), 128), ((1, 5, 1001), 64), ((7,), 64),
                                     ((4, 75, 130), 128)])
def test_delta_kernel_matches_plain(dev, shape, d):
    """``bt_attn_delta`` against ``rowsum(dO * O)`` in f32, ragged row counts:
    within 1e-5 of each row's sum of |dO * O| (f32 sums in another order),
    and from a cotangent that is a view at an odd offset."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + d)
    out = _rand(gen, *shape, d, dev=dev)
    g_out = _rand(gen, *shape, d + 1, dev=dev)[..., 1:]  # unaligned, strided
    before = _build.KERNELS["attn_delta"].launches
    got = attention_delta(out, g_out)
    torch.cuda.synchronize()
    assert _build.KERNELS["attn_delta"].launches == before + 1
    want = _delta_reference(out, g_out)
    assert got.dtype == torch.float32 and got.shape == tuple(shape)
    bound = 1e-5 * (out.float() * g_out.float()).abs().sum(-1) + 1e-6
    assert ((got - want).abs() <= bound).all()


def test_norm_rope_backward_is_vjp_of_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(9)
    x = _rand(gen, 1, 100, 256, dev=dev).requires_grad_(True)
    scale = (1.0 + 0.1 * torch.randn(256, generator=gen, device=dev)).requires_grad_(True)
    ang = torch.rand((100, 64), generator=gen, device=dev) * 6.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    g = _rand(gen, 1, 2, 100, 128, dev=dev)
    dx, ds = torch.autograd.grad(norm_rope_heads(x, scale, cos, sin, 2), (x, scale), g)
    xr, sr = x.detach().requires_grad_(True), scale.detach().requires_grad_(True)
    rx, rs = torch.autograd.grad(_norm_rope_reference(xr, sr, cos, sin, 2, 1e-6), (xr, sr), g)
    torch.testing.assert_close(dx, rx, atol=0, rtol=0)
    torch.testing.assert_close(ds, rs, atol=0, rtol=0)


def _qk_inputs(b, heads, n_txt, n_vid, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    l = n_txt + n_vid
    q_proj, k_proj = _rand(gen, b, l, heads * 64, dev=dev), _rand(gen, b, l, heads * 64, dev=dev)
    params = [1.0 + 0.2 * torch.randn(64, generator=gen, device=dev),
              0.1 * torch.randn(64, generator=gen, device=dev),
              1.0 + 0.2 * torch.randn(64, generator=gen, device=dev),
              0.1 * torch.randn(64, generator=gen, device=dev)]
    ang = torch.rand((n_vid, 32), generator=gen, device=dev) * 6.0
    return q_proj, k_proj, params, torch.cos(ang), torch.sin(ang)


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.clamp_min(2.0 ** -100))) - 7)


# CogVideoX's q/k lane: B 1 and 2, 48 heads and 2, 226 text rows and 3,
# 17,550 video rows and 37, text first and text last.
@pytest.mark.parametrize("b,heads,n_txt,n_vid,text_last", [
    (1, 48, 226, 17550, True),   # the 480p clip on ASA's lane
    (1, 48, 226, 17550, False),  # the dense model's [text, video]
    (2, 2, 3, 37, True),
    (2, 2, 3, 37, False),
    (2, 48, 3, 37, False),
    (1, 2, 226, 17550, True),
])
def test_qk_norm_rope_kernel_matches_plain(dev, b, heads, n_txt, n_vid, text_last):
    """The LayerNorm within one bf16 ulp at each head row's largest value
    (mean and variance summed in another order can turn its rounding),
    checked on a call with no video rows; then the rotation and the head
    split bit for bit: text rows are that call's values, video rows the
    plain RoPE of them."""
    from blade_torch.kernels.qk_norm_rope import _qk_norm_rope_reference, qk_norm_rope
    from blade_torch.models.layers import apply_rope_half

    q_proj, k_proj, params, cos, sin = _qk_inputs(b, heads, n_txt, n_vid, b + heads + n_vid,
                                                  dev)
    vid_start = 0 if text_last else n_txt
    vid = slice(vid_start, vid_start + n_vid)
    before = _build.KERNELS["qk_norm_rope"].launches
    got = qk_norm_rope(q_proj, k_proj, *params, cos, sin, heads, vid_start, n_vid)
    normed = qk_norm_rope(q_proj, k_proj, *params, cos[:0], sin[:0], heads, 0, 0)
    torch.cuda.synchronize()
    assert _build.KERNELS["qk_norm_rope"].launches == before + 2
    want = _qk_norm_rope_reference(q_proj, k_proj, *params, cos[:0], sin[:0], heads, 0, 0,
                                   1e-6)
    for g, n, w in zip(got, normed, want):
        assert g.shape == (b, heads, n_txt + n_vid, 64) and g.is_contiguous()
        top = torch.maximum(n.float().abs(), w.float().abs()).amax(-1, keepdim=True)
        err = (n.float() - w.float()).abs()
        assert (err <= _bf16_ulp(top)).all(), err.max()
        roped = n.clone()
        roped[:, :, vid] = apply_rope_half(n[:, :, vid], cos, sin)
        assert torch.equal(g, roped)


@pytest.mark.parametrize("b,heads,n_txt,n_vid,text_last", [
    (1, 48, 226, 17550, True),
    (2, 2, 3, 37, False),
    (2, 48, 3, 37, True),
])
def test_qk_norm_rope_dx_kernel_matches_autograd_of_plain(dev, b, heads, n_txt, n_vid,
                                                         text_last):
    from blade_torch.kernels.qk_norm_rope import _qk_norm_rope_reference, qk_norm_rope

    q_proj, k_proj, params, cos, sin = _qk_inputs(b, heads, n_txt, n_vid, 7 + n_vid, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    cot = [_rand(gen, b, heads, n_txt + n_vid, 64, dev=dev) for _ in range(2)]
    vid_start = 0 if text_last else n_txt
    grads = []
    for fn in (qk_norm_rope, lambda *a: _qk_norm_rope_reference(*a, 1e-6)):
        leaves = [q_proj.detach().requires_grad_(True), k_proj.detach().requires_grad_(True)]
        out = fn(*leaves, *params, cos, sin, heads, vid_start, n_vid)
        grads.append(torch.autograd.grad(out, leaves, cot))
    before = _build.KERNELS["qk_norm_rope_dx"].launches
    for got, want in zip(*grads):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        rows = want.float().abs().reshape(b, n_txt + n_vid, heads, 64).amax(-1, keepdim=True)
        err = (got.float() - want.float()).abs().reshape(b, n_txt + n_vid, heads, 64)
        assert (err <= _bf16_ulp(rows)).all(), err.max()
    leaves = [q_proj.detach().requires_grad_(True), k_proj.detach().requires_grad_(True)]
    torch.autograd.grad(qk_norm_rope(*leaves, *params, cos, sin, heads, vid_start, n_vid),
                        leaves, cot)
    assert _build.KERNELS["qk_norm_rope_dx"].launches == before + 1


def test_qk_norm_rope_parameter_gradients_are_vjp_of_plain(dev):
    from blade_torch.kernels.qk_norm_rope import _qk_norm_rope_reference, qk_norm_rope

    q_proj, k_proj, params, cos, sin = _qk_inputs(2, 2, 3, 37, 12, dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    cot = [_rand(gen, 2, 2, 40, 64, dev=dev) for _ in range(2)]
    grads = []
    for fn in (qk_norm_rope, lambda *a: _qk_norm_rope_reference(*a, 1e-6)):
        leaves = [p.detach().requires_grad_(True) for p in params]
        out = fn(q_proj, k_proj, *leaves, cos, sin, 2, 3, 37)
        grads.append(torch.autograd.grad(out, leaves, cot))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("tpb,d,nq,nk", [
    (32, 128, 10, 7),    # ragged: 224 sampled keys end mid-tile
    (16, 128, 9, 16),    # 144 sampled queries: the last CTA half-empty
    (32, 64, 8, 256),    # Wan 480p's 256 key blocks
    (16, 64, 4, 2000),   # 2000 k-blocks: 250 key tiles through the ring
    (32, 128, 6, 591),   # the Wan2.1-14B grid's 591 key blocks
    (16, 128, 13, 591),  # ... at 16 tokens: 208 sampled rows, 74 key tiles
    (32, 64, 5, 139),    # the CogVideoX 480p grid at d 64: 4448 keys end mid-tile
    (16, 64, 7, 9),      # 112 sampled rows and 144 keys: one part-live tile each
])
def test_pooled_predictor_kernel_matches_plain(dev, tpb, d, nq, nk):
    """``Po`` against the plain version on the same bf16 inputs: 1e-5
    absolute (entries <= 1; f32 sums in another order, ex2.approx), rows
    summing to 1."""
    from blade_torch.attention.masks import pooled_scores_plain
    from blade_torch.kernels.pooled_predictor import pooled_scores

    gen = torch.Generator(device=dev).manual_seed(tpb * nk + d)
    q, k = _rand(gen, 1, 3, nq * tpb, d, dev=dev), _rand(gen, 1, 3, nk * tpb, d, dev=dev)
    k[:, :, :tpb] += q[:, :, :tpb]  # one strong block
    before = _build.KERNELS["pooled_predictor"].launches
    got = pooled_scores(q, k, tpb)
    torch.cuda.synchronize()
    assert _build.KERNELS["pooled_predictor"].launches == before + 1
    want = pooled_scores_plain(q, k, tpb, 1.0 / math.sqrt(d))
    assert got.shape == want.shape == (1, 3, nq, nk) and got.dtype == torch.float32
    assert _err(got, want) <= 1e-5
    assert (got.sum(-1) - 1.0).abs().max().item() <= 1e-5


@pytest.mark.parametrize("tpb,d", [(32, 128), (16, 64)])
def test_pooled_predictor_kernel_is_deterministic(dev, tpb, d):
    """Two calls on the same inputs give the same bits (no atomics: each Po
    entry is one thread's max over its q-block's rows), over 40 heads of
    ragged lengths: more CTAs than one wave."""
    from blade_torch.kernels.pooled_predictor import pooled_scores

    gen = torch.Generator(device=dev).manual_seed(tpb + d)
    q, k = _rand(gen, 1, 40, 11 * tpb, d, dev=dev), _rand(gen, 1, 40, 37 * tpb, d, dev=dev)
    a, b = pooled_scores(q, k, tpb), pooled_scores(q, k, tpb)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _union(q, k, v, mask, **kw):
    from blade_torch.kernels import block_sparse_attn as bsa

    old = bsa.SPARSE_UNION
    try:
        bsa.SPARSE_UNION = True
        return block_sparse_attention(q, k, v, mask, **kw)
    finally:
        bsa.SPARSE_UNION = old


@pytest.mark.parametrize("lq,lk,d,heads", [
    (300, 330, 128, 2), (512, 700, 128, 2), (384, 200, 64, 2),
    # 13 and 14 key blocks, ragged lk: lists longer than the ring of 3 (d
    # 128) or 4 (d 64) stages, an odd mask-row count
    (1600, 1650, 128, 2), (1700, 1750, 64, 2),
    # 2 x 40 x 6 mask rows: more CTAs than one wave on 132 SMs
    (700, 600, 128, 40), (768, 900, 64, 40),
])
def test_sparse_union_kernel_matches_plain(dev, lq, lk, d, heads):
    """Odd and even mask-row counts, ragged keys, an empty row beside a
    non-empty one (its bit never set in the pair's list), and a row listing
    every block."""
    gen = torch.Generator(device=dev).manual_seed(lq + lk + d)
    q, k, v = (_rand(gen, 2, heads, n, d, dev=dev) for n in (lq, lk, lk))
    n_qt, n_kt = -(-lq // 128), -(-lk // 128)
    mask = torch.rand((2, heads, n_qt, n_kt), generator=gen, device=dev) > 0.5
    mask[..., 0] = True
    mask[..., -1] = True  # the ragged tail block
    mask[0, 1, 1] = False  # an empty row
    mask[1, 0, 0] = True  # a row listing every block
    counts = {n: _build.KERNELS[n].launches for n in ("sparse_union_fwd", "sparse_fwd", "pack_kv")}
    out, lse = _union(q, k, v, mask, bias=0.25)
    torch.cuda.synchronize()
    assert _build.KERNELS["sparse_union_fwd"].launches == counts["sparse_union_fwd"] + 1
    assert _build.KERNELS["sparse_fwd"].launches == counts["sparse_fwd"]
    assert _build.KERNELS["pack_kv"].launches == counts["pack_kv"]
    ref_out, ref_lse = block_masked_attention(q, k, v, mask, block_k=128, bias=0.25)
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, ref_lse) <= LSE_TOL
    assert out[0, 1, 128:256].abs().max().item() == 0.0
    assert lse[0, 1, 128:256].max().item() == torch.tensor(NEG_INF).item()


@pytest.mark.parametrize("d", [128, 64])
def test_sparse_union_kernel_with_bound_on_an_energy_mask(dev, d):
    """The energy lane's call: an energy mask of 40 key blocks and its union
    bound (the forced full rows exceed it and go through as identity lists)."""
    from blade_torch.attention.masks import energy_mask

    gen = torch.Generator(device=dev).manual_seed(5 + d)
    q, k, v = (_rand(gen, 1, 3, 5100, d, dev=dev) for _ in range(3))
    scores = torch.rand((1, 3, 40, 40), generator=gen, device=dev) ** 4
    mask = energy_mask(scores / scores.sum(-1, keepdim=True), min_retain_ratio=0.05,
                       max_retain_ratio=0.2)
    bound = 2 * (int(40 * 0.2) + 2)
    out, lse = _union(q, k, v, mask, union_bound=bound)
    ref_out, ref_lse = block_masked_attention(q, k, v, mask, block_k=128)
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, ref_lse) <= LSE_TOL


@pytest.mark.parametrize("d", [128, 64])
def test_sparse_union_kernel_is_deterministic(dev, d):
    """Two calls give the same bits: every row's blocks in one ascending
    order, no atomics (3 x 7 mask rows, lists longer than the ring)."""
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (_rand(gen, 1, 3, n, d, dev=dev) for n in (850, 1500, 1500))
    mask = torch.rand((1, 3, 7, 12), generator=gen, device=dev) > 0.3
    a, b = _union(q, k, v, mask), _union(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("b,s,h,d,dtype", [
    (1, 1000, 12, 128, torch.bfloat16),  # 16-byte chunks
    (2, 37, 3, 20, torch.float32),       # 16-byte chunks, 5 a head
    (1, 50, 4, 6, torch.bfloat16),       # 4-byte chunks
    (1, 33, 5, 3, torch.float16),        # 2-byte chunks
    (2, 9, 2, 7, torch.uint8),           # 1-byte chunks
])
def test_heads_pack_kernels_bit_exact(dev, b, s, h, d, dtype):
    from blade_torch.kernels.norm_rope import heads_pack, heads_unpack

    x = torch.randint(0, 120, (b, s, h * d), device=dev).to(dtype)
    before = {n: _build.KERNELS[n].launches for n in ("heads_pack", "heads_unpack")}
    packed = heads_pack(x, h)
    back = heads_unpack(packed)
    torch.cuda.synchronize()
    assert _build.KERNELS["heads_pack"].launches == before["heads_pack"] + 1
    assert _build.KERNELS["heads_unpack"].launches == before["heads_unpack"] + 1
    assert torch.equal(packed, x.view(b, s, h, d).transpose(1, 2))
    assert torch.equal(back, x)


def test_heads_pack_gradients_are_each_others_kernel(dev):
    from blade_torch.kernels.norm_rope import heads_pack, heads_unpack

    gen = torch.Generator(device=dev).manual_seed(6)
    x = _rand(gen, 1, 64, 256, dev=dev).requires_grad_(True)
    w = _rand(gen, 1, 2, 64, 128, dev=dev)
    before = _build.KERNELS["heads_unpack"].launches
    (heads_pack(x, 2).float() * w.float()).sum().backward()
    assert _build.KERNELS["heads_unpack"].launches == before + 1
    assert torch.equal(x.grad, w.transpose(1, 2).reshape(1, 64, 256))


def _cross_attn_expression(attn, x, context):
    """What ``WanCrossAttention`` computed before the flash kernels, in f32
    from the same bf16 projections: the f32 scores, their softmax and
    P @ V, then the module's output projection."""
    c = attn.c
    b, lq, _ = x.shape

    def heads(t):
        return t.float().reshape(b, t.shape[1], c.num_heads, c.head_dim).transpose(1, 2)

    q = heads(attn.norm_q(attn.to_q(x)))
    k = heads(attn.norm_k(attn.to_k(context)))
    v = heads(attn.to_v(context))
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(c.head_dim), dim=-1)
    return attn.to_out[0]((p @ v).transpose(1, 2).reshape(b, lq, c.dim))


@pytest.mark.parametrize("lq,lk", [(1000, 512), (1000, 77), (256, 512)])
def test_wan_cross_attention_matches_its_f32_expression(dev, lq, lk):
    """Wan's text cross-attention at the 1.3B's width (12 heads of 128), on
    #1 forward and #5/#6 backward: its output and the gradients of x, the
    context and the four projections' weights against the f32 expression it
    replaced, each to ``BWD_REL`` of the reference's largest value."""
    from blade_torch.models.layers import init_lecun_
    from blade_torch.models.wan_dit import WAN_1_3B, WanCrossAttention

    attn = WanCrossAttention(WAN_1_3B, torch.bfloat16)
    with torch.no_grad():
        init_lecun_(attn, torch.Generator().manual_seed(lq + lk))
        for norm in (attn.norm_q, attn.norm_k):
            norm.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(lk))
    attn = attn.to(dev)
    gen = torch.Generator(device=dev).manual_seed(lq * 3 + lk)
    x = _rand(gen, 1, lq, WAN_1_3B.dim, dev=dev).requires_grad_(True)
    context = _rand(gen, 1, lk, WAN_1_3B.dim, dev=dev).requires_grad_(True)
    g_out = _rand(gen, 1, lq, WAN_1_3B.dim, dev=dev)
    wrt = (x, context, attn.to_q.weight, attn.to_k.weight, attn.to_v.weight,
           attn.to_out[0].weight)
    fwd = ("dense_fwd", "heads_pack", "heads_unpack")
    bwd = ("dense_dq", "dense_dkv", "attn_delta", "heads_pack", "heads_unpack")
    before = [_build.KERNELS[n].launches for n in fwd]
    out = attn(x, context)
    torch.cuda.synchronize()
    # One flash forward; q, k and v packed, the output unpacked.
    assert [_build.KERNELS[n].launches - b for n, b in zip(fwd, before)] == [1, 3, 1]
    before = [_build.KERNELS[n].launches for n in bwd]
    got = torch.autograd.grad(out, wrt, g_out)
    torch.cuda.synchronize()
    # The dense pair once, after delta; each relayout's gradient is the other.
    assert [_build.KERNELS[n].launches - b for n, b in zip(bwd, before)] == [1, 1, 1, 1, 3]
    ref = _cross_attn_expression(attn, x, context)
    want = torch.autograd.grad(ref, wrt, g_out)
    assert out.dtype == torch.bfloat16 and out.shape == (1, lq, WAN_1_3B.dim)
    for g, r in zip((out, *got), (ref, *want)):
        assert torch.isfinite(g.float()).all()
        assert _err(g, r) <= BWD_REL * r.float().abs().max().item()


def test_wan_i2v_cross_attention_matches_its_two_softmax_expression(dev):
    """Wan2.1-I2V's cross-attention at the 1.3B's width: the text branch
    over 512 keys and the image branch over 257 on two #1 calls sharing the
    packed q, their outputs summed in bf16, against the f32 expression of
    the two softmaxes (each branch rounded to bf16 before the sum, as the
    JAX model does); q, k, v and the image K/V packed, the sum unpacked."""
    import dataclasses

    from blade_torch.models.layers import init_lecun_
    from blade_torch.models.wan_dit import WAN_1_3B, WanCrossAttention

    c = dataclasses.replace(WAN_1_3B, image_dim=1280)
    attn = WanCrossAttention(c, torch.bfloat16)
    with torch.no_grad():
        init_lecun_(attn, torch.Generator().manual_seed(257))
        for norm in (attn.norm_q, attn.norm_k, attn.norm_added_k):
            norm.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(5))
    attn = attn.to(dev)
    gen = torch.Generator(device=dev).manual_seed(769)
    x = _rand(gen, 1, 1000, c.dim, dev=dev)
    context, image = _rand(gen, 1, 512, c.dim, dev=dev), _rand(gen, 1, 257, c.dim, dev=dev)
    names = ("dense_fwd", "heads_pack", "heads_unpack")
    before = [_build.KERNELS[n].launches for n in names]
    with torch.no_grad():
        out = attn(x, context, image)
        torch.cuda.synchronize()
    assert [_build.KERNELS[n].launches - b for n, b in zip(names, before)] == [2, 5, 1]

    def heads(t):
        return t.float().reshape(1, t.shape[1], c.num_heads, c.head_dim).transpose(1, 2)

    def branch(q, k, v):
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(c.head_dim), dim=-1)
        return (p @ v).transpose(1, 2).reshape(1, -1, c.dim).to(torch.bfloat16)

    with torch.no_grad():
        q = heads(attn.norm_q(attn.to_q(x)))
        text = branch(q, heads(attn.norm_k(attn.to_k(context))), heads(attn.to_v(context)))
        img = branch(q, heads(attn.norm_added_k(attn.add_k_proj(image))),
                     heads(attn.add_v_proj(image)))
        ref = attn.to_out[0](text + img)
        one = torch.cat([attn.norm_k(attn.to_k(context)),
                         attn.norm_added_k(attn.add_k_proj(image))], 1)
        joint = branch(q, heads(one), heads(torch.cat([attn.to_v(context),
                                                       attn.add_v_proj(image)], 1)))
        ref_one = attn.to_out[0](joint)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    tol = BWD_REL * ref.float().abs().max().item()
    assert _err(out, ref) <= tol
    # one softmax over the 769 keys is another function, far past the tolerance
    assert _err(ref_one, ref) > 10 * tol


def test_streaming_encode_matches_the_whole_clip_on_the_card(dev):
    """The Wan VAE encoder at its full widths over a short clip (9 frames of
    64 x 96, TF32 off): frame 0 then 4-frame chunks with the caches carried
    equals the whole-clip encode to f32 rounding."""
    from blade_torch.models import vae_wan as V
    from blade_torch.utils.rng import make_generator

    vae = V.WanVAE(V.WAN21_VAE, encoder=True, device=dev).eval()
    vae.random_init_(make_generator(11, dev))
    gen = torch.Generator(device=dev).manual_seed(12)
    video = torch.rand((1, 9, 64, 96, 3), generator=gen, device=dev) * 2 - 1
    with torch.no_grad():
        streamed, whole = V.streaming_encode(vae, video), vae.encode(video)
    assert streamed.shape == (1, 3, 8, 12, 16)
    assert _err(streamed, whole) <= 1e-4 * whole.abs().max().item()


# Wan's block glue (csrc/adaln.cu): the 1.3B's and the 14B's rows whole, a
# ragged row count at each width (the last CTA's row slots not all filled),
# B = 2 with a modulation row a sample, and the tiny width (a chunk a lane).
@pytest.mark.parametrize("b,s,dim", [
    (1, 32760, 1536), (1, 75600, 5120), (1, 1001, 5120), (1, 333, 1536),
    (2, 503, 1536), (2, 37, 5120), (2, 50, 128),
])
def test_block_glue_kernels_match_plain(dev, b, s, dim):
    """The residual outputs bit for bit (the plain version's roundings, in
    its order); the normed outputs within one bf16 ulp at each row's largest
    value (the LayerNorm's sums in another order can turn one rounding);
    each call one launch of its kernel.  Tables: a row a sample (the
    modulation) and one shared row (the cross-attention LayerNorm's weight
    and bias)."""
    from blade_torch.kernels import adaln

    gen = torch.Generator(device=dev).manual_seed(b * s + dim)
    x, y, y2 = (_rand(gen, b, s, dim, dev=dev) for _ in range(3))
    e = 0.5 * torch.randn((b, 6, dim), generator=gen, device=dev)
    shift, scale, gate = e.unbind(1)[:3]
    w, bias = 1.0 + 0.2 * torch.randn(dim, generator=gen, device=dev), \
        0.1 * torch.randn(dim, generator=gen, device=dev)

    def close(got, want):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        top = torch.maximum(got.float().abs(), want.float().abs()).amax(-1, keepdim=True)
        err = (got.float() - want.float()).abs()
        assert (err <= _bf16_ulp(top)).all(), err.max()

    launches = {n: _build.KERNELS[n].launches for n in
                ("norm_affine", "add_norm_affine", "gated_add")}
    close(adaln.norm_affine(x, 1 + scale, shift, 1e-6),
          adaln.norm_affine_reference(x, 1 + scale, shift, 1e-6))
    close(adaln.norm_affine(x, w, bias, 1e-6), adaln.norm_affine_reference(x, w, bias, 1e-6))
    for g, tw, tb in ((gate, w, bias), (None, 1 + scale, shift)):
        xo, h = adaln.add_norm_affine(x, y, g, tw, tb, 1e-6)
        want_x, want_h = adaln.add_norm_affine_reference(x, y, g, tw, tb, 1e-6)
        assert torch.equal(xo, want_x)
        close(h, want_h)
    assert torch.equal(adaln.gated_add(x, y2, gate), adaln.gated_add_reference(x, y2, gate))
    torch.cuda.synchronize()
    assert {n: _build.KERNELS[n].launches - k for n, k in launches.items()} == {
        "norm_affine": 2, "add_norm_affine": 2, "gated_add": 1}


def test_block_glue_kernels_never_fall_back(dev):
    """A call autograd would record, f32 rows, or a table of the wrong width
    raise: the kernels are forward only and take bf16 rows."""
    from blade_torch.kernels import adaln

    x = torch.randn(1, 4, 128, device=dev, dtype=torch.bfloat16)
    w = torch.ones(1, 128, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        adaln.norm_affine(x, w, w, 1e-6)
    with torch.no_grad():
        adaln.norm_affine(x, w, w, 1e-6)
        with pytest.raises(TypeError):
            adaln.gated_add(x.float(), x.float(), w)
        with pytest.raises(ValueError, match="table"):
            adaln.gated_add(x, x, w[:, :64])


def test_cuda_inputs_never_fall_back(dev):
    q = torch.randn(1, 1, 64, 64, device=dev)  # f32: the kernels take bf16
    with pytest.raises(TypeError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("lane", ["dense", "asa"])
def test_tdm_converges_tiny(dev, lane):
    """Port twin of ``tests/test_tdm.py::test_tdm_converges_tiny`` on the
    card, through the forward and backward kernels (bf16 activations, f32
    parameters): pretrain ``WAN_TINY`` as a flow-matching denoiser on a
    synthetic 4-dim manifold (1000 Adam steps), freeze it as the teacher,
    TDM-distill a K=2 student in full-model mode with the reference's Wan
    settings (eta 0.9, no weighting factor, lambda 0), and assert (a) the
    last-quartile mean of ``loss_du`` over 300 steps is below the first
    quartile's and (b) at one of steps 50, 100 and 150 the student's K-step
    endpoint is closer to the teacher's 30-step UniPC endpoint than 0.75 x
    its distance at init.

    (b) is the reference's criterion read at three checkpoints instead of
    at step 150 alone.  The endpoint over-trains after its minimum, and when
    that starts depends on the pretrained teacher: over five teachers (this
    recipe's seeds and four others; f32, plain path) the step-150 ratio was
    0.60-1.54 while every run reached <= 0.67 by step 50.  The JAX test
    itself behaves the same: from three other teacher seeds its loop gives
    1.33-1.97 at step 150 and 0.67-0.72 at step 50, and from its own
    teacher the port's loop and the JAX loop both give 0.50 at step 150.

    ``dense`` keeps the reference's latents ``[2, 16, 2, 8, 8]`` (32 tokens).
    ``asa`` runs every self-attention as the ASA energy lane (sparse and
    pooled branches, both backward kernel pairs) on ``[2, 16, 4, 32, 32]``
    (1024 tokens, 8 blocks, retain ratio in [0.25, 0.5]); the reference never
    ran this recipe with ASA on.
    """
    first_q, last_q, d_init, dists, losses = _tdm_convergence_run(dev, lane)
    ratios = {step: round(d / d_init, 3) for step, d in dists.items()}
    print(f"tdm_converges_tiny[{lane}]: loss_du first quartile {first_q:.5f} last "
          f"{last_q:.5f} (ratio {last_q / first_q:.3f}); endpoint distance init "
          f"{d_init:.5f}, ratio to it at steps {ratios}")
    assert all(np.isfinite(losses))
    assert last_q < first_q, (first_q, last_q)
    assert min(ratios.values()) < 0.75, ratios


def _tdm_convergence_run(dev, lane, dtype=torch.bfloat16):
    """The recipe of :func:`test_tdm_converges_tiny`; returns the first and
    last quartile means of ``loss_du``, the endpoint distance at init, those
    at steps 50, 100 and 150 (``{step: distance}``), and the losses."""
    from blade_torch.attention.asa import ASAConfig
    from blade_torch.attention.integration import asa_model_kwargs
    from blade_torch.cli.train import model_apply_fn
    from blade_torch.models.wan_dit import WAN_TINY, WanModel
    from blade_torch.sampling.pipeline import FlowUniPC, sample
    from blade_torch.schedulers import unipc_flow as F
    from blade_torch.training import tdm
    from blade_torch.utils.rng import fold_generator, make_generator

    if lane == "dense":
        lat_shape, kwargs = (2, 16, 2, 8, 8), {}
    else:
        lat_shape = (2, 16, 4, 32, 32)
        kwargs = asa_model_kwargs(ASAConfig(
            latent_width=16, latent_height=16, latent_frames=4, sample_gap=4,
            min_retain_ratio=0.25, max_retain_ratio=0.5))
    model = WanModel(WAN_TINY, dtype=dtype, device=dev, **kwargs)
    model.random_init_(make_generator(1, dev))
    single = lat_shape[1:]
    text = torch.randn((2, 8, WAN_TINY.text_dim), generator=make_generator(0, dev), device=dev)
    family = tdm.flow_family(F.flow_training_sigmas(1000, 3.0), device=dev)
    apply = model_apply_fn(model)

    # ---- teacher pretraining: velocity regression on a 4-dim manifold
    basis = torch.randn((4,) + single, generator=make_generator(42, dev), device=dev) * 0.8
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for i in range(1000):
        g = make_generator(7000 + i, dev)
        w = torch.randn((lat_shape[0], 4), generator=fold_generator(g, 1), device=dev) / 2.0
        x0 = torch.einsum("bk,k...->b...", w, basis)
        eps = torch.randn(x0.shape, generator=fold_generator(g, 2), device=dev)
        t = torch.randint(0, 1000, (lat_shape[0],), generator=fold_generator(g, 3), device=dev)
        v = model(family.add_noise(x0, eps, t), t.float(), text,
                  attn_kwargs={"generator": fold_generator(g, 4)})
        loss = torch.mean((v.float() - (eps - x0)) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    model.requires_grad_(False)
    base = {n: p.detach() for n, p in model.named_parameters()}

    # ---- TDM distillation
    cfg = tdm.TDMConfig(k_step=2, eta=0.9, cfg=1.0, lambda_reg=0.0,
                        use_weighting_factor=False, train_full_model=True,
                        lr_generator=2e-4, lr_fake=2e-3)
    state = tdm.create_tdm_state(make_generator(2, dev), base, cfg)
    step = tdm.make_tdm_train_step(apply, family, cfg)

    eval_noise = torch.randn(lat_shape, generator=make_generator(10, dev), device=dev)
    with torch.no_grad():
        teacher = sample(lambda x, t, te, g, **kw: apply(base, x, t, te, g),
                         FlowUniPC(num_steps=30), eval_noise, text,
                         generator=make_generator(11, dev))
    eval_gens = [fold_generator(make_generator(12, dev), k) for k in range(cfg.k_step)]
    eval_xis = [torch.randn(lat_shape, generator=fold_generator(g, 1), device=dev)
                for g in eval_gens]

    def endpoint_dist(params):
        x0s, _ = tdm.k_step_trajectory(apply, params, family, eval_noise, text,
                                       xis=eval_xis, generators=eval_gens,
                                       k_step=cfg.k_step, eta=cfg.eta)
        return float(torch.mean((x0s[-1].float() - teacher) ** 2))

    d_init = endpoint_dist(state.lora_g)  # == the teacher's K-step run
    losses, dists = [], {}
    for i in range(300):
        g = make_generator(100 + i, dev)
        batch = {"text_embeds": text, "uncond_embeds": text * 0,
                 "noise": torch.randn(lat_shape, generator=fold_generator(g, 0), device=dev)}
        state, metrics = step(state, batch, g)
        losses.append(metrics["loss_du"])
        if i + 1 in (50, 100, 150):
            dists[i + 1] = endpoint_dist(state.lora_g)

    q = len(losses) // 4
    return float(np.mean(losses[:q])), float(np.mean(losses[-q:])), d_init, dists, losses
