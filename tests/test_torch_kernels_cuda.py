"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skipped without a GPU.  On the card run
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q``
(``--noconftest`` because the suite's conftest imports JAX, which the port's
machines need not have).  Inputs are bf16 on the card, as on the main path.
Tolerances: attention outputs 2e-2 absolute (bf16 output rounding and the
kernel's bf16 P @ V at |out| <~ 4), lse 5e-3 (f32 sums in another order),
norm_rope 2e-2 (bf16 output rounding), pack bit for bit.
"""

import math

import pytest
import torch

from blade_torch.kernels import _build
from blade_torch.kernels.block_sparse_attn import (
    block_sparse_attention,
    flash_attention,
    flash_attention_wide_v,
)
from blade_torch.kernels.norm_rope import _norm_rope_reference, norm_rope_heads
from blade_torch.kernels.pack import _pack_kv_reference, pack_kv
from blade_torch.kernels.ref_attention import (
    NEG_INF,
    block_masked_attention,
    dense_attention_with_lse,
)

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


@pytest.mark.parametrize("lq,lk,d,dv,bias", [
    (200, 300, 128, 128, math.log(30.0)),
    (1000, 37, 128, 128, 0.0),
    (256, 256, 128, 256, 0.0),
    (130, 70, 64, 64, 0.5),
    (128, 256, 64, 128, 0.0),
])
def test_dense_kernel_matches_plain(dev, lq, lk, d, dv, bias):
    gen = torch.Generator(device=dev).manual_seed(lq + lk + d + dv)
    q, k = _rand(gen, 1, 3, lq, d, dev=dev), _rand(gen, 1, 3, lk, d, dev=dev)
    v = _rand(gen, 1, 3, lk, dv, dev=dev)
    fn = flash_attention if dv == d else flash_attention_wide_v
    before = _build.KERNELS["dense_fwd"].launches
    out, lse = fn(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert _build.KERNELS["dense_fwd"].launches == before + 1
    ref_out, ref_lse = dense_attention_with_lse(q, k, v, bias=bias)
    assert out.shape == (1, 3, lq, dv) and lse.dtype == torch.float32
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, ref_lse) <= LSE_TOL


@pytest.mark.parametrize("lq,lk,d", [(300, 330, 128), (512, 512, 128), (260, 200, 64)])
def test_sparse_kernel_matches_plain(dev, lq, lk, d):
    gen = torch.Generator(device=dev).manual_seed(lq * lk + d)
    q, k, v = (_rand(gen, 2, 2, n, d, dev=dev) for n in (lq, lk, lk))
    n_qt, n_kt = -(-lq // 128), -(-lk // 128)
    mask = torch.rand((2, 2, n_qt, n_kt), generator=gen, device=dev) > 0.5
    mask[..., -1] = True  # the ragged tail block
    mask[0, 1, 1] = False  # an empty row
    before = _build.KERNELS["sparse_fwd"].launches
    out, lse = block_sparse_attention(q, k, v, mask, bias=0.25)
    torch.cuda.synchronize()
    assert _build.KERNELS["sparse_fwd"].launches == before + 1
    ref_out, ref_lse = block_masked_attention(q, k, v, mask, block_k=128, bias=0.25)
    assert _err(out, ref_out) <= OUT_TOL
    assert _err(lse, ref_lse) <= LSE_TOL
    assert out[0, 1, 128:256].abs().max().item() == 0.0
    assert lse[0, 1, 128:256].max().item() == torch.tensor(NEG_INF).item()


@pytest.mark.parametrize("lk,d", [(2048, 128), (1000, 128), (333, 64)])
def test_pack_kernel_bit_exact(dev, lk, d):
    gen = torch.Generator(device=dev).manual_seed(lk + d)
    k, v = _rand(gen, 3, lk, d, dev=dev), _rand(gen, 3, lk, d, dev=dev)
    got = pack_kv(k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, _pack_kv_reference(k, v))


@pytest.mark.parametrize("s,dim,heads", [(504, 1536, 12), (100, 256, 2), (64, 128, 2)])
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
    q = torch.randn(1, 1, 64, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, q, q)
    with torch.no_grad():
        flash_attention(q, q, q)


def test_cuda_inputs_never_fall_back(dev):
    q = torch.randn(1, 1, 64, 64, device=dev)  # f32: the kernels take bf16
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
