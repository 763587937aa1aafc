"""CogVideoX's q/k lane (``kernels/qk_norm_rope.py``) on the CPU.

* ``qk_norm_rope`` on CPU tensors equals, bit for bit, the composition that
  ``CogJointAttention`` wrote before it (head split, the permuted per-head
  LayerNorm, the cast, RoPE on the video slice and ``cat``), in both text
  orders, and so does its gradient in the projections and the norms'
  parameters.
* A ``COGVIDEOX_TINY`` forward under a CPU ``torch.profiler`` counts one
  ``dit.qk_norm_rope.calls`` a layer; with remat, a backward's recomputed
  blocks count as ``dit.qk_norm_rope.recomputed_calls`` alone.
* Bad shapes are refused.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blade_torch.kernels.qk_norm_rope import qk_norm_rope
from blade_torch.models.cogvideox_dit import COGVIDEOX_TINY, CogVideoXModel
from blade_torch.models.layers import PermutedLayerNorm, apply_rope_half, deinterleave_perm
from blade_torch.utils import tracing
from blade_torch.utils.rng import make_generator

D = 64


def _composition_before(q_proj, k_proj, norm_q, norm_k, cos, sin, heads, n_txt, text_last):
    """``CogJointAttention``'s q/k lane as it was written in the model."""
    b, l, _ = q_proj.shape
    n_vid = l - n_txt
    vid = slice(0, n_vid) if text_last else slice(n_txt, l)

    def heads_of(t):
        return t.reshape(b, l, heads, D).transpose(1, 2)

    def rope_segment(t):
        t_vid = apply_rope_half(t[:, :, vid], cos, sin)
        if text_last:
            return torch.cat([t_vid, t[:, :, n_vid:]], dim=2)
        return torch.cat([t[:, :, :n_txt], t_vid], dim=2)

    q = rope_segment(norm_q(heads_of(q_proj)).to(q_proj.dtype))
    k = rope_segment(norm_k(heads_of(k_proj)).to(k_proj.dtype))
    return q, k


def _inputs(b, heads, n_txt, n_vid, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    l = n_txt + n_vid
    q_proj = (2.0 * torch.randn(b, l, heads * D, generator=g) + 0.5).to(dtype)
    k_proj = (torch.randn(b, l, heads * D, generator=g) - 0.3).to(dtype)
    norms = []
    for _ in range(2):
        norm = PermutedLayerNorm(D, deinterleave_perm(1, D), eps=1e-6)
        with torch.no_grad():
            norm.weight.copy_(1.0 + 0.2 * torch.randn(D, generator=g))
            norm.bias.copy_(0.1 * torch.randn(D, generator=g))
        norms.append(norm)
    ang = 6.0 * torch.rand(n_vid, D // 2, generator=g)
    return q_proj, k_proj, norms, torch.cos(ang), torch.sin(ang)


def _lane(q_proj, k_proj, norm_q, norm_k, cos, sin, heads, n_txt, text_last):
    n_vid = q_proj.shape[1] - n_txt
    return qk_norm_rope(q_proj, k_proj, norm_q.weight, norm_q.bias, norm_k.weight,
                        norm_k.bias, cos, sin, heads, 0 if text_last else n_txt, n_vid)


@pytest.mark.parametrize("text_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_equals_the_composition_it_replaces_bit_for_bit(text_last, dtype):
    q_proj, k_proj, (nq, nk), cos, sin = _inputs(2, 3, 5, 40, dtype, seed=1)
    got = _lane(q_proj, k_proj, nq, nk, cos, sin, 3, 5, text_last)
    want = _composition_before(q_proj, k_proj, nq, nk, cos, sin, 3, 5, text_last)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (2, 3, 45, D)
        assert torch.equal(g, w)


@pytest.mark.parametrize("text_last", [False, True])
def test_cpu_gradient_equals_the_compositions_bit_for_bit(text_last):
    q_proj, k_proj, (nq, nk), cos, sin = _inputs(1, 2, 7, 33, torch.bfloat16, seed=2)
    g = torch.Generator().manual_seed(3)
    cot = [torch.randn(1, 2, 40, D, generator=g).to(torch.bfloat16) for _ in range(2)]
    grads = []
    for fn in (_lane, _composition_before):
        leaves = [q_proj.detach().requires_grad_(True), k_proj.detach().requires_grad_(True)]
        params = list(nq.parameters()) + list(nk.parameters())
        out = fn(*leaves, nq, nk, cos, sin, 2, 7, text_last)
        grads.append(torch.autograd.grad(out, leaves + params, cot))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert all(bool(gr.abs().sum() > 0) for gr in grads[0])


def _counted_forward(remat):
    model = CogVideoXModel(COGVIDEOX_TINY, dtype=torch.float32, remat=remat)
    model.random_init_(make_generator(5))
    g = torch.Generator().manual_seed(6)
    lat = torch.randn(1, 2, 16, 8, 8, generator=g)
    text = torch.randn(1, 4, COGVIDEOX_TINY.text_embed_dim, generator=g)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = model(lat, torch.tensor([500.0]), text)
        if remat:
            out.square().mean().backward()
    got = tracing.counters()
    tracing.reset()
    return got


def test_tiny_forward_counts_one_call_a_layer_under_the_profiler():
    got = _counted_forward(remat=False)
    assert got["dit.qk_norm_rope.calls"] == COGVIDEOX_TINY.num_layers
    assert "dit.qk_norm_rope.recomputed_calls" not in got


def test_remat_backward_counts_its_recomputed_blocks_apart():
    got = _counted_forward(remat=True)
    assert got["dit.qk_norm_rope.calls"] == COGVIDEOX_TINY.num_layers
    assert got["dit.qk_norm_rope.recomputed_calls"] == COGVIDEOX_TINY.num_layers


@pytest.mark.parametrize("change", ["heads", "weight", "rows", "table"])
def test_bad_shapes_are_refused(change):
    q_proj, k_proj, (nq, nk), cos, sin = _inputs(1, 2, 3, 10, torch.float32, seed=4)
    args = dict(q_weight=nq.weight, q_bias=nq.bias, k_weight=nk.weight, k_bias=nk.bias,
                cos=cos, sin=sin, num_heads=2, vid_start=3, n_vid=10)
    args.update({"heads": dict(num_heads=3), "weight": dict(q_weight=nq.weight[:32]),
                 "rows": dict(vid_start=4), "table": dict(cos=cos[:9])}[change])
    with pytest.raises(ValueError):
        qk_norm_rope(q_proj, k_proj, **args)
