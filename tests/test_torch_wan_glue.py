"""Wan's block glue on the row kernels' route (``kernels/adaln.py``), on the CPU.

The Wan block runs its LayerNorms, modulation and residual adds as
``norm_affine`` / ``add_norm_affine`` / ``gated_add`` where autograd records
nothing, and as their plain versions otherwise; CPU tensors take the plain
versions on both routes.  Both routes must equal, bit for bit, the
expression the block wrote before the kernels (``_expression_forward``
below: each step its own torch operation), for the block outputs, the head,
and a gradient under ``enable_grad``, at the tiny text-to-video and
image-to-video configurations, in bf16 (the card's residual stream) and in
f32, at batch 2 with a timestep a sample (a modulation row a sample).
"""

import pytest
import torch
import torch.nn.functional as F

from blade_torch.kernels import adaln
from blade_torch.models.wan_dit import WAN_I2V_TINY, WAN_TINY, WanModel
from blade_torch.utils.rng import make_generator

CONFIGS = {"t2v": WAN_TINY, "i2v": WAN_I2V_TINY}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _expression_block(blk, x, context, temb6, cos, sin, attention_fn, attn_kwargs,
                      image_context=None):
    """``WanBlock.forward`` as each step of its glue in f32, one torch
    operation a step."""
    c, dtype = blk.c, x.dtype
    e = (blk.scale_shift_table + temb6).float()
    shift1, scale1, gate1, shift2, scale2, gate2 = (e[:, i:i + 1] for i in range(6))
    h = F.layer_norm(x.float(), x.shape[-1:], eps=c.eps) * (1 + scale1) + shift1
    attn, _ = blk.attn1(h.to(dtype), cos, sin, attention_fn, attn_kwargs)
    x = x + (gate1 * attn.float()).to(dtype)
    n2 = blk.norm2
    norm_x = F.layer_norm(x.float(), (c.dim,), n2.weight.float(), n2.bias.float(), n2.eps)
    x = x + blk.attn2(norm_x.to(dtype), context, image_context).to(dtype)
    h = (F.layer_norm(x.float(), x.shape[-1:], eps=c.eps) * (1 + scale2) + shift2).to(dtype)
    f = blk.ffn(h)
    return x + (gate2 * f.float()).to(dtype)


def _expression_forward(model, latents, timestep, text_embeds, image_embeds=None,
                        condition=None):
    """``WanModel.forward`` (no token permutation, dense attention) with the
    blocks and the head in the expression; returns the velocity and every
    block's output."""
    c = model.cfg
    b, _, t, h, w = latents.shape
    pt, ph, pw = c.patch_size
    gt, gh, gw = t // pt, h // ph, w // pw
    if condition is not None:
        latents = torch.cat([latents, condition.to(latents.dtype)], dim=1)
    x = model._patchify(latents)
    ce = model.condition_embedder
    ctx = ce.text_embedder(text_embeds.to(model.dtype))
    temb = ce.time_embedder(timestep)
    temb6 = ce.time_proj(F.silu(temb)).reshape(b, 6, c.dim)
    cos, sin = model._rope_tables((gt, gh, gw), latents.device)
    img = None if image_embeds is None else ce.image_embedder(image_embeds).to(model.dtype)
    outs = []
    for i, blk in enumerate(model.blocks):
        x = _expression_block(blk, x, ctx, temb6, cos, sin, model.attention_fn,
                              {"layer_index": i}, img)
        outs.append(x)
    e = (model.scale_shift_table + temb[:, None, :]).float()
    shift, scale = e[:, 0:1], e[:, 1:2]
    xh = F.layer_norm(x.float(), x.shape[-1:], eps=c.eps) * (1 + scale) + shift
    out = model.proj_out(xh.to(model.dtype).float())
    out = out.reshape(b, gt, gh, gw, pt, ph, pw, c.out_channels)
    return out.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(b, c.out_channels, t, h, w), outs


def _model_and_inputs(config, dtype):
    cfg = CONFIGS[config]
    model = WanModel(cfg, dtype=dtype).random_init_(make_generator(31))
    g = make_generator(32)
    # the norms' weights and biases off their init, so the affine is exercised
    with torch.no_grad():
        for blk in model.blocks:
            blk.norm2.weight.add_(0.1 * torch.randn(cfg.dim, generator=g))
            blk.norm2.bias.add_(0.1 * torch.randn(cfg.dim, generator=g))
    inputs = {"latents": torch.randn((2, cfg.out_channels, 2, 8, 8), generator=g),
              "timestep": torch.tensor([900.0, 250.0]),
              "text_embeds": torch.randn((2, 12, cfg.text_dim), generator=g)}
    if cfg.image_dim is not None:
        inputs["image_embeds"] = torch.randn((2, cfg.image_context_tokens, cfg.image_dim),
                                             generator=g)
        inputs["condition"] = torch.randn((2, cfg.in_channels - cfg.out_channels, 2, 8, 8),
                                          generator=g)
    return model, inputs


def _block_outputs(model):
    outs = []
    for blk in model.blocks:
        blk.register_forward_hook(lambda m, a, o: outs.append(o[0]))
    return outs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_a_no_grad_forward_equals_the_expression_bit_for_bit(config, dtype):
    model, inputs = _model_and_inputs(config, DTYPES[dtype])
    outs = _block_outputs(model)
    with torch.no_grad():
        got = model(**inputs)
        want, want_outs = _expression_forward(model, **inputs)
    assert len(outs) == len(want_outs) == model.cfg.num_layers
    for o, w in zip(outs, want_outs):
        assert o.dtype == DTYPES[dtype] and torch.equal(o, w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_a_gradient_forward_equals_the_expression_bit_for_bit(config, dtype):
    model, inputs = _model_and_inputs(config, DTYPES[dtype])
    cot = torch.randn(inputs["latents"].shape, generator=make_generator(33))

    def grads(fn):
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            latents = inputs["latents"].clone().requires_grad_(True)
            out = fn(dict(inputs, latents=latents))
            (out.float() * cot).sum().backward()
        return out.detach(), latents.grad, {n: p.grad for n, p in model.named_parameters()}

    got, got_dx, got_dp = grads(lambda kw: model(**kw))
    want, want_dx, want_dp = grads(lambda kw: _expression_forward(model, **kw)[0])
    assert torch.equal(got, want) and torch.equal(got_dx, want_dx)
    assert got_dp.keys() == want_dp.keys()
    for name, g in got_dp.items():
        assert g is not None and torch.equal(g, want_dp[name]), name


def test_the_plain_versions_are_the_expression():
    """A ``[B, D]`` table modulates after the LayerNorm; a ``[D]`` one is
    ``F.layer_norm``'s own affine; the gated add rounds the product first."""
    g = make_generator(34)
    x, y = (torch.randn((2, 5, 16), generator=g).to(torch.bfloat16) for _ in range(2))
    w, b, gate = (torch.randn((2, 16), generator=g) for _ in range(3))
    ln = F.layer_norm(x.float(), (16,), eps=1e-6)
    want = (ln * w[:, None] + b[:, None]).to(torch.bfloat16)
    assert torch.equal(adaln.norm_affine(x, w, b, 1e-6), want)
    want = F.layer_norm(x.float(), (16,), w[0], b[0], 1e-6).to(torch.bfloat16)
    assert torch.equal(adaln.norm_affine(x, w[0], b[0], 1e-6), want)
    summed = x + (gate[:, None] * y.float()).to(torch.bfloat16)
    assert torch.equal(adaln.gated_add(x, y, gate), summed)
    xo, h = adaln.add_norm_affine(x, y, gate, w[0], b[0], 1e-6)
    assert torch.equal(xo, summed)
    assert torch.equal(h, adaln.norm_affine_reference(summed, w[0], b[0], 1e-6))
    xo, h = adaln.add_norm_affine(x, y, None, w, b, 1e-6)
    assert torch.equal(xo, x + y) and torch.equal(h, adaln.norm_affine(x + y, w, b, 1e-6))
    with pytest.raises(ValueError, match="one \\[B, S, D\\] shape"):
        adaln.gated_add(x, y[:, :4], gate)
