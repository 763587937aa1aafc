"""The port's ASA energy lane against the JAX package, on the CPU.

Gilbert permutations, padding, token sampling, masks and lists are compared
exactly.  Where JAX draws random bits, the test recomputes JAX's offsets
from the same key (``split``, ``uniform``, ``top_k`` as in
``masks.sample_block_tokens``) and injects them into the port.  Attention
outputs are f32 on both sides: 2e-5 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.attention import asa as jasa
from blade.attention import gilbert as jgil
from blade.attention import masks as jmasks
from blade_torch.attention import asa as tasa
from blade_torch.attention import gilbert as tgil
from blade_torch.attention import masks as tmasks
from blade_torch.attention.integration import asa_model_kwargs, make_asa_attention_fn
from blade_torch.utils.rng import make_generator

ATOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs():
    base = dict(latent_width=8, latent_height=8, latent_frames=12, sample_gap=30,
                min_retain_ratio=0.05, max_retain_ratio=0.2, sample_tokens_per_block=16)
    return jasa.ASAConfig(predictor="sum", **base), tasa.ASAConfig(**base)


def _jax_offsets(rng, b, h, block, keep):
    _, offs = jax.lax.top_k(jax.random.uniform(rng, (b, h, block)), keep)
    return _t(offs)


@pytest.mark.parametrize("whd", [(52, 30, 21), (16, 15, 4), (7, 5, 3), (1, 9, 2)])
def test_gilbert_permutations_bit_exact(whd):
    jp, ji = jgil.gilbert_permutations(*whd)
    tp, ti = tgil.gilbert_permutations(*whd)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("text_length", [0, 5])
def test_rearrange_roundtrip_matches_jax(text_length):
    perm, inv = tgil.gilbert_permutations(4, 3, 2)
    x = np.random.default_rng(0).standard_normal((1, 2, text_length + 24, 8)).astype(np.float32)
    want = jgil.rearrange_tokens(x, perm, text_length)
    got = tgil.rearrange_tokens(_t(x), perm, text_length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tgil.unrearrange_tokens(got, inv, text_length).numpy(), x)


def test_pad_and_sample_tokens_with_injected_offsets():
    x = np.random.default_rng(1).standard_normal((1, 2, 300, 16)).astype(np.float32)
    xp = jmasks.pad_to_block_multiple(x, 128)
    np.testing.assert_array_equal(tmasks.pad_to_block_multiple(_t(x), 128).numpy(),
                                  np.asarray(xp))
    rng = jax.random.PRNGKey(3)
    want = jmasks.sample_block_tokens(rng, xp, 128, 16)
    got = tmasks.sample_block_tokens(_t(xp), 128, 16,
                                     offsets=_jax_offsets(rng, 1, 2, 128, 16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = tmasks.sample_block_tokens(_t(xp), 128, 16, generator=make_generator(0))
    assert drawn.shape == got.shape


@pytest.mark.parametrize("ratios", [(0.05, 0.2), (0.25, 1.0), "per_head"])
def test_energy_mask_matches_jax(ratios):
    rng = np.random.default_rng(2)
    scores = rng.random((1, 3, 20, 20)).astype(np.float32) ** 4
    scores /= scores.sum(-1, keepdims=True)
    if ratios == "per_head":
        lo = np.array([[0.05, 0.1, 0.3]], np.float32)
        hi = np.array([[0.2, 0.5, 1.0]], np.float32)
        want = jmasks.energy_mask(scores, min_retain_ratio=jnp.asarray(lo),
                                  max_retain_ratio=jnp.asarray(hi))
        got = tmasks.energy_mask(_t(scores), min_retain_ratio=_t(lo), max_retain_ratio=_t(hi))
    else:
        want = jmasks.energy_mask(scores, min_retain_ratio=ratios[0],
                                  max_retain_ratio=ratios[1])
        got = tmasks.energy_mask(_t(scores), min_retain_ratio=ratios[0],
                                 max_retain_ratio=ratios[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[..., -2:, :].all() and got[..., :, -2:].all()


def test_mask_lists_and_density_match_jax():
    mask = np.random.default_rng(4).random((2, 3, 9, 11)) > 0.6
    mask[0, 0, 3] = False  # empty row
    mask[1, 2, 5] = True  # full row
    ji, jc = jmasks.mask_to_block_lists(mask)
    ti, tc = tmasks.mask_to_block_lists(_t(mask))
    assert ti.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(tmasks.mask_density(_t(mask))) == pytest.approx(
        float(jmasks.mask_density(mask)), abs=1e-7)


def test_predictor_with_injected_offsets_matches_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 2, 768, 128)).astype(np.float32)
    k = rng.standard_normal((1, 2, 768, 128)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jasa.predict_block_scores(key, q, k, jcfg)
    rq, rk = jax.random.split(key)
    offs = (_jax_offsets(rq, 1, 2, 128, 16), _jax_offsets(rk, 1, 2, 128, 16))
    got = tasa.predict_block_scores(_t(q), _t(k), tcfg, offsets=offs)
    assert got.dtype == torch.float32 and got.shape == (1, 2, 6, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("replay", [False, True])
def test_asa_attention_matches_jax(replay):
    """Full chain (rearrange, predictor, energy mask, sparse + pooled merge)
    with injected offsets; or with JAX's mask replayed into the port."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 2, 768, 128)).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(11)
    jout, jsp, jmask = jasa.asa_attention(key, q, k, v, jcfg, interpret=True,
                                          return_mask=True)
    if replay:
        out, sp, mask = tasa.asa_attention(_t(q), _t(k), _t(v), tcfg,
                                           mask=_t(jmask), return_mask=True)
    else:
        rq, rk = jax.random.split(key)
        offs = (_jax_offsets(rq, 1, 2, 128, 16), _jax_offsets(rk, 1, 2, 128, 16))
        out, sp, mask = tasa.asa_attention(_t(q), _t(k), _t(v), tcfg, offsets=offs,
                                           return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert not mask.all()  # the clamp made it sparse
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    assert float(sp) == pytest.approx(float(jsp), abs=1e-6)


def test_attention_fn_collect_then_replay_is_exact():
    _, tcfg = _cfgs()
    kw = asa_model_kwargs(tcfg)
    perm, inv = kw["token_perm"]
    assert np.array_equal(perm, tcfg.permutations()[0])
    fn = kw["attention_fn"]
    rng = np.random.default_rng(8)
    q, k, v = (_t(rng.standard_normal((1, 2, 768, 128)).astype(np.float32))
               for _ in range(3))
    gen = make_generator(5)
    out1, mask = fn(q, k, v, generator=gen, layer_index=3, collect_mask=True)
    out2 = fn(q, k, v, generator=make_generator(99), layer_index=0,
              masks=torch.stack([mask] * 4))
    torch.testing.assert_close(out1, out2, atol=0, rtol=0)
    # same generator and layer -> same draws; another layer -> other draws
    again, mask_again = fn(q, k, v, generator=make_generator(5), layer_index=3,
                           collect_mask=True)
    assert torch.equal(mask_again, mask) and torch.equal(again, out1)
    direct = make_asa_attention_fn(dataclasses.replace(tcfg, pre_arranged=True))
    torch.testing.assert_close(direct(q, k, v, generator=gen, layer_index=3), out1)
