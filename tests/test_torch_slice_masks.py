"""The whole model at a clamping retain ratio, with JAX's masks replayed.

jax.random bits cannot be reproduced in torch, so at a ratio that clamps
(min 0.05, max 0.2: one block a row plus the two forced columns) the
per-layer masks JAX collects with ``collect_mask=True`` are replayed into
the port and one forward's velocity is compared (f32 both sides, 1e-4
absolute on a velocity of magnitude ~3).  The same small Wan config as
``test_torch_slice.py``: head_dim 128, 960 tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blade import config as jconfig
from blade.models.t5 import T5_TINY
from blade.models.vae_wan import WAN21_VAE_TINY as J_VAE_TINY
from blade.models.wan_dit import WanConfig as JWanConfig
from blade.models.wan_dit import WanModel as JWanModel
from blade.sampling.t2v import T2VPipeline as JPipeline
from blade_torch import config as tconfig
from blade_torch.convert.from_jax import to_torch, wan_transformer_state_dict
from blade_torch.models.vae_wan import WAN21_VAE_TINY as T_VAE_TINY
from blade_torch.models.wan_dit import WanConfig as TWanConfig
from blade_torch.sampling.pipeline import FlowUniPC, sample
from blade_torch.sampling.t2v import T2VPipeline as TPipeline
from blade_torch.utils.rng import make_generator

CFG = dict(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32)
LATENTS = (1, 16, 4, 30, 32)


def _presets(min_retain, max_retain):
    common = dict(name="wan", max_text_len=8, flow_shift=3.0, sample_gap=30,
                  min_retain_ratio=min_retain, max_retain_ratio=max_retain)
    jp = jconfig.FamilyPreset(dit=JWanConfig(**CFG), vae=J_VAE_TINY, text=T5_TINY,
                              video=jconfig.VideoSpec(7, 60, 64, fps=4), **common)
    tp = tconfig.FamilyPreset(dit=TWanConfig(**CFG), vae=T_VAE_TINY, text_dim=64,
                              video=tconfig.VideoSpec(7, 60, 64, fps=4), **common)
    return jp, tp


def _params():
    params = JWanModel(JWanConfig(**CFG), dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros(LATENTS), jnp.ones((1,)), jnp.zeros((1, 8, 64)))
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


def _inputs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(LATENTS).astype(np.float32)
    text = rng.standard_normal((1, 8, 64)).astype(np.float32)
    return x, np.array([750.0], np.float32), text


def test_replayed_jax_masks_give_the_same_velocity():
    jpreset, tpreset = _presets(0.05, 0.2)
    params = _params()
    jpipe = JPipeline(jpreset, params, None, sparse=True, mask_mode="energy",
                      dtype=jnp.float32, interpret=True)
    x, t, text = _inputs()
    jv, jmasks = jpipe.model_fn()(jnp.asarray(x), jnp.asarray(t), jnp.asarray(text),
                                  jax.random.PRNGKey(3), collect_mask=True)
    jmasks = np.array(jmasks)
    assert jmasks.shape == (2, 1, 2, 8, 8)
    assert 0.3 < jmasks.mean() < 0.6  # clamped: 1 block a row + forced last 2

    tpipe = TPipeline.build(tpreset, sparse=True, dtype=torch.float32)
    tpipe.dit.load_state_dict(to_torch(wan_transformer_state_dict(params, 2)))
    fn = tpipe.model_fn()
    with torch.inference_mode():
        tv = fn(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text),
                make_generator(3), masks=torch.from_numpy(jmasks))
        own_v, own_masks = fn(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text),
                              make_generator(3), collect_mask=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
    # the port's own masks (its own draws) have the same shape and clamp
    assert own_masks.shape == jmasks.shape and own_masks.dtype == torch.bool
    assert own_masks[..., :-2, :].sum(-1).max() <= 3 and own_masks[..., -2:, :].all()
    assert torch.isfinite(own_v).all()


def test_mask_reuse_matches_per_step_prediction_at_full_retention():
    _, tpreset = _presets(1.0, 1.0)
    tpipe = TPipeline.random_init(tpreset, make_generator(4), dtype=torch.float32)
    x, _, text = _inputs()
    with torch.inference_mode():
        runs = [sample(tpipe.model_fn(), FlowUniPC(num_steps=3), torch.from_numpy(x),
                       torch.from_numpy(text), generator=make_generator(5), mask_refresh_every=n)
                for n in (0, 2)]
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
