"""The Wan slice on the per-level multilevel lane, both packages: 3 UniPC
flow steps with ``--mask_mode multilevel``, then the streaming Wan VAE decode.

A tiny Wan with head dim 32 (dim 128, 4 heads, 2 layers): the fused lane
takes d in {64, 128} only, so both packages pick the per-level lane with no
override, as Wan2.1-14B 720p does with its 591 key blocks.  Latents
``[1, 16, 4, 30, 30]``: 900 tokens in 8 key blocks, ragged (the last pooled
row at level 8 mixes real and edge-repeated tokens).  JAX runs its
mask-reuse stepper (refresh on every step) with its Pallas kernels in
interpret mode and collects each step's per-layer int level masks; the port
replays them (jax.random's draws cannot be reproduced).  Both run in f32
on the same numpy noise and bridged weights; latents and frames agree to
1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blade import config as jconfig
from blade.kernels.multilevel_attn import fused_supported as j_fused_supported
from blade.models.t5 import T5_TINY
from blade.models.vae_wan import WAN21_VAE_TINY as J_VAE_TINY
from blade.models.wan_dit import WanConfig as JWanConfig
from blade.models.wan_dit import WanModel as JWanModel
from blade.models.vae_wan import WanVAE as JWanVAE
from blade.sampling.pipeline import wan_stepper_reuse as j_stepper
from blade.sampling.t2v import T2VPipeline as JPipeline
from blade_torch import config as tconfig
from blade_torch.attention.integration import layer_mask, stack_masks
from blade_torch.convert.from_jax import to_torch, wan_transformer_state_dict, wan_vae_state_dict
from blade_torch.kernels.multilevel_attn import fused_supported as t_fused_supported
from blade_torch.models.vae_wan import WAN21_VAE_TINY as T_VAE_TINY
from blade_torch.models.wan_dit import WanConfig as TWanConfig
from blade_torch.sampling.pipeline import FlowUniPC
from blade_torch.sampling.pipeline import step as t_step
from blade_torch.sampling.t2v import T2VPipeline as TPipeline
from blade_torch.utils.rng import make_generator

CFG = dict(dim=128, ffn_dim=256, num_layers=2, num_heads=4, text_dim=64, freq_dim=32)
LATENTS = (1, 16, 4, 30, 30)
STEPS = 3
PRESET = dict(name="wan", max_text_len=8, flow_shift=5.0, sample_gap=30,
              min_retain_ratio=0.05, max_retain_ratio=0.2)


def _perturbed(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


def _pipelines():
    video = dict(video=jconfig.VideoSpec(7, 60, 60, fps=4))
    jpreset = jconfig.FamilyPreset(dit=JWanConfig(**CFG), vae=J_VAE_TINY, text=T5_TINY,
                                   **video, **PRESET)
    tpreset = tconfig.FamilyPreset(dit=TWanConfig(**CFG), vae=T_VAE_TINY, text_dim=64,
                                   video=tconfig.VideoSpec(7, 60, 60, fps=4), **PRESET)
    assert jpreset.latent_grid() == tpreset.latent_grid() == (4, 15, 15)
    assert not j_fused_supported(32, 900, 4) and not t_fused_supported(32, 900, 4)
    dit_params = _perturbed(JWanModel(JWanConfig(**CFG), dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros(LATENTS), jnp.ones((1,)), jnp.zeros((1, 8, 64))), 1)
    jvae = JWanVAE(J_VAE_TINY)
    vae_params = _perturbed(jvae.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, 15, 15, 16)),
                                      method=jvae.decode), 3)
    jpipe = JPipeline(jpreset, dit_params, vae_params, sparse=True, mask_mode="multilevel",
                      dtype=jnp.float32, interpret=True)
    tpipe = TPipeline.build(tpreset, sparse=True, mask_mode="multilevel", dtype=torch.float32)
    tpipe.dit.load_state_dict(to_torch(wan_transformer_state_dict(dit_params, 2)))
    tpipe.vae.load_state_dict(to_torch(wan_vae_state_dict(vae_params)))
    return jpipe, tpipe


def test_per_level_sampling_and_decode_match_jax():
    jpipe, tpipe = _pipelines()
    rng = np.random.default_rng(4)
    noise = rng.standard_normal(LATENTS).astype(np.float32)
    text = rng.standard_normal((1, 8, 64)).astype(np.float32)
    key = jax.random.PRNGKey(5)

    j_init, j_refresh, _ = j_stepper(jpipe.model_fn(), num_steps=STEPS, flow_shift=5.0)
    solver = FlowUniPC(num_steps=STEPS, flow_shift=5.0)
    j_refresh = jax.jit(j_refresh)
    jstate, tstate = j_init(jnp.asarray(noise)), solver.init(torch.from_numpy(noise))
    ttext, gen = torch.from_numpy(text), make_generator(5)
    for i in range(STEPS):
        jstate, levels = j_refresh(jstate, jnp.int32(i), jnp.asarray(text), key)
        levels = torch.from_numpy(np.array(levels))
        # [layer, B, H, 128-row mask rows, key blocks]: every level occurs
        assert levels.shape == (2, 1, 4, 8, 8) and levels.dtype == torch.int32
        assert set(levels.unique().tolist()) == {0, 1, 2, 4, 8}
        with torch.inference_mode():
            tstate = t_step(tpipe.model_fn(), solver, tstate, i, ttext, gen, masks=levels)
    jlat, tlat = jstate.x, tstate.x
    jframes = np.asarray(jpipe.decode_latents(jlat))
    with torch.inference_mode():
        tframes = tpipe.decode_latents(tlat)
    assert tframes.shape == jframes.shape == (1, 7, 60, 60, 3)
    assert torch.isfinite(tlat).all()
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tframes.numpy(), jframes, atol=1e-4, rtol=0)


def test_int_mask_stack_replays_through_the_model():
    """The port's own int level masks, collected with ``collect_mask`` and
    stacked per layer (``stack_masks``), replay through ``layer_mask`` to the
    same velocity."""
    _, tpipe = _pipelines()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(LATENTS).astype(np.float32))
    text = torch.from_numpy(rng.standard_normal((1, 8, 64)).astype(np.float32))
    t = torch.tensor([700.0])
    fn = tpipe.model_fn()
    with torch.inference_mode():
        v, masks = fn(x, t, text, make_generator(7), collect_mask=True)
        replayed = fn(x, t, text, make_generator(99), masks=masks)
    assert masks.shape == (2, 1, 4, 8, 8) and masks.dtype == torch.int32
    assert torch.equal(stack_masks([layer_mask(masks, i) for i in range(2)]), masks)
    assert torch.isfinite(v).all()
    torch.testing.assert_close(replayed, v, atol=0, rtol=0)
