"""The whole slice, both packages: 4-step ASA sampling + streaming VAE decode.

A small Wan config with head_dim 128 (dim 256, 2 heads, 2 layers) and
``WAN21_VAE_TINY`` over latents ``[1, 16, 4, 30, 32]`` (960 tokens, not a
multiple of 128).  With min = max retain 1.0 the energy mask is all ones
whatever the random draws, so both packages run the full ASA lane (predictor,
sparse branch over a full mask, pooled branch, LSE merge) deterministically
on the same numpy noise and bridged weights.  The JAX side runs its Pallas
kernels in interpret mode.  Both run in f32; the latents and the frames
agree to 1e-4 absolute (measured ~3e-6: float32 rounding accumulated
through 8 DiT passes, the UniPC combinations and ~20 convs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blade import config as jconfig
from blade.models.t5 import T5_TINY
from blade.models.vae_wan import WAN21_VAE_TINY as J_VAE_TINY
from blade.models.vae_wan import WanVAE as JWanVAE
from blade.models.wan_dit import WanConfig as JWanConfig
from blade.models.wan_dit import WanModel as JWanModel
from blade.sampling.pipeline import sample_wan as j_sample_wan
from blade.sampling.t2v import T2VPipeline as JPipeline
from blade_torch import config as tconfig
from blade_torch.convert.from_jax import to_torch, wan_transformer_state_dict, wan_vae_state_dict
from blade_torch.models.vae_wan import WAN21_VAE_TINY as T_VAE_TINY
from blade_torch.models.wan_dit import WanConfig as TWanConfig
from blade_torch.sampling.pipeline import FlowUniPC, sample
from blade_torch.sampling.t2v import T2VPipeline as TPipeline
from blade_torch.utils.rng import make_generator

CFG = dict(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32)
PRESET = dict(name="wan", max_text_len=8, video=None, flow_shift=3.0, sample_gap=30,
              min_retain_ratio=1.0, max_retain_ratio=1.0)
LATENTS = (1, 16, 4, 30, 32)


def _perturbed(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


def test_sparse_sampling_and_streaming_decode_match_jax():
    jcfg = JWanConfig(**CFG)
    jpreset = jconfig.FamilyPreset(
        dit=jcfg, vae=J_VAE_TINY, text=T5_TINY,
        **dict(PRESET, video=jconfig.VideoSpec(7, 60, 64, fps=4)))
    tpreset = tconfig.FamilyPreset(
        dit=TWanConfig(**CFG), vae=T_VAE_TINY, text_dim=CFG["text_dim"],
        **dict(PRESET, video=tconfig.VideoSpec(7, 60, 64, fps=4)))
    assert jpreset.latent_grid() == tpreset.latent_grid() == (4, 15, 16)

    # Params come from the dense model: the ASA model has the same tree.
    dit_params = _perturbed(JWanModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros(LATENTS), jnp.ones((1,)),
        jnp.zeros((1, 8, jcfg.text_dim))), 1)
    jvae = JWanVAE(J_VAE_TINY)
    vae_params = _perturbed(jvae.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, 15, 16, 16)),
                                      method=jvae.decode), 3)
    jpipe = JPipeline(jpreset, dit_params, vae_params, sparse=True, mask_mode="energy",
                      dtype=jnp.float32, interpret=True)

    tpipe = TPipeline.build(tpreset, sparse=True, dtype=torch.float32)
    tpipe.dit.load_state_dict(to_torch(wan_transformer_state_dict(dit_params, 2)))
    tpipe.vae.load_state_dict(to_torch(wan_vae_state_dict(vae_params)))

    rng = np.random.default_rng(4)
    noise = rng.standard_normal(LATENTS).astype(np.float32)
    text = rng.standard_normal((1, 8, CFG["text_dim"])).astype(np.float32)

    jlat = j_sample_wan(jpipe.model_fn(), jnp.asarray(noise), jnp.asarray(text),
                        rng=jax.random.PRNGKey(5), num_steps=4)
    jframes = np.asarray(jpipe.decode_latents(jlat))
    with torch.inference_mode():
        tlat = sample(tpipe.model_fn(), FlowUniPC(num_steps=4), torch.from_numpy(noise),
                      torch.from_numpy(text), generator=make_generator(5))
        tframes = tpipe.decode_latents(tlat)
        u8 = tpipe.frames_to_uint8(tframes)

    assert tframes.shape == jframes.shape == (1, 7, 60, 64, 3)
    assert torch.isfinite(tlat).all()
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tframes.numpy(), jframes, atol=1e-4, rtol=0)
    assert u8.dtype == torch.uint8
    want_u8 = np.asarray(jpipe.frames_to_uint8(jnp.asarray(tframes.numpy())))
    np.testing.assert_array_equal(u8.numpy(), want_u8)
