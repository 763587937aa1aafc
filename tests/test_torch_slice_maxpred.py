"""The Wan slice with the reference-parity "max" predictor, both packages.

The preset fields ``asa_predictor="max", asa_sample_tokens=32`` on a small
Wan (head_dim 128, dim 256, 2 heads, 2 layers) over latents ``[1, 16, 4, 30,
32]``: 960 tokens in 8 key blocks (the sampled K, 256 rows, is not a
multiple of the TPU kernel's 512-column tile).  The retain ratios clamp
(min 0.05, max 0.2: the top block a row plus the two forced columns), so
every mask depends on the predictor.  jax.random's draws cannot be
reproduced in torch, so both packages' token subsampling takes one fixed
offset set (JAX's ``masks.sample_block_tokens`` and the port's
``masks.sample_offsets`` patched for the test); every predictor call then
runs for real on both sides: JAX's Pallas pooled-scores kernel in interpret
mode, the port's plain version.  f32 both sides: one forward's masks agree
bit for bit and its velocity to 1e-4; 2 UniPC steps and the streaming decode
to 1e-4 (as the other slices).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade import config as jconfig
from blade.attention import masks as jmasks
from blade.models.t5 import T5_TINY
from blade.models.vae_wan import WAN21_VAE_TINY as J_VAE_TINY
from blade.models.vae_wan import WanVAE as JWanVAE
from blade.models.wan_dit import WanConfig as JWanConfig
from blade.models.wan_dit import WanModel as JWanModel
from blade.sampling.pipeline import sample_wan as j_sample_wan
from blade.sampling.t2v import T2VPipeline as JPipeline
from blade_torch import config as tconfig
from blade_torch.attention import masks as tmasks
from blade_torch.convert.from_jax import to_torch, wan_transformer_state_dict, wan_vae_state_dict
from blade_torch.models.vae_wan import WAN21_VAE_TINY as T_VAE_TINY
from blade_torch.models.wan_dit import WanConfig as TWanConfig
from blade_torch.sampling.pipeline import FlowUniPC, sample
from blade_torch.sampling.t2v import T2VPipeline as TPipeline
from blade_torch.utils.rng import make_generator

CFG = dict(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32)
PRESET = dict(name="wan", max_text_len=8, flow_shift=3.0, sample_gap=30,
              min_retain_ratio=0.05, max_retain_ratio=0.2, asa_predictor="max",
              asa_sample_tokens=32)
LATENTS = (1, 16, 4, 30, 32)
OFFSETS = np.random.default_rng(9).permutation(128)[:32]


def _perturbed(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


@pytest.fixture
def pipelines(monkeypatch):
    def j_fixed(rng, x, block=128, num_keep=32):
        b, h, length, d = x.shape
        xb = x.reshape(b, h, length // block, block, d)
        return xb[:, :, :, OFFSETS, :].reshape(b, h, -1, d)

    def t_fixed(b, h, block, num_keep, *, generator, device):
        return torch.from_numpy(OFFSETS).to(device).expand(b, h, num_keep)

    monkeypatch.setattr(jmasks, "sample_block_tokens", j_fixed)
    monkeypatch.setattr(tmasks, "sample_offsets", t_fixed)
    jcfg = JWanConfig(**CFG)
    jpreset = jconfig.FamilyPreset(dit=jcfg, vae=J_VAE_TINY, text=T5_TINY,
                                   video=jconfig.VideoSpec(7, 60, 64, fps=4), **PRESET)
    tpreset = tconfig.FamilyPreset(dit=TWanConfig(**CFG), vae=T_VAE_TINY, text_dim=64,
                                   video=tconfig.VideoSpec(7, 60, 64, fps=4), **PRESET)
    assert jpreset.latent_grid() == tpreset.latent_grid() == (4, 15, 16)
    dit_params = _perturbed(JWanModel(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros(LATENTS), jnp.ones((1,)), jnp.zeros((1, 8, 64))), 1)
    jvae = JWanVAE(J_VAE_TINY)
    vae_params = _perturbed(jvae.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, 15, 16, 16)),
                                      method=jvae.decode), 3)
    jpipe = JPipeline(jpreset, dit_params, vae_params, sparse=True, mask_mode="energy",
                      dtype=jnp.float32, interpret=True)
    tpipe = TPipeline.build(tpreset, sparse=True, dtype=torch.float32)
    assert tpipe.dit.attention_fn is not None
    tpipe.dit.load_state_dict(to_torch(wan_transformer_state_dict(dit_params, 2)))
    tpipe.vae.load_state_dict(to_torch(wan_vae_state_dict(vae_params)))
    return jpipe, tpipe


def _inputs():
    rng = np.random.default_rng(4)
    noise = rng.standard_normal(LATENTS).astype(np.float32)
    text = rng.standard_normal((1, 8, 64)).astype(np.float32)
    return noise, text


def test_max_predictor_masks_and_velocity_match_jax(pipelines):
    jpipe, tpipe = pipelines
    x, text = _inputs()
    t = np.array([750.0], np.float32)
    jv, jm = jpipe.model_fn()(jnp.asarray(x), jnp.asarray(t), jnp.asarray(text),
                              jax.random.PRNGKey(3), collect_mask=True)
    with torch.inference_mode():
        tv, tm = tpipe.model_fn()(torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(text), make_generator(3), collect_mask=True)
    jm = np.array(jm)
    assert jm.shape == (2, 1, 2, 8, 8) and 0.3 < jm.mean() < 0.6  # clamped
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)


def test_max_predictor_sampling_and_decode_match_jax(pipelines):
    jpipe, tpipe = pipelines
    noise, text = _inputs()
    jlat = j_sample_wan(jpipe.model_fn(), jnp.asarray(noise), jnp.asarray(text),
                        rng=jax.random.PRNGKey(5), num_steps=2)
    jframes = np.asarray(jpipe.decode_latents(jlat))
    with torch.inference_mode():
        tlat = sample(tpipe.model_fn(), FlowUniPC(num_steps=2), torch.from_numpy(noise),
                      torch.from_numpy(text), generator=make_generator(5))
        tframes = tpipe.decode_latents(tlat)
    assert tframes.shape == jframes.shape == (1, 7, 60, 64, 3)
    assert torch.isfinite(tlat).all()
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tframes.numpy(), jframes, atol=1e-4, rtol=0)
