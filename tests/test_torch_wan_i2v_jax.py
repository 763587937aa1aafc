"""Wan2.1 image to video: the port's I2V DiT and Wan VAE encoder against the
JAX package, on the CPU, through the weight bridge
(``blade_torch.convert.from_jax``).

Both packages run in f32 on the same numpy inputs and the same (perturbed)
weights.  The DiT: ``image_dim`` set, the 36-channel patch embed (latents,
mask and encoded image concatenated by the port, by the caller in JAX), the
f32 image embedder and every block's image branch; tolerance 2e-4 absolute
as the T2V forward's (``test_torch_models.py``).  The encoder: the port's
streaming encode (frame 0, then chunks) and its whole-clip encode against
JAX's whole-clip ``WanVAE.encode`` (the raw posterior mean), 1e-4 absolute
(f32 convolutions in another summation order).  The bridge itself is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.convert.dit_convert import convert_wan_transformer
from blade.convert.vae_convert import fake_torch_state_dict
from blade.models import vae_wan as jvae
from blade.models import wan_dit as jwan
from blade_torch.convert.from_jax import to_torch, wan_transformer_state_dict, wan_vae_state_dict
from blade_torch.models import vae_wan as tvae
from blade_torch.models import wan_dit as twan

CFG = dict(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32,
           in_channels=36, image_dim=48, image_context_tokens=9)
LATENTS = (1, 16, 2, 8, 8)


def _perturbed(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
              for x in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _jax_i2v(seed=0):
    cfg = jwan.WanConfig(**CFG)
    model = jwan.WanModel(cfg, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 36) + LATENTS[2:]),
                        jnp.ones((1,)), jnp.zeros((1, 8, cfg.text_dim)),
                        image_embeds=jnp.zeros((1, cfg.image_context_tokens, cfg.image_dim)))
    return cfg, model, _perturbed(params, seed)


def test_i2v_dit_bridge_round_trips_and_keeps_the_diffusers_keys():
    cfg, _, params = _jax_i2v()
    sd = wan_transformer_state_dict(params, cfg.num_layers)
    assert "condition_embedder.image_embedder.ff.net.2.weight" in sd
    assert "blocks.1.attn2.norm_added_k.weight" in sd
    back = convert_wan_transformer(sd, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))
    port = twan.WanModel(twan.WanConfig(**CFG), dtype=torch.float32)
    assert set(port.state_dict()) == set(sd)


def test_i2v_dit_forward_matches_jax():
    cfg, model, params = _jax_i2v(1)
    rng = np.random.default_rng(2)
    lat = rng.standard_normal(LATENTS).astype(np.float32)
    cond = rng.standard_normal((1, 20) + LATENTS[2:]).astype(np.float32)
    text = rng.standard_normal((1, 8, cfg.text_dim)).astype(np.float32)
    img = rng.standard_normal((1, cfg.image_context_tokens, cfg.image_dim)).astype(np.float32)
    t = np.array([640.0], np.float32)
    want = np.asarray(model.apply(params, np.concatenate([lat, cond], 1), t, text,
                                  image_embeds=img))
    port = twan.WanModel(twan.WanConfig(**CFG), dtype=torch.float32)
    port.load_state_dict(to_torch(wan_transformer_state_dict(params, cfg.num_layers)))
    with torch.no_grad():
        got = port(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(text),
                   image_embeds=torch.from_numpy(img), condition=torch.from_numpy(cond))
        no_image = port(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(text),
                        image_embeds=torch.zeros_like(torch.from_numpy(img)),
                        condition=torch.from_numpy(cond))
    assert got.shape == lat.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    # the image features reach the output
    assert float((got - no_image).abs().max()) > 1e-2


def test_the_i2v_forward_refuses_a_missing_image_and_t2v_an_extra_one():
    port = twan.WanModel(twan.WanConfig(**CFG), dtype=torch.float32)
    lat, t, text = torch.zeros(LATENTS), torch.ones(1), torch.zeros(1, 8, 64)
    with pytest.raises(ValueError):
        port(lat, t, text)
    t2v = twan.WanModel(twan.WanConfig(**dict(CFG, in_channels=16, image_dim=None)),
                        dtype=torch.float32)
    with pytest.raises(ValueError):
        t2v(lat, t, text, image_embeds=torch.zeros(1, 9, 48),
            condition=torch.zeros(1, 20, 2, 8, 8))


def test_vae_encoder_bridge_and_streaming_encode_match_jax():
    frames = 9  # frame 0 and four chunks of the tiny VAE's 2
    video = np.random.default_rng(6).uniform(-1, 1, (1, frames, 16, 24, 3)).astype(np.float32)
    vae = jvae.WanVAE(jvae.WAN21_VAE_TINY)
    params = _perturbed(vae.init(jax.random.PRNGKey(7), jnp.asarray(video)), 8)
    sd = wan_vae_state_dict(params)
    want_sd = fake_torch_state_dict(params, "wan")
    assert set(sd) == set(want_sd)
    assert {k.split(".")[0] for k in sd} == {"encoder", "quant_conv", "decoder",
                                             "post_quant_conv"}
    for k in sd:
        np.testing.assert_array_equal(sd[k], want_sd[k])
    port = tvae.WanVAE(tvae.WAN21_VAE_TINY, encoder=True)
    port.load_state_dict(to_torch(sd))
    want = np.asarray(vae.apply(params, jnp.asarray(video), method=vae.encode))
    with torch.no_grad():
        got = tvae.streaming_encode(port, torch.from_numpy(video))
        whole = port.encode(torch.from_numpy(video))
    assert got.shape == want.shape == (1, (frames - 1) // 2 + 1, 8, 12, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(whole.numpy(), want, atol=1e-4, rtol=0)
