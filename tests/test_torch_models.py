"""The port's Wan DiT and Wan VAE decoder against the JAX package, on the CPU,
through the weight bridge (``blade_torch.convert.from_jax``).

Both packages run in f32 on the same numpy inputs.  Tolerances: the DiT
velocity 2e-4 absolute (magnitude ~1, two blocks of f32 matmuls, LayerNorm
variance computed two ways); the VAE frames 1e-4 absolute (f32 convs in
another summation order).  The bridge itself is exact.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blade.convert.dit_convert import convert_wan_transformer
from blade.convert.vae_convert import fake_torch_state_dict
from blade.models import layers as jlayers
from blade.models import vae_wan as jvae
from blade.models import wan_dit as jwan
from blade_torch.convert.from_jax import (
    to_torch,
    wan_transformer_state_dict,
    wan_vae_state_dict,
)
from blade_torch.models import layers as tlayers
from blade_torch.models import vae_wan as tvae
from blade_torch.models import wan_dit as twan
from tests.torch_dit_ref import TorchWanRef

CFG = dict(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32)


def _jax_wan(seed=0, latents_shape=(1, 16, 2, 8, 8)):
    cfg = jwan.WanConfig(**CFG)
    model = jwan.WanModel(cfg, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros(latents_shape), jnp.ones((1,)),
                        jnp.zeros((1, 8, cfg.text_dim)))
    # non-trivial modulation tables, norm scales and biases
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
              for x in leaves]
    return cfg, model, jax.tree_util.tree_unflatten(tree, leaves)


def test_rope_tables_and_deinterleave_perm_match():
    for grid in ((21, 30, 52), (3, 4, 5)):
        for a, b in zip(tlayers.rope_3d_tables(128, grid), jlayers.rope_3d_tables(128, grid)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tlayers.deinterleave_perm(12, 128),
                                  jlayers.deinterleave_perm(12, 128))
    t = np.array([0.0, 3.0, 999.0], np.float32)
    # 1e-5: f32 sin/cos of arguments up to 1e3 differ in the last bits
    np.testing.assert_allclose(
        tlayers.sinusoidal_timestep_embedding(torch.from_numpy(t), 32).numpy(),
        np.asarray(jlayers.sinusoidal_timestep_embedding(t, 32)), atol=1e-5)


def test_dit_bridge_round_trips_through_convert_wan_transformer():
    cfg, _, params = _jax_wan()
    sd = wan_transformer_state_dict(params, cfg.num_layers)
    back = convert_wan_transformer(sd, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))
    # the port keeps the diffusers layout, key for key
    ref_keys = set(TorchWanRef(cfg).state_dict())
    port = twan.WanModel(twan.WanConfig(**CFG), dtype=torch.float32)
    assert set(port.state_dict()) == ref_keys == set(sd)
    # the q/k de-interleave fold happens at load time and is undone on save
    port.load_state_dict(to_torch(sd))
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    perm = tlayers.deinterleave_perm(2, 128)
    np.testing.assert_array_equal(port.blocks[0].attn1.to_q.weight.detach().numpy(),
                                  sd["blocks.0.attn1.to_q.weight"][perm])


def test_dit_dense_forward_matches_jax():
    cfg, model, params = _jax_wan(1)
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((1, 16, 2, 8, 8)).astype(np.float32)
    text = rng.standard_normal((1, 8, cfg.text_dim)).astype(np.float32)
    t = np.array([640.0], np.float32)
    want = np.asarray(model.apply(params, lat, t, text))
    port = twan.WanModel(twan.WanConfig(**CFG), dtype=torch.float32)
    port.load_state_dict(to_torch(wan_transformer_state_dict(params, cfg.num_layers)))
    with torch.no_grad():
        got = port(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(text))
    assert got.shape == lat.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def _jax_vae(z):
    vae = jvae.WanVAE(jvae.WAN21_VAE_TINY)
    params = vae.init(jax.random.PRNGKey(3), jnp.asarray(z[:, :1]), method=vae.decode)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(4)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
              for x in leaves]
    return vae, jax.tree_util.tree_unflatten(tree, leaves)


def test_vae_bridge_and_streaming_decode_match_jax():
    z = np.random.default_rng(5).standard_normal((1, 4, 6, 8, 16)).astype(np.float32)
    vae, params = _jax_vae(z)
    sd = wan_vae_state_dict(params)
    want_sd = fake_torch_state_dict(params, "wan")
    assert set(sd) == set(want_sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], want_sd[k])
    port = tvae.WanVAE(tvae.WAN21_VAE_TINY)
    port.load_state_dict(to_torch(sd))
    want = np.asarray(jvae.streaming_decode(vae, params, jnp.asarray(z), chunk_latents=1))
    with torch.no_grad():
        got = tvae.streaming_decode(port, torch.from_numpy(z))
        whole = port.decode(torch.from_numpy(z))
    assert got.shape == want.shape == (1, 7, 12, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # streaming with conv-state carry equals the whole-clip decode
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5, rtol=0)


def test_import_blade_torch_leaves_jax_out():
    code = ("import sys, blade_torch, blade_torch.sampling.t2v, blade_torch.cli.inference, "
            "blade_torch.convert.from_jax; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'blade.'))"
            " or m == 'blade']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
