"""The port's CogVideoX VAE decoder against the JAX package, on the CPU,
through the weight bridge: the diffusers-parity ``frame_batch=2`` chunked
decode (conv caches carried, GroupNorm statistics per chunk, the odd first
chunk's special first frame) and the spatially tiled decode that runs it
tile by tile (``uniform_tiling``, linear overlap crossfade).  f32 on both
sides: frames agree to 1e-4 absolute (f32 convs in another summation
order); the bridge is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.convert.vae_convert import fake_torch_state_dict
from blade.models import vae as jvae_generic
from blade.models import vae_cogvideox as jvae
from blade_torch.convert.from_jax import cogvideox_vae_state_dict, to_torch
from blade_torch.models import vae as tvae_generic
from blade_torch.models import vae_cogvideox as tvae


def _perturbed(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


@pytest.fixture(scope="module")
def vae_pair():
    z0 = jnp.zeros((1, 1, 4, 4, 16))
    vae = jvae.CogVideoXVAE(jvae.COGVIDEOX_VAE_TINY)
    params = _perturbed(vae.init(jax.random.PRNGKey(7), z0, method=vae.decode), 8)
    port = tvae.CogVideoXVAE(tvae.COGVIDEOX_VAE_TINY)
    port.load_state_dict(to_torch(cogvideox_vae_state_dict(params)))
    return vae, params, port


def test_vae_bridge_matches_fake_torch_state_dict(vae_pair):
    _, params, port = vae_pair
    sd = cogvideox_vae_state_dict(params)
    want = {k: v for k, v in fake_torch_state_dict(params, "cogvideox").items()
            if k.startswith("decoder.")}
    assert set(sd) == set(want) == set(port.state_dict())
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k])


@pytest.mark.parametrize("t", [5, 2])
def test_vae_chunked_decode_matches_jax(vae_pair, t):
    vae, params, port = vae_pair
    z = np.random.default_rng(t).standard_normal((1, t, 6, 10, 16)).astype(np.float32)
    want = np.asarray(jvae.chunked_decode(vae, params, jnp.asarray(z), frame_batch=2))
    with torch.no_grad():
        got = tvae.chunked_decode(port, torch.from_numpy(z), frame_batch=2)
    # an odd first chunk keeps frame 0 apart in the temporal upsample
    assert got.shape == want.shape == (1, 2 * t - t % 2, 12, 20, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_vae_tiled_chunked_decode_matches_jax(vae_pair):
    vae, params, port = vae_pair
    z = np.random.default_rng(9).standard_normal((1, 5, 24, 30, 16)).astype(np.float32)
    tiles = [tvae_generic.uniform_tiling(n, 20) for n in z.shape[2:4]]
    assert tiles == [jvae_generic.uniform_tiling(n, 20) for n in z.shape[2:4]]
    (th, oh), (tw, ow) = tiles
    want = np.asarray(jvae_generic.tiled_decode(
        lambda zz: jvae.chunked_decode(vae, params, zz, frame_batch=2), jnp.asarray(z),
        tile_latent=(th, tw), overlap=(oh, ow), spatial_factor=2))
    with torch.no_grad():
        got = tvae_generic.tiled_decode(
            lambda zz: tvae.chunked_decode(port, zz, frame_batch=2), torch.from_numpy(z),
            tile_latent=(th, tw), overlap=(oh, ow), spatial_factor=2)
    assert got.shape == want.shape == (1, 9, 48, 60, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_uniform_tiling_matches_jax():
    for dim in list(range(1, 90)) + [104]:
        assert tvae_generic.uniform_tiling(dim, 20) == jvae_generic.uniform_tiling(dim, 20)
    assert tvae_generic.uniform_tiling(30, 20) == (18, 6)
    assert tvae_generic.uniform_tiling(45, 20) == (19, 6)
