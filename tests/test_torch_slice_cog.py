"""The whole CogVideoX slice, both packages: 4-step SDE-DPM++(2M) sampling
with multilevel ASA, then the tiled, fb=2-chunked CogVideoX VAE decode.

A tiny CogVideoX (``COGVIDEOX_TINY``: dim 128, 2 heads of 64, 2 layers) and
``COGVIDEOX_VAE_TINY`` over latents ``[1, 5, 16, 32, 32]``: 1280 video
tokens + 8 text tokens (11 key blocks, ragged), 256-row mask rows, and
32 x 32 latent frames, which the decode splits into 2 x 2 tiles of 19 with
overlap 6, each decoded in chunks of 3 + 2 latent frames.  JAX runs its
mask-reuse stepper (``cog_stepper_reuse``, refresh on every step) with its
Pallas kernels in interpret mode and collects each step's per-layer lists;
the port replays those lists (jax.random's draws cannot be reproduced) and
takes each step's SDE noise from JAX's key.  Both run in f32 on the same
numpy noise and bridged weights; latents and frames agree to 1e-4
absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blade import config as jconfig
from blade.models.cogvideox_dit import COGVIDEOX_TINY as J_COG_TINY
from blade.models.cogvideox_dit import CogVideoXModel as JCogModel
from blade.models.t5 import T5_TINY
from blade.models.vae_cogvideox import COGVIDEOX_VAE_TINY as J_VAE_TINY
from blade.models.vae_cogvideox import CogVideoXVAE as JCogVAE
from blade.sampling.pipeline import cog_stepper_reuse as j_stepper
from blade.sampling.t2v import T2VPipeline as JPipeline
from blade.schedulers.ddpm import make_ddpm_schedule as j_ddpm
from blade_torch import config as tconfig
from blade_torch.cli import inference as tcli
from blade_torch.convert.from_jax import (
    cogvideox_transformer_state_dict,
    cogvideox_vae_state_dict,
    to_torch,
)
from blade_torch.kernels._build import KERNELS
from blade_torch.models.cogvideox_dit import COGVIDEOX_TINY as T_COG_TINY
from blade_torch.models.vae_cogvideox import COGVIDEOX_VAE_TINY as T_VAE_TINY
from blade_torch.sampling.pipeline import SDEDPM
from blade_torch.sampling.pipeline import step as t_step
from blade_torch.sampling.t2v import T2VPipeline as TPipeline
from blade_torch.schedulers.ddpm import make_ddpm_schedule as t_ddpm
from blade_torch.utils.rng import make_generator

LATENTS = (1, 5, 16, 32, 32)
STEPS = 4
PRESET = dict(name="cogvideox", max_text_len=8, sample_gap=4, min_retain_ratio=0.25,
              max_retain_ratio=1.0, joint_text_attention=True, asa_multilevel_q_rows=256)


def _perturbed(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


def test_multilevel_sampling_and_tiled_decode_match_jax():
    jpreset = jconfig.FamilyPreset(dit=J_COG_TINY, vae=J_VAE_TINY, text=T5_TINY,
                                   video=jconfig.VideoSpec(9, 64, 64, fps=4), **PRESET)
    tpreset = tconfig.FamilyPreset(dit=T_COG_TINY, vae=T_VAE_TINY, text_dim=64,
                                   video=tconfig.VideoSpec(9, 64, 64, fps=4), **PRESET)
    assert jpreset.latent_grid() == tpreset.latent_grid() == (5, 16, 16)

    dit_params = _perturbed(JCogModel(J_COG_TINY, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros(LATENTS), jnp.ones((1,)),
        jnp.zeros((1, 8, 64))), 1)
    jvae = JCogVAE(J_VAE_TINY)
    vae_params = _perturbed(jvae.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, 4, 4, 16)),
                                      method=jvae.decode), 3)
    jpipe = JPipeline(jpreset, dit_params, vae_params, sparse=True, mask_mode="multilevel",
                      dtype=jnp.float32, interpret=True)
    tpipe = TPipeline.build(tpreset, sparse=True, dtype=torch.float32)
    assert tpipe.mask_mode == "multilevel"
    tpipe.dit.load_state_dict(to_torch(cogvideox_transformer_state_dict(dit_params, 2)))
    tpipe.vae.load_state_dict(to_torch(cogvideox_vae_state_dict(vae_params)))

    rng = np.random.default_rng(4)
    noise = rng.standard_normal(LATENTS).astype(np.float32)
    text = rng.standard_normal((1, 8, 64)).astype(np.float32)
    key = jax.random.PRNGKey(5)

    j_init, j_refresh, _ = j_stepper(jpipe.model_fn(), num_steps=STEPS,
                                     ddpm_schedule=j_ddpm())
    solver = SDEDPM(num_steps=STEPS, ddpm_schedule=t_ddpm())
    j_refresh = jax.jit(j_refresh)
    jstate, tstate = j_init(jnp.asarray(noise)), solver.init(torch.from_numpy(noise))
    ttext, gen = torch.from_numpy(text), make_generator(5)
    for i in range(STEPS):
        jstate, (idx, cnt) = j_refresh(jstate, jnp.int32(i), jnp.asarray(text), key)
        xi = jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, i), 1),
                               LATENTS, jnp.float32)
        masks = (torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(cnt)))
        assert masks[0].shape == (2, 1, 2, 6, 4, 128)
        with torch.inference_mode():
            tstate = t_step(tpipe.model_fn(), solver, tstate, i, ttext, gen, masks=masks,
                            xi=torch.from_numpy(np.array(xi)))
    jlat, tlat = jstate.x, tstate.x
    jframes = np.asarray(jpipe.decode_latents(jlat))
    with torch.inference_mode():
        tframes = tpipe.decode_latents(tlat)
        u8 = tpipe.frames_to_uint8(tframes)

    assert tframes.shape == jframes.shape == (1, 9, 64, 64, 3)
    assert torch.isfinite(tlat).all()
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tframes.numpy(), jframes, atol=1e-4, rtol=0)
    assert u8.dtype == torch.uint8
    want_u8 = np.asarray(jpipe.frames_to_uint8(jnp.asarray(tframes.numpy())))
    np.testing.assert_array_equal(u8.numpy(), want_u8)


def test_tiny_cogvideox_cli_runs_on_the_plain_paths(tmp_path):
    """``--family cogvideox --tiny --random-init --device cpu``: the
    multilevel lane end to end through the plain versions; no kernel is
    launched on the CPU."""
    before = {n: k.launches for n, k in KERNELS.items()}
    args = tcli.get_args(["--family", "cogvideox", "--tiny", "--random-init", "--device",
                          "cpu", "--prompt", "a cat surfing", "--steps", "2"])
    pipe = tcli.build_pipeline(args)
    assert pipe.preset is tconfig.COGVIDEOX_TINY_PRESET and pipe.mask_mode == "multilevel"
    text = tcli.random_text_embeds(pipe, "a cat surfing")
    assert text.shape == (1, 16, 64)
    frames = pipe.generate(text, generator=make_generator(8888), num_steps=2)
    assert frames.shape == (1, 5, 32, 32, 3) and torch.isfinite(frames).all()
    tcli.main(["--family", "cogvideox", "--tiny", "--random-init", "--device", "cpu",
               "--prompt", "a cat surfing", "--steps", "1", "--output_dir", str(tmp_path)])
    assert any(tmp_path.iterdir())
    assert {n: k.launches for n, k in KERNELS.items()} == before
