"""The port's CogVideoX scheduler and DiT against the JAX package, on the
CPU: the DDPM tables and the SDE-DPM++(2M) step (injected noise), and the
DiT through the weight bridge (dense, and on the multilevel ASA lane with
JAX's per-layer lists replayed).  The VAE decoder is in
``test_torch_cogvideox_vae.py``.

Both packages run in f32 on the same numpy inputs.  Tolerances: scheduler
states 1e-5 relative (host-side f32 coefficients against jnp f32); the DiT
v-prediction 2e-4 absolute (magnitude ~1, two blocks of f32 matmuls,
LayerNorm statistics computed two ways).  The bridge itself is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.attention.asa import ASAConfig as JASAConfig
from blade.attention.integration import asa_model_kwargs as j_asa_kwargs
from blade.attention.integration import extract_attn_aux
from blade.convert.dit_convert import convert_cogvideox_transformer
from blade.models import cogvideox_dit as jcog
from blade.schedulers import cogvideox_dpm as JDPM
from blade.schedulers import ddpm as JD
from blade_torch.attention.asa import ASAConfig as TASAConfig
from blade_torch.attention.integration import asa_model_kwargs as t_asa_kwargs
from blade_torch.convert.from_jax import (
    cogvideox_transformer_state_dict,
    to_torch,
)
from blade_torch.models import cogvideox_dit as tcog
from blade_torch.models import layers as tlayers
from blade_torch.schedulers import cogvideox_dpm as TDPM
from blade_torch.schedulers import ddpm as TD

RATIOS = {1: (0.0, 0.25), 2: (0.25, 0.5), 4: (0.5, 0.75), 8: (0.75, 0.9), 0: (0.9, 1.0)}


def _perturbed(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


@pytest.mark.parametrize("kw", [{}, {"snr_shift_scale": 3.0, "rescale_betas_zero_snr": False},
                                {"beta_schedule": "linear"}])
def test_ddpm_tables_and_conversions_match(kw):
    js, ts = JD.make_ddpm_schedule(**kw), TD.make_ddpm_schedule(**kw)
    for name in ("alphas_cumprod", "alpha", "sigma"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    np.testing.assert_array_equal(TD.trailing_timesteps(1000, 8), JD.trailing_timesteps(1000, 8))
    rng = np.random.default_rng(0)
    x0, eps, xt = (rng.standard_normal((2, 3, 4, 5)).astype(np.float32) for _ in range(3))
    t = np.array([999, 17])
    tt = torch.from_numpy(t)
    pairs = [
        (TD.add_noise(ts, *map(torch.from_numpy, (x0, eps)), tt), JD.add_noise(js, x0, eps, t)),
        (TD.pred_x0_from_v(ts, *map(torch.from_numpy, (eps, xt)), tt),
         JD.pred_x0_from_v(js, eps, xt, t)),
        (TD.pred_eps_from_x0(ts, *map(torch.from_numpy, (x0, xt)), tt),
         JD.pred_eps_from_x0(js, x0, xt, t)),
        (TD.velocity_from_x0_eps(ts, *map(torch.from_numpy, (x0, eps)), tt),
         JD.velocity_from_x0_eps(js, x0, eps, t)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("steps,noisy", [(8, True), (4, True), (8, False)])
def test_dpm_steps_match_with_injected_noise(steps, noisy):
    base_j, base_t = JD.make_ddpm_schedule(), TD.make_ddpm_schedule()
    js, ts = JDPM.make_dpm_schedule(base_j, steps), TDPM.make_dpm_schedule(base_t, steps)
    for name in ("timesteps", "alpha", "sigma", "lambdas"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((1, 3, 4, 6, 8)).astype(np.float32)
    jstate, tstate = JDPM.dpm_init(jnp.asarray(x)), TDPM.dpm_init(torch.from_numpy(x))
    for i in range(steps):
        v = rng.standard_normal(x.shape).astype(np.float32)
        xi = rng.standard_normal(x.shape).astype(np.float32) if noisy else None
        jstate = JDPM.dpm_step(js, jstate, jnp.asarray(v), i,
                               None if xi is None else jnp.asarray(xi))
        tstate = TDPM.dpm_step(ts, tstate, torch.from_numpy(v), i,
                               None if xi is None else torch.from_numpy(xi))
        for a, b in zip(tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


LAT = (1, 2, 16, 32, 32)  # [B, T, C, H, W]: 2 x 16 x 16 = 512 video tokens
TEXT = 8


def _jax_dit(seed=0):
    cfg = jcog.COGVIDEOX_TINY
    model = jcog.CogVideoXModel(cfg, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros(LAT), jnp.ones((1,)),
                        jnp.zeros((1, TEXT, cfg.text_embed_dim)))
    return cfg, model, _perturbed(params, seed + 1)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal(LAT).astype(np.float32)
    text = rng.standard_normal((1, TEXT, 64)).astype(np.float32)
    return lat, text, np.array([640.0], np.float32)


def test_dit_bridge_round_trips_and_folds_perm():
    cfg, _, params = _jax_dit()
    sd = cogvideox_transformer_state_dict(params, cfg.num_layers)
    back = convert_cogvideox_transformer(sd, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))
    port = tcog.CogVideoXModel(tcog.COGVIDEOX_TINY, dtype=torch.float32)
    assert set(port.state_dict()) == set(sd)
    port.load_state_dict(to_torch(sd))
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    blk = port.transformer_blocks[0].attn1
    perm = tlayers.deinterleave_perm(2, 64)
    np.testing.assert_array_equal(blk.to_q.weight.detach().numpy(),
                                  sd["transformer_blocks.0.attn1.to_q.weight"][perm])
    np.testing.assert_array_equal(blk.norm_k.bias.detach().numpy(),
                                  sd["transformer_blocks.0.attn1.norm_k.bias"]
                                  [tlayers.deinterleave_perm(1, 64)])


def test_dit_dense_forward_matches_jax():
    cfg, model, params = _jax_dit(2)
    lat, text, t = _inputs(3)
    want = np.asarray(model.apply(params, lat, t, text))
    port = tcog.CogVideoXModel(tcog.COGVIDEOX_TINY, dtype=torch.float32)
    port.load_state_dict(to_torch(cogvideox_transformer_state_dict(params, cfg.num_layers)))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (lat, t, text)))
    assert got.shape == LAT and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_dit_multilevel_asa_with_replayed_lists_matches_jax():
    """The ASA model (gilbert permutation hoisted to the model, ``[video,
    text]`` joint sequence, multilevel lane with 256-row lists) on JAX's
    per-layer lists, collected from JAX's own predictor."""
    cfg, _, params = _jax_dit(4)
    lat, text, t = _inputs(5)
    geo = dict(latent_width=16, latent_height=16, latent_frames=2, text_length=TEXT,
               sample_tokens_per_block=16, mask_mode="multilevel", mask_ratios=RATIOS,
               multilevel_q_rows=256)
    jmodel = jcog.CogVideoXModel(cfg, dtype=jnp.float32,
                                 **j_asa_kwargs(JASAConfig(predictor="sum", **geo),
                                                interpret=True))
    want, state = jmodel.apply(params, lat, t, text,
                               attn_kwargs={"rng": jax.random.PRNGKey(6), "collect_mask": True},
                               mutable=["intermediates"])
    idx, cnt = extract_attn_aux(state["intermediates"])
    assert idx.shape == (2, 1, 2, 3, 4, 128) and cnt.shape == (2, 1, 2, 3, 4)
    port = tcog.CogVideoXModel(tcog.COGVIDEOX_TINY, dtype=torch.float32,
                               **t_asa_kwargs(TASAConfig(**geo)))
    port.load_state_dict(to_torch(cogvideox_transformer_state_dict(params, cfg.num_layers)))
    masks = (torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(cnt)))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (lat, t, text)), attn_kwargs={"masks": masks})
        got2, replayed = port(*map(torch.from_numpy, (lat, t, text)),
                              attn_kwargs={"masks": masks, "collect_mask": True})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    # replay hands the same artifact back, stacked per layer
    assert all(torch.equal(a, b) for a, b in zip(replayed, masks))
    assert torch.equal(got, got2)
