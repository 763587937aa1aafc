"""CogVideoX TDM training against the JAX package on the CPU, f32.

* ``ddpm_family`` (and ``ddpm.renoise``) against ``blade``'s on the same
  numpy inputs, on the CogVideoX-5B schedule and on a shifted one.
* ``cogvideox_lora_factors`` through the bridge, both JAX tree forms: the
  port's merged weights equal JAX's merge loaded through
  ``cogvideox_transformer_state_dict`` (exact but for float rounding).
* ``make_tdm_train_step`` of both packages on the tiny CogVideoX (2
  blocks, unrolled so each block has its own LoRA pair), DDPM family,
  k_step 2, CFG 3.5, lambda_reg 0.5, the weighting factor on and no fake
  guard, dense attention, batch 2, with JAX's draws injected: the twin of
  ``test_torch_tdm.py``'s Wan step, tolerances as there (losses 1e-5
  relative, each adapter's update 1e-3 of its largest entry).

ASA LoRA gradients with remat are in ``test_torch_tdm_cog_asa.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blade.models import cogvideox_dit as jcog
from blade.schedulers import ddpm as JD
from blade.training import lora as JL
from blade.training import tdm as jtdm
from blade_torch.cli.train import model_apply_fn
from blade_torch.convert.from_jax import (
    cogvideox_lora_factors,
    cogvideox_transformer_state_dict,
    to_torch,
)
from blade_torch.models import cogvideox_dit as tcog
from blade_torch.schedulers import ddpm as TD
from blade_torch.training import lora as TL
from blade_torch.training import tdm
from blade_torch.training.optim import AdamConfig, adam_init

LAT = (2, 2, 16, 16, 16)  # [B, T, C, H, W]: 2 x 8 x 8 = 128 video tokens
TEXT = 8


def _perturb(tree, seed, scale=0.05):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


def _jax_params(scan_layers):
    model = jcog.CogVideoXModel(jcog.COGVIDEOX_TINY, dtype=jnp.float32,
                                scan_layers=scan_layers)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros(LAT), jnp.ones((LAT[0],)),
                        jnp.zeros((LAT[0], TEXT, 64)))
    return model, _perturb(params, 1)


@pytest.mark.parametrize("kw", [{}, {"snr_shift_scale": 3.0, "rescale_betas_zero_snr": False}])
def test_ddpm_family_matches_jax(kw):
    jfam = jtdm.ddpm_family(JD.make_ddpm_schedule(**kw))
    tfam = tdm.ddpm_family(TD.make_ddpm_schedule(**kw))
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32) for _ in range(3))
    t1, t2 = np.array([17, 500]), np.array([640, 999])
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    tt1, tt2 = map(torch.from_numpy, (t1, t2))
    pairs = [
        (tfam.pred_x0(ta, tb, tt1), jfam.pred_x0(a, b, t1)),
        (tfam.pred_eps(ta, tb, tt1), jfam.pred_eps(a, b, t1)),
        (tfam.add_noise(ta, tb, tt2), jfam.add_noise(a, b, t2)),
        (tfam.renoise(ta, tb, tt1, tt2), jfam.renoise(a, b, t1, t2)),
        (TD.renoise(TD.make_ddpm_schedule(**kw), tc, ta, tt1, tt2),
         JD.renoise(JD.make_ddpm_schedule(**kw), c, a, t1, t2)),
        (tfam.sigma_at(tt2, 5), jfam.sigma_at(t2, 5)),
    ]
    for got, want in pairs:
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_cogvideox_lora_factors_through_the_bridge(scan_layers):
    _, params = _jax_params(scan_layers)
    jlora = _perturb(JL.init_lora(jax.random.PRNGKey(3), params, rank=4), 4, 0.1)
    merged = JL.merge_lora(params, jlora, alpha=4.0, rank=4)
    factors = to_torch(cogvideox_lora_factors(jlora, 2, 2))
    base = tcog.CogVideoXModel(tcog.COGVIDEOX_TINY, dtype=torch.float32)
    base.load_state_dict(to_torch(cogvideox_transformer_state_dict(params, 2)))
    want = tcog.CogVideoXModel(tcog.COGVIDEOX_TINY, dtype=torch.float32)
    want.load_state_dict(to_torch(cogvideox_transformer_state_dict(merged, 2)))
    params_t = {n: p.detach() for n, p in base.named_parameters()}
    assert set(k[:-2] for k in factors) == set(TL.lora_modules(params_t))
    assert len(factors) == 2 * 2 * 4  # a, b for to_q/to_k/to_v/to_out of 2 blocks
    got = TL.merge_lora(params_t, factors, alpha=4.0, rank=4)
    for name, p in want.named_parameters():
        torch.testing.assert_close(got[name], p.detach(), atol=1e-6, rtol=1e-6, msg=name)
    if scan_layers:  # one pair shared by every block
        torch.testing.assert_close(factors["transformer_blocks.0.attn1.to_q.b"],
                                   factors["transformer_blocks.1.attn1.to_q.b"])


def _jax_draws(rng, step, shape, k_step):
    """The draws ``blade/training/tdm.py`` makes from ``rng`` at ``step``."""
    b = shape[0]
    rngs = jax.random.split(jax.random.fold_in(rng, step), 12)
    normal = lambda r: torch.from_numpy(np.array(jax.random.normal(r, shape, jnp.float32)))
    ind = lambda r: torch.from_numpy(np.array(jax.random.randint(r, (b,), 1, k_step + 1)))
    unif = lambda r: torch.from_numpy(np.array(jax.random.uniform(r, (b,))))
    traj = [jax.random.fold_in(rngs[0], k) for k in range(k_step)]
    return tdm.TDMDraws(
        traj_xi=[normal(jax.random.fold_in(kr, 1)) for kr in traj],
        traj_gens=[None] * k_step,
        fake_ind=ind(rngs[1]), fake_u=unif(rngs[2]), fake_xi=normal(rngs[3]),
        fake_xi2=normal(rngs[4]),
        gen_ind=ind(rngs[6]), gen_u=unif(rngs[7]), gen_xi=normal(rngs[8]),
        gen_xi2=normal(rngs[9]))


def test_whole_cogvideox_tdm_step_matches_jax_with_injected_draws():
    jmodel, params = _jax_params(False)
    cfg_kw = dict(k_step=2, cfg=3.5, lambda_reg=0.5, use_weighting_factor=True,
                  lora_rank=4, lora_alpha=4.0, lr_generator=1.0, lr_fake=1.0,
                  adam_eps=1.0, fake_loss_skip_threshold=None)
    jcfg_t = jtdm.TDMConfig(**cfg_kw)

    def j_apply(p, x, t, txt, r):
        return jmodel.apply(p, x, t, txt, attn_kwargs={"rng": r})

    jstate = jtdm.create_tdm_state(jax.random.PRNGKey(2), params, jcfg_t)
    jstate = jstate.replace(lora_g=_perturb(jstate.lora_g, 3, 0.1),
                            lora_f=_perturb(jstate.lora_f, 4, 0.1))
    rng = np.random.default_rng(5)
    text = rng.standard_normal((2, TEXT, 64)).astype(np.float32)
    uncond = 0.1 * rng.standard_normal((2, TEXT, 64)).astype(np.float32)
    noise = rng.standard_normal(LAT).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jfamily = jtdm.ddpm_family(JD.make_ddpm_schedule())
    jnew, jmetrics = jax.jit(jtdm.make_tdm_train_step(j_apply, jfamily, jcfg_t))(
        jstate, {"text_embeds": jnp.asarray(text), "uncond_embeds": jnp.asarray(uncond),
                 "noise": jnp.asarray(noise)}, key)

    model = tcog.CogVideoXModel(tcog.COGVIDEOX_TINY, dtype=torch.float32)
    model.load_state_dict(to_torch(cogvideox_transformer_state_dict(params, 2)))
    model.requires_grad_(False)
    base = {n: p.detach() for n, p in model.named_parameters()}
    lora_g = to_torch(cogvideox_lora_factors(jstate.lora_g, 2, 2))
    lora_f = to_torch(cogvideox_lora_factors(jstate.lora_f, 2, 2))
    state = tdm.TDMState(
        step=0, base=base, lora_g=lora_g, lora_f=lora_f,
        opt_g=adam_init(lora_g, AdamConfig(lr=1.0)), opt_f=adam_init(lora_f, AdamConfig(lr=1.0)))
    step = tdm.make_tdm_train_step(model_apply_fn(model),
                                   tdm.ddpm_family(TD.make_ddpm_schedule()),
                                   tdm.TDMConfig(**cfg_kw))
    new, metrics = step(state, {"text_embeds": torch.from_numpy(text),
                                "uncond_embeds": torch.from_numpy(uncond),
                                "noise": torch.from_numpy(noise)},
                        draws=_jax_draws(key, 0, LAT, 2))

    for name in ("loss_fake", "loss_du"):
        np.testing.assert_allclose(metrics[name], float(jmetrics[name]), rtol=1e-5)
    for got_new, got_old, want_new, want_old in (
            (new.lora_g, state.lora_g, jnew.lora_g, jstate.lora_g),
            (new.lora_f, state.lora_f, jnew.lora_f, jstate.lora_f)):
        delta = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                       want_new, want_old)
        want = cogvideox_lora_factors(delta, 2, 2)
        scale = max(float(np.abs(v).max()) for v in want.values())
        assert scale > 1e-3
        for k, v in want.items():
            got = (got_new[k] - got_old[k]).numpy()
            np.testing.assert_allclose(got, v, atol=1e-3 * scale, rtol=0, err_msg=k)
