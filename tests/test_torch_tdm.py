"""A whole TDM step, and ASA gradients through the model, against the JAX
package on the CPU.

* ``make_tdm_train_step`` of both packages on a small Wan (dim 256, 2
  heads of 128, 2 layers, unrolled so each block has its own LoRA pair),
  k_step 2, dense attention, batch 2, the same bridged weights and LoRA
  factors (non-zero ``b``), and JAX's random draws recomputed from the
  same key as ``blade/training/tdm.py`` splits it and handed to the port.
  ``adam_eps = 1`` and a learning rate of 1 make the first update
  ``g / (|g| + 1)`` (plus weight decay): linear in the gradient rather
  than its sign.  The losses agree to 1e-5 relative and each adapter's
  update to 1e-3 of its largest entry (f32 both sides; the two frameworks
  sum in other orders through 12 DiT passes).
* One forward and backward of the model with ASA at a clamping retain
  ratio (0.05 / 0.2), JAX's per-layer masks replayed into the port: the
  LoRA gradients agree to 1e-3 of the largest (the JAX side runs its
  Pallas forward and backward kernels in interpret mode).  With
  ``remat=True`` the port's gradients are bit-identical to ``remat=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blade import config as jconfig
from blade.attention.integration import asa_model_kwargs as j_asa_model_kwargs
from blade.attention.integration import extract_attn_aux
from blade.models.t5 import T5_TINY
from blade.models.vae_wan import WAN21_VAE_TINY as J_VAE_TINY
from blade.models.wan_dit import WanConfig as JWanConfig
from blade.models.wan_dit import WanModel as JWanModel
from blade.schedulers import unipc_flow as JF
from blade.training import lora as JL
from blade.training import tdm as jtdm
from blade_torch.attention.integration import asa_model_kwargs, make_asa_attention_fn
from blade_torch.attention.asa import ASAConfig
from blade_torch.cli.train import model_apply_fn
from blade_torch.convert.from_jax import to_torch, wan_lora_factors, wan_transformer_state_dict
from blade_torch.models.wan_dit import WanConfig, WanModel
from blade_torch.schedulers import unipc_flow as TF
from blade_torch.training import lora as TL
from blade_torch.training import tdm
from blade_torch.training.optim import AdamConfig, adam_init
from blade_torch.utils.rng import make_generator

CFG = dict(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32)


def _perturb(tree, seed, scale=0.05):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


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


def _tree_delta(new, old):
    return jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), new, old)


def test_whole_tdm_step_matches_jax_with_injected_draws():
    jcfg = JWanConfig(**CFG)
    jmodel = JWanModel(jcfg, dtype=jnp.float32, scan_layers=False)
    lat_shape = (2, 16, 2, 8, 8)
    params = _perturb(jmodel.init(jax.random.PRNGKey(0), jnp.zeros(lat_shape),
                                  jnp.ones((2,)), jnp.zeros((2, 8, 64))), 1)
    cfg_kw = dict(k_step=2, cfg=5.0, lambda_reg=0.5, use_weighting_factor=True,
                  lora_rank=4, lora_alpha=4.0, lr_generator=1.0, lr_fake=1.0,
                  adam_eps=1.0, fake_loss_skip_threshold=None)
    jcfg_t = jtdm.TDMConfig(**cfg_kw)
    jfamily = jtdm.flow_family(JF.flow_training_sigmas(1000, 3.0))

    def j_apply(p, x, t, txt, r):
        return jmodel.apply(p, x, t, txt, attn_kwargs={"rng": r})

    jstate = jtdm.create_tdm_state(jax.random.PRNGKey(2), params, jcfg_t)
    jstate = jstate.replace(lora_g=_perturb(jstate.lora_g, 3, 0.1),
                            lora_f=_perturb(jstate.lora_f, 4, 0.1))
    rng = np.random.default_rng(5)
    text = rng.standard_normal((2, 8, 64)).astype(np.float32)
    uncond = 0.1 * rng.standard_normal((2, 8, 64)).astype(np.float32)
    noise = rng.standard_normal(lat_shape).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jnew, jmetrics = jax.jit(jtdm.make_tdm_train_step(j_apply, jfamily, jcfg_t))(
        jstate, {"text_embeds": jnp.asarray(text), "uncond_embeds": jnp.asarray(uncond),
                 "noise": jnp.asarray(noise)}, key)

    model = WanModel(WanConfig(**CFG), dtype=torch.float32)
    model.load_state_dict(to_torch(wan_transformer_state_dict(params, 2)))
    model.requires_grad_(False)
    tcfg = tdm.TDMConfig(**cfg_kw)
    base = {n: p.detach() for n, p in model.named_parameters()}
    lora_g = to_torch(wan_lora_factors(jstate.lora_g, 2, 2))
    lora_f = to_torch(wan_lora_factors(jstate.lora_f, 2, 2))
    state = tdm.TDMState(
        step=0, base=base, lora_g=lora_g, lora_f=lora_f,
        opt_g=adam_init(lora_g, AdamConfig(lr=1.0)), opt_f=adam_init(lora_f, AdamConfig(lr=1.0)))
    step = tdm.make_tdm_train_step(model_apply_fn(model),
                                   tdm.flow_family(TF.flow_training_sigmas(1000, 3.0)), tcfg)
    new, metrics = step(state, {"text_embeds": torch.from_numpy(text),
                                "uncond_embeds": torch.from_numpy(uncond),
                                "noise": torch.from_numpy(noise)},
                        draws=_jax_draws(key, 0, lat_shape, 2))

    for name in ("loss_fake", "loss_du"):
        np.testing.assert_allclose(metrics[name], float(jmetrics[name]), rtol=1e-5)
    for got_new, got_old, want_new, want_old in (
            (new.lora_g, state.lora_g, jnew.lora_g, jstate.lora_g),
            (new.lora_f, state.lora_f, jnew.lora_f, jstate.lora_f)):
        want = wan_lora_factors(_tree_delta(want_new, want_old), 2, 2)
        scale = max(float(np.abs(v).max()) for v in want.values())
        assert scale > 1e-3
        for k, v in want.items():
            got = (got_new[k] - got_old[k]).numpy()
            np.testing.assert_allclose(got, v, atol=1e-3 * scale, rtol=0, err_msg=k)


def _asa_setup():
    common = dict(name="wan", max_text_len=8, flow_shift=3.0, sample_gap=30,
                  min_retain_ratio=0.05, max_retain_ratio=0.2)
    jpreset = jconfig.FamilyPreset(dit=JWanConfig(**CFG), vae=J_VAE_TINY, text=T5_TINY,
                                   video=jconfig.VideoSpec(5, 60, 64, fps=4), **common)
    jasa = jconfig.derive_asa_config(jpreset, "energy")
    jmodel = JWanModel(JWanConfig(**CFG), dtype=jnp.float32, scan_layers=False,
                       **j_asa_model_kwargs(jasa, interpret=True))
    lat = (1, 16, 3, 30, 32)  # 720 tokens: 6 blocks, the last one ragged
    init = jax.jit(JWanModel(JWanConfig(**CFG), dtype=jnp.float32, scan_layers=False).init)
    params = _perturb(init(jax.random.PRNGKey(0), jnp.zeros(lat), jnp.ones((1,)),
                           jnp.zeros((1, 8, 64))), 1)
    tasa = ASAConfig(latent_width=16, latent_height=15, latent_frames=3, sample_gap=30,
                     min_retain_ratio=0.05, max_retain_ratio=0.2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(lat).astype(np.float32)
    text = rng.standard_normal((1, 8, 64)).astype(np.float32)
    cot = rng.standard_normal(lat).astype(np.float32)
    return jmodel, params, tasa, x, np.array([750.0], np.float32), text, cot


def _port_lora_grads(model, params_sd, lora, x, t, text, cot, masks):
    base = {n: p.detach() for n, p in model.named_parameters()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in lora.items()}
    merged = TL.merge_lora(base, leaves, alpha=4.0, rank=4)
    v = torch.func.functional_call(model, merged, (x, t, text),
                                   {"attn_kwargs": {"masks": masks}})
    grads = torch.autograd.grad((v * cot).sum(), list(leaves.values()))
    return dict(zip(leaves, grads))


def test_asa_lora_gradients_match_jax_with_replayed_masks_and_remat_is_exact():
    jmodel, params, tasa, x, t, text, cot = _asa_setup()
    _, state = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text),
                            attn_kwargs={"rng": jax.random.PRNGKey(3), "collect_mask": True},
                            mutable=["intermediates"])
    jmasks = np.array(extract_attn_aux(state["intermediates"]))
    assert jmasks.shape == (2, 1, 2, 6, 6) and 0.2 < jmasks.mean() < 0.7
    jlora = _perturb(JL.init_lora(jax.random.PRNGKey(4), params, rank=4), 5, 0.1)

    def loss(lora):
        v = jmodel.apply(JL.merge_lora(params, lora, alpha=4.0, rank=4), jnp.asarray(x),
                         jnp.asarray(t), jnp.asarray(text),
                         attn_kwargs={"masks": jnp.asarray(jmasks)})
        return jnp.sum(v * jnp.asarray(cot))

    want = wan_lora_factors(jax.grad(loss)(jlora), 2, 2)

    sd = to_torch(wan_transformer_state_dict(params, 2))
    lora = to_torch(wan_lora_factors(jlora, 2, 2))
    args = [torch.from_numpy(a) for a in (x, t, text, cot)] + [torch.from_numpy(jmasks)]
    grads = {}
    for remat in (False, True):
        model = WanModel(WanConfig(**CFG), dtype=torch.float32, remat=remat,
                         **asa_model_kwargs(tasa))
        model.load_state_dict(sd)
        model.requires_grad_(False)
        grads[remat] = _port_lora_grads(model, sd, lora, *args[:4], args[4])
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(grads[False][k].numpy(), v, atol=1e-3 * scale, rtol=0,
                                   err_msg=k)
        torch.testing.assert_close(grads[True][k], grads[False][k], atol=0, rtol=0)


def test_recomputed_masks_equal_the_forward_masks():
    """ASA's predictor seeds each layer's draws from the generator's seed and
    the layer index alone, so a recompute (remat) predicts the same mask."""
    fn = make_asa_attention_fn(ASAConfig(latent_width=16, latent_height=8, latent_frames=2,
                                         sample_gap=4, min_retain_ratio=0.1,
                                         max_retain_ratio=0.3, pre_arranged=True))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 256, 32, generator=g) for _ in range(3))
    gen = make_generator(11)
    _, m1 = fn(q, k, v, generator=gen, layer_index=1, collect_mask=True)
    _, m2 = fn(q, k, v, generator=gen, layer_index=1, collect_mask=True)
    _, m3 = fn(q, k, v, generator=gen, layer_index=2, collect_mask=True)
    assert torch.equal(m1, m2)
    assert m1.shape == m3.shape == (1, 2, 2, 2)
