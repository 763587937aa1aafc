"""LoRA gradients of one loss through the tiny CogVideoX on the trainer's
ASA energy lane against ``jax.grad`` of ``blade``'s, on the CPU, f32, with
JAX's per-layer masks replayed (JAX's Pallas kernels in interpret mode):
1e-3 of the largest gradient.  ``remat=True`` is bit-identical to
``remat=False``, also with the predictor running: the recompute draws the
same tokens from its generators, folded from a seed and the layer index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blade.attention.asa import ASAConfig as JASAConfig
from blade.attention.integration import asa_model_kwargs as j_asa_kwargs
from blade.attention.integration import extract_attn_aux
from blade.models import cogvideox_dit as jcog
from blade.training import lora as JL
from blade_torch.attention.asa import ASAConfig as TASAConfig
from blade_torch.attention.integration import asa_model_kwargs as t_asa_kwargs
from blade_torch.convert.from_jax import (
    cogvideox_lora_factors,
    cogvideox_transformer_state_dict,
    to_torch,
)
from blade_torch.models import cogvideox_dit as tcog
from blade_torch.training import lora as TL
from blade_torch.utils.rng import make_generator

TEXT = 8


def _perturb(tree, seed, scale=0.05):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


def _jax_params(lat, seed):
    model = jcog.CogVideoXModel(jcog.COGVIDEOX_TINY, dtype=jnp.float32, scan_layers=False)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros(lat), jnp.ones((lat[0],)),
                        jnp.zeros((lat[0], TEXT, 64)))
    return _perturb(params, seed + 1)


def test_asa_lora_gradients_match_jax_with_replayed_masks_and_remat_is_exact():
    lat = (1, 4, 16, 32, 32)  # 4 x 16 x 16 = 1024 video tokens + 8 text: 9 key blocks
    geo = dict(latent_width=16, latent_height=16, latent_frames=4, text_length=TEXT,
               sample_tokens_per_block=16, sample_gap=15, min_retain_ratio=0.05,
               max_retain_ratio=0.2)
    params = _jax_params(lat, 7)
    jmodel = jcog.CogVideoXModel(jcog.COGVIDEOX_TINY, dtype=jnp.float32, scan_layers=False,
                                 **j_asa_kwargs(JASAConfig(predictor="sum", **geo),
                                                interpret=True))
    rng = np.random.default_rng(8)
    x = rng.standard_normal(lat).astype(np.float32)
    text = rng.standard_normal((1, TEXT, 64)).astype(np.float32)
    cot = rng.standard_normal(lat).astype(np.float32)
    t = np.array([750.0], np.float32)
    _, state = jmodel.apply(params, x, t, text,
                            attn_kwargs={"rng": jax.random.PRNGKey(9), "collect_mask": True},
                            mutable=["intermediates"])
    jmasks = np.array(extract_attn_aux(state["intermediates"]))
    assert jmasks.shape == (2, 1, 2, 9, 9) and 0.2 < jmasks.mean() < 0.8
    jlora = _perturb(JL.init_lora(jax.random.PRNGKey(10), params, rank=4), 11, 0.1)

    def loss(lora):
        v = jmodel.apply(JL.merge_lora(params, lora, alpha=4.0, rank=4), x, t, text,
                         attn_kwargs={"masks": jnp.asarray(jmasks)})
        return jnp.sum(v * cot)

    want = cogvideox_lora_factors(jax.grad(loss)(jlora), 2, 2)
    sd = to_torch(cogvideox_transformer_state_dict(params, 2))
    lora = to_torch(cogvideox_lora_factors(jlora, 2, 2))

    def port_grads(remat, attn_kwargs):
        model = tcog.CogVideoXModel(tcog.COGVIDEOX_TINY, dtype=torch.float32, remat=remat,
                                    **t_asa_kwargs(TASAConfig(**geo)))
        model.load_state_dict(sd)
        model.requires_grad_(False)
        base = {n: p.detach() for n, p in model.named_parameters()}
        leaves = {k: v.clone().requires_grad_(True) for k, v in lora.items()}
        v = torch.func.functional_call(model, TL.merge_lora(base, leaves, alpha=4.0, rank=4),
                                       tuple(map(torch.from_numpy, (x, t, text))),
                                       {"attn_kwargs": attn_kwargs})
        return dict(zip(leaves, torch.autograd.grad((v * torch.from_numpy(cot)).sum(),
                                                    list(leaves.values()))))

    replay = {"masks": torch.from_numpy(jmasks)}
    grads = {remat: port_grads(remat, replay) for remat in (False, True)}
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(grads[False][k].numpy(), v, atol=1e-3 * scale, rtol=0,
                                   err_msg=k)
        torch.testing.assert_close(grads[True][k], grads[False][k], atol=0, rtol=0)
    # with the predictor running, the recompute draws the forward's tokens
    drawn = [port_grads(remat, {"generator": make_generator(12)}) for remat in (False, True)]
    for k in lora:
        torch.testing.assert_close(drawn[1][k], drawn[0][k], atol=0, rtol=0)
