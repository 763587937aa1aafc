"""The port's ASA multilevel lane against the JAX package, on the CPU: the
predictor's scores (JAX's token offsets recomputed from its key and
injected), their coarsening to 256-row mask rows, the per-level lists, and
the full ``asa_attention`` over a ``[text, video]`` sequence (gilbert
rearrangement with the text moved behind the video, the fused multilevel
lane, the sparsity metric).  JAX's Pallas kernels run in interpret mode.
f32 on both sides: scores and outputs agree to 2e-5 absolute; the lists
from the same scores are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blade.attention import asa as jasa
from blade_torch.attention import asa as tasa
from blade_torch.attention import masks as TM
from blade_torch.attention.integration import make_asa_attention_fn

GEO = dict(latent_width=16, latent_height=16, latent_frames=4, text_length=24,
           sample_tokens_per_block=16, mask_mode="multilevel", multilevel_q_rows=256)
L = 16 * 16 * 4 + 24  # 1048 tokens: 9 key blocks, 5 mask rows of 256


def _offsets(rng, b, h):
    rq, rk = jax.random.split(rng)
    return tuple(torch.from_numpy(np.array(jax.lax.top_k(
        jax.random.uniform(r, (b, h, 128)), 16)[1])) for r in (rq, rk))


def test_multilevel_lane_matches_jax():
    jcfg, tcfg = jasa.ASAConfig(predictor="sum", **GEO), tasa.ASAConfig(**GEO)
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, L, 64)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    key = jax.random.PRNGKey(1)
    offs = _offsets(key, 1, 2)

    # predictor scores and their coarsening (on arranged tokens)
    j_scores = np.array(jasa._coarsen_scores(
        jasa.predict_block_scores(key, jnp.asarray(q), jnp.asarray(k), jcfg), jcfg))
    t_scores = tasa._coarsen_scores(tasa.predict_block_scores(tq, tk, tcfg, offsets=offs),
                                    tcfg)
    assert t_scores.shape == (1, 2, 5, 9)
    np.testing.assert_allclose(t_scores.numpy(), j_scores, atol=2e-5, rtol=0)
    j_lists = jasa.compute_lists(key, jnp.asarray(q), jnp.asarray(k), jcfg)
    t_lists = TM.multilevel_lists(torch.from_numpy(j_scores), cap=128)
    for a, b in zip(t_lists, j_lists):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the level mask of compute_mask is at mask-row granularity too
    np.testing.assert_array_equal(
        tasa.compute_mask(tq, tk, tcfg, offsets=offs).shape, (1, 2, 5, 9))

    # full ASA over [text, video] with rearrangement, fresh and replayed
    j_out, j_sparsity, j_mask = jasa.asa_attention(
        key, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, interpret=True,
        return_mask=True)
    t_out, t_sparsity, t_mask = tasa.asa_attention(tq, tk, tv, tcfg, offsets=offs,
                                                   return_mask=True)
    for a, b in zip(t_mask, j_mask):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5, rtol=0)
    assert abs(t_sparsity - float(j_sparsity)) < 1e-7
    replayed, _ = tasa.asa_attention(tq, tk, tv, tcfg, mask=t_mask)
    np.testing.assert_array_equal(replayed.numpy(), t_out.numpy())


def test_attention_fn_collects_and_replays_lists():
    cfg = tasa.ASAConfig(**dict(GEO, text_length=0, latent_frames=2))
    q, k, v = (torch.randn(1, 2, 512, 64, generator=torch.Generator().manual_seed(s))
               for s in range(3))
    fn = make_asa_attention_fn(cfg)
    out, lists = fn(q, k, v, layer_index=3, collect_mask=True)
    assert isinstance(lists, tuple) and lists[0].shape == (1, 2, 2, 4, 128)
    stacked = tuple(torch.stack([t, t]) for t in lists)
    again = fn(q, k, v, layer_index=1, masks=stacked)
    torch.testing.assert_close(again, out, atol=0, rtol=0)
