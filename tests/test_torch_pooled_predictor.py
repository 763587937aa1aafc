"""The "max" predictor of the port against the JAX package, on the CPU.

``kernels.pooled_predictor.pooled_scores`` (its plain version on CPU
tensors) against JAX's Pallas kernel ``pooled_scores_kernel_call`` in
interpret mode, both in f32: 1e-5 absolute on ``Po`` entries of 1e-3 to 1
(accumulation order only).  Against JAX's ``masks.pooled_attention_scores``,
which rounds Q and K to bf16 for the score product: 1e-2.  The port's
``masks.pooled_attention_scores`` rounds the same way as JAX's: 1e-5.
Sampled lengths cover tokens per block 16 and 32, head dims 64 and 128, and
lengths that are not multiples of the TPU kernel's 256 / 512 tiles.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blade import config as jconfig
from blade.attention import asa as jasa
from blade.attention import masks as jmasks
from blade.kernels.pooled_predictor import pooled_scores_kernel_call
from blade_torch import config as tconfig
from blade_torch.attention import asa as tasa
from blade_torch.attention import masks as tmasks
from blade_torch.kernels.pooled_predictor import pooled_scores

CASES = [  # (tokens per block, d, q blocks, k blocks)
    (32, 64, 10, 7),    # Ls 320, Lks 224
    (16, 128, 20, 9),   # Ls 320, Lks 144
    (32, 128, 8, 16),   # Ls 256, Lks 512: whole TPU tiles
    (16, 64, 3, 33),    # Ls 48, Lks 528
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _qk(seed, tpb, d, nq, nk, h=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, h, nq * tpb, d)).astype(np.float32)
    k = rng.standard_normal((1, h, nk * tpb, d)).astype(np.float32)
    # a few strong (query block, key block) pairs so the rows are not flat
    for i in range(0, nq, 3):
        j = (5 * i + 1) % nk
        k[:, :, j * tpb:(j + 1) * tpb] += 0.5 * q[:, :, i * tpb:(i + 1) * tpb]
    return q, k


@pytest.mark.parametrize("tpb,d,nq,nk", CASES)
def test_pooled_scores_match_jax_kernel(tpb, d, nq, nk):
    q, k = _qk(tpb * d + nq, tpb, d, nq, nk)
    want = np.asarray(pooled_scores_kernel_call(q, k, tokens_per_block=tpb, interpret=True))
    got = pooled_scores(_t(q), _t(k), tpb)
    assert got.dtype == torch.float32 and got.shape == (1, 2, nq, nk) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("tpb,d,nq,nk", CASES)
def test_pooled_scores_match_jax_bf16_estimate(tpb, d, nq, nk):
    q, k = _qk(tpb + d + nk, tpb, d, nq, nk)
    want = np.asarray(jmasks.pooled_attention_scores(q, k, tokens_per_block=tpb, q_chunk=64))
    np.testing.assert_allclose(pooled_scores(_t(q), _t(k), tpb).numpy(), want, atol=1e-2,
                               rtol=0)
    # the port's counterpart of the bf16 estimate rounds as JAX's does
    got = tmasks.pooled_attention_scores(_t(q), _t(k), tokens_per_block=tpb, q_chunk=64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_pooled_scores_chunking_changes_no_value():
    q, k = _qk(3, 32, 64, 12, 10)
    whole = tmasks.pooled_scores_plain(_t(q), _t(k), 32, 0.125, q_chunk=12 * 32)
    for chunk in (32, 100, 200):
        torch.testing.assert_close(tmasks.pooled_scores_plain(_t(q), _t(k), 32, 0.125,
                                                              q_chunk=chunk), whole,
                                   atol=0, rtol=0)


def test_pooled_scores_rejects_partial_blocks():
    q, k = _qk(4, 32, 64, 2, 2)
    with pytest.raises(ValueError):
        pooled_scores(_t(q[:, :, :50]), _t(k), 32)


def _cfgs(predictor, tokens):
    base = dict(latent_width=8, latent_height=8, latent_frames=12, sample_gap=30,
                min_retain_ratio=0.05, max_retain_ratio=0.2, sample_tokens_per_block=tokens)
    return (jasa.ASAConfig(predictor=predictor, **base),
            tasa.ASAConfig(predictor=predictor, **base))


def _jax_offsets(rng, b, h, block, keep):
    _, offs = jax.lax.top_k(jax.random.uniform(rng, (b, h, block)), keep)
    return _t(offs)


@pytest.mark.parametrize("tokens", [32, 16])
def test_max_predictor_with_injected_offsets_matches_jax(tokens):
    """``predict_block_scores(predictor="max")``: JAX's offsets recomputed
    from its key and injected; 700 tokens are edge-padded to 6 blocks."""
    jcfg, tcfg = _cfgs("max", tokens)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 2, 700, 128)).astype(np.float32)
    k = rng.standard_normal((1, 2, 700, 128)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jasa.predict_block_scores(key, q, k, jcfg))
    rq, rk = jax.random.split(key)
    offs = (_jax_offsets(rq, 1, 2, 128, tokens), _jax_offsets(rk, 1, 2, 128, tokens))
    got = tasa.predict_block_scores(_t(q), _t(k), tcfg, offsets=offs)
    assert got.dtype == torch.float32 and got.shape == (1, 2, 6, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    mask = tasa.compute_mask(_t(q), _t(k), tcfg, offsets=offs)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmasks.energy_mask(
        want, min_retain_ratio=0.05, max_retain_ratio=0.2)))


def test_predictor_fields_pass_through_the_presets():
    """The port's presets keep the serving defaults ("sum", 16); a preset
    with the reference-parity fields derives the same ASA config in both
    packages."""
    assert tconfig.WAN_480P.asa_predictor == jconfig.WAN_480P.asa_predictor == "sum"
    assert tasa.ASAConfig(1, 1, 1).predictor == "sum"
    tp = dataclasses.replace(tconfig.WAN_480P, asa_predictor="max", asa_sample_tokens=32)
    jp = dataclasses.replace(jconfig.WAN_480P, asa_predictor="max", asa_sample_tokens=32)
    tc, jc = tconfig.derive_asa_config(tp), jconfig.derive_asa_config(jp)
    assert (tc.predictor, tc.sample_tokens_per_block) == (jc.predictor,
                                                          jc.sample_tokens_per_block)
    assert (tc.predictor, tc.sample_tokens_per_block) == ("max", 32)
    with pytest.raises(ValueError, match="predictor"):
        tasa.predict_block_scores(torch.zeros(1, 1, 128, 64), torch.zeros(1, 1, 128, 64),
                                  dataclasses.replace(tc, predictor="mean"))
