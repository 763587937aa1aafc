"""The port's ``ASAConfig`` fields ``energy_threshold``, ``use_rearrange``
and ``block_size`` against the JAX package, on the CPU.

Inputs come from a seeded numpy generator; JAX's token offsets are
recomputed from its key and injected into the port, as in
``test_torch_attention.py``.  The JAX side runs its Pallas kernels in
interpret mode.  Masks compare exactly; attention outputs are f32 on both
sides: 2e-5 absolute.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blade.attention import asa as jasa
from blade_torch.attention import asa as tasa
from blade_torch.attention.integration import asa_model_kwargs

ATOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _offsets(key, b, h):
    """JAX's per-(B, H) token offsets for Q and K from ``key``, in the order
    ``predict_block_scores`` draws them."""
    out = []
    for rng in jax.random.split(key):
        _, offs = jax.lax.top_k(jax.random.uniform(rng, (b, h, 128)), 16)
        out.append(_t(offs))
    return tuple(out)


def _pair(**fields):
    """The same config in both packages, "sum" predictor with 16 tokens a
    block named on the JAX side (its dataclass defaults are "max", 32)."""
    fields = dict(sample_tokens_per_block=16, **fields)
    return jasa.ASAConfig(predictor="sum", **fields), tasa.ASAConfig(**fields)


# test_asa.py's full-retention geometry: 16 x 8 x 4 latents = 4 blocks.
FULL = dict(latent_width=16, latent_height=8, latent_frames=4, text_length=0,
            sample_gap=4, min_retain_ratio=1.0, max_retain_ratio=1.0)
# test_telemetry.py's geometry: 16 x 16 x 8 latents = 16 blocks, no rearrange.
TELEMETRY = dict(latent_width=16, latent_height=16, latent_frames=8, text_length=0,
                 use_rearrange=False, sample_gap=8, min_retain_ratio=0.05,
                 max_retain_ratio=0.2)


def _qkv(seed, cfg, h=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, cfg.seq_len, d)).astype(np.float32)
            for _ in range(3)]


def test_energy_threshold_two_keeps_every_block_like_jax():
    """The twin of ``test_asa.py::test_asa_full_retention_close_to_dense``:
    threshold 2.0 is never reached and retention is clamped to 1.0, so the
    mask keeps every block, in both packages."""
    jcfg, tcfg = _pair(energy_threshold=2.0, **FULL)
    q, k, v = _qkv(0, tcfg)
    key = jax.random.PRNGKey(3)
    jout, jsp, jmask = jasa.asa_attention(key, q, k, v, jcfg, interpret=True,
                                          return_mask=True)
    out, sp, mask = tasa.asa_attention(_t(q), _t(k), _t(v), tcfg,
                                       offsets=_offsets(key, 1, 2), return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    assert float(sp) == pytest.approx(float(jsp), abs=1e-6)
    assert float(sp) <= 0.0  # full mask: sparsity = -1/gap


@pytest.mark.parametrize("threshold", [0.3, 0.95, 2.0])
def test_compute_mask_reads_energy_threshold_like_jax(threshold):
    """With retention free in [0.05, 1.0] the threshold alone decides each
    row's count; the port's mask must equal JAX's at every threshold."""
    fields = dict(TELEMETRY, max_retain_ratio=1.0, energy_threshold=threshold)
    jcfg, tcfg = _pair(**fields)
    q, k, _ = _qkv(1, tcfg)
    key = jax.random.PRNGKey(5)
    want = jasa.compute_mask(key, q, k, jcfg)
    got = tasa.compute_mask(_t(q), _t(k), tcfg, offsets=_offsets(key, 1, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if threshold == 2.0:
        assert got.all()
    else:
        assert not got.all()


def test_compute_mask_threshold_moves_density():
    _, low = _pair(**dict(TELEMETRY, max_retain_ratio=1.0, energy_threshold=0.3))
    high = dataclasses.replace(low, energy_threshold=0.95)
    q, k, _ = _qkv(2, low)
    offs = _offsets(jax.random.PRNGKey(6), 1, 2)
    m_low = tasa.compute_mask(_t(q), _t(k), low, offsets=offs)
    m_high = tasa.compute_mask(_t(q), _t(k), high, offsets=offs)
    assert m_low.float().mean() < m_high.float().mean()
    assert not (m_low & ~m_high).any()  # a lower threshold keeps a subset


def test_use_rearrange_false_matches_jax():
    """``use_rearrange=False`` at ``test_telemetry.py``'s geometry: no
    gilbert permutation around the attention, in both packages."""
    jcfg, tcfg = _pair(**TELEMETRY)
    q, k, v = _qkv(3, tcfg)
    key = jax.random.PRNGKey(9)
    jout, jsp, jmask = jasa.asa_attention(key, q, k, v, jcfg, interpret=True,
                                          return_mask=True)
    offs = _offsets(key, 1, 2)
    out, sp, mask = tasa.asa_attention(_t(q), _t(k), _t(v), tcfg, offsets=offs,
                                       return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert not mask.all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    assert float(sp) == pytest.approx(float(jsp), abs=1e-6)
    # The same call with the rearrangement on takes another mask.
    _, _, mask_r = tasa.asa_attention(_t(q), _t(k), _t(v),
                                      dataclasses.replace(tcfg, use_rearrange=True),
                                      offsets=offs, return_mask=True)
    assert not torch.equal(mask_r, mask)


def test_asa_model_kwargs_hoists_the_permutation_only_with_rearrange():
    _, tcfg = _pair(**TELEMETRY)
    assert set(asa_model_kwargs(tcfg)) == {"attention_fn"}
    kw = asa_model_kwargs(dataclasses.replace(tcfg, use_rearrange=True))
    assert set(kw) == {"attention_fn", "token_perm"}
    perm, inv = kw["token_perm"]
    np.testing.assert_array_equal(perm[inv], np.arange(tcfg.seq_len))


@pytest.mark.parametrize("block_size", [64, 256])
def test_block_size_other_than_128_raises(block_size):
    with pytest.raises(ValueError, match="128-token blocks"):
        tasa.ASAConfig(latent_width=8, latent_height=8, latent_frames=2,
                       block_size=block_size)
    assert tasa.ASAConfig(latent_width=8, latent_height=8, latent_frames=2).block_size == 128
