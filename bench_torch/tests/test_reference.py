"""The plain references against the program on the CPU, in f32: ASA's two
lanes at many key blocks.  (The whole references, weights drawn again, DiT,
sampler and VAE, are held to the program by the tiny cells of
``test_harness.py``, whose limits are f32 rounding.)"""

import pytest
import torch

from bench_torch.reference import common as R


def _qkv(seed, heads, length, d):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((1, heads, length, d), generator=g) for _ in range(3)]


def _asa_cfg(mask_mode, **kw):
    from blade_torch.attention.asa import ASAConfig

    return ASAConfig(latent_width=10, latent_height=10, latent_frames=13, pre_arranged=True,
                     mask_mode=mask_mode, **kw)


@pytest.mark.parametrize("seed", [0, 2**40 + 1])
def test_energy_lane_matches_the_program(seed):
    from blade_torch.attention.asa import asa_attention

    q, k, v = _qkv(seed, 2, 1300, 64)
    cfg = _asa_cfg("energy", sample_gap=7, min_retain_ratio=0.1, max_retain_ratio=0.3)
    gen = lambda: torch.Generator().manual_seed(seed + 5)  # noqa: E731
    out, _, mask = asa_attention(q, k, v, cfg, generator=gen(), return_mask=True)
    asa = {"sample_tokens": 16, "sample_gap": 7, "min_retain_ratio": 0.1,
           "max_retain_ratio": 0.3, "energy_threshold": 0.95}
    ref, ref_mask = R.asa_energy(q[0], k[0], v[0], asa, gen())
    assert torch.equal(mask[0], ref_mask)
    assert 0.1 < ref_mask.float().mean() < 0.6
    assert float((out[0] - ref).norm() / ref.norm()) < 1e-5


@pytest.mark.parametrize("q_rows", [128, 256])
def test_multilevel_lane_matches_the_program(q_rows):
    from blade_torch.attention.asa import asa_attention
    from blade_torch.attention.masks import DEFAULT_MASK_RATIOS
    from blade_torch.kernels.ref_attention import lists_to_level_masks

    q, k, v = _qkv(q_rows, 2, 1320, 64)
    cfg = _asa_cfg("multilevel", text_length=20, multilevel_q_rows=q_rows)
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    out, _, (idx, cnt) = asa_attention(q, k, v, cfg, generator=gen(), return_mask=True)
    asa = {"sample_tokens": 16, "q_rows": q_rows,
           "mask_ratios": {str(lv): list(b) for lv, b in DEFAULT_MASK_RATIOS.items()}}
    ref, levels = R.asa_multilevel(q[0], k[0], v[0], asa, gen())
    lv = lists_to_level_masks(idx[0], cnt[0], levels.shape[-1])
    for li, level in enumerate((1, 2, 4, 8)):
        assert torch.equal(lv[..., li, :], levels == level)
    assert (levels == 8).any() and (levels == 0).any()
    assert float((out[0] - ref).norm() / ref.norm()) < 1e-5



@pytest.mark.parametrize("seed, score_bytes", [(0, 4 << 30), (2**40 + 3, 1)])
def test_gathered_energy_attention_and_its_gradient(monkeypatch, seed, score_bytes):
    """The training reference's energy lane (selected blocks gathered, the
    heads in groups, the scores computed again in the backward; one head a
    group with ``score_bytes`` 1) against the dense masked one, forward and gradient,
    with ragged rows and the two full last rows."""
    monkeypatch.setattr(R, "_SCORE_BYTES", score_bytes)
    q, k, v = (t[0].requires_grad_(True) for t in _qkv(seed, 2, 1300, 64))
    asa = {"sample_tokens": 16, "sample_gap": 7, "min_retain_ratio": 0.1,
           "max_retain_ratio": 0.3, "energy_threshold": 0.95}
    gen = lambda: torch.Generator().manual_seed(seed + 5)  # noqa: E731
    out, mask = R.asa_energy_grad(q, k, v, asa, gen())
    ref, ref_mask = R.asa_energy(q, k, v, asa, gen())
    assert torch.equal(mask, ref_mask) and mask[:, -1].all() and not mask[:, 0].all()
    assert float((out - ref).norm() / ref.norm()) < 1e-5
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    want = torch.autograd.grad((ref * w).sum(), (q, k, v))
    for g, r in zip(got, want):
        assert float((g - r).norm() / r.norm()) < 1e-5
