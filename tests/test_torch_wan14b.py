"""The Wan2.1-T2V-14B 720p preset and the serving weight storage, on the CPU.

* The preset's geometry against the JAX package's ``WAN_14B_720P`` (the
  twin of ``tests/test_large_presets.py::test_wan_14b_720p_geometry``):
  75 600 tokens in 591 key blocks, past the fused lane, so the CLI's
  ``--mask_mode multilevel`` runs the per-level lane; Wan's default lane
  stays energy.
* Its parameter storage, counted on the ``meta`` device: 14.29 B weights,
  the bf16 projections 28.2 GB and the f32 rest 0.75 GB, so the DiT fits
  one 80 GB card.
* bf16 weight storage is bit-identical to f32 storage with bf16 compute
  (``layers.Linear`` rounds its weights in the forward either way), on a
  tiny Wan and a tiny CogVideoX model, and random init gives the same
  weights whatever the storage.
"""

import pytest
import torch

from blade import config as jconfig
from blade.kernels.multilevel_attn import fused_supported as j_fused_supported
from blade_torch import config as C
from blade_torch.cli import inference as cli
from blade_torch.kernels.multilevel_attn import fused_supported
from blade_torch.models.cogvideox_dit import COGVIDEOX_TINY, CogVideoXModel
from blade_torch.models.layers import Linear
from blade_torch.models.wan_dit import WAN_14B, WAN_TINY, WanModel
from blade_torch.utils.rng import make_generator


def test_wan_14b_720p_geometry():
    p, jp = C.PRESETS["wan-14b-720p"], jconfig.PRESETS["wan-14b-720p"]
    assert p is C.WAN_14B_720P
    assert p.latent_grid() == jp.latent_grid() == (21, 45, 80)
    asa, jasa = C.derive_asa_config(p, "multilevel"), jconfig.derive_asa_config(jp, "multilevel")
    assert asa.seq_len == jasa.seq_len == 75_600
    assert -(-asa.seq_len // 128) == 591
    assert asa.multilevel_q_rows == jasa.multilevel_q_rows == 128
    assert not fused_supported(128, 75_600) and not j_fused_supported(128, 75_600, 2)
    for f in ("dim", "ffn_dim", "num_layers", "num_heads", "head_dim"):
        assert getattr(p.dit, f) == getattr(jp.dit, f), f
    assert (p.dit.dim, p.dit.num_layers, p.dit.num_heads, p.dit.head_dim) == (5120, 40, 40, 128)
    for f in ("flow_shift", "sample_gap", "max_retain_ratio", "min_retain_ratio",
              "max_text_len"):
        assert getattr(p, f) == getattr(jp, f), f
    assert p.flow_shift == 5.0 and p.video == C.VideoSpec(81, 720, 1280, fps=16)
    # the CLI: Wan's default lane stays energy; --mask_mode multilevel picks
    # this slice's lane
    assert p.family.mask_mode == "energy"
    args = cli.get_args(["--preset", "wan-14b-720p", "--mask_mode", "multilevel",
                         "--random-init", "--prompt", "x"])
    assert C.derive_asa_config(C.PRESETS[args.preset], args.mask_mode).mask_mode == "multilevel"


def test_wan_14b_parameter_storage():
    model = WanModel(WAN_14B, dtype=torch.bfloat16, device="meta")
    by_dtype = {}
    for p in model.parameters():
        by_dtype[p.dtype] = by_dtype.get(p.dtype, 0) + p.numel()
    assert set(by_dtype) == {torch.bfloat16, torch.float32}
    assert 14.2e9 < sum(by_dtype.values()) < 14.4e9
    assert 2 * by_dtype[torch.bfloat16] == 28_201_021_440  # 14.10 B bf16 weights
    assert 4 * by_dtype[torch.float32] == 751_923_456  # 0.19 B f32 (time_proj, ...)
    for name, m in model.named_modules():
        if isinstance(m, Linear):  # time_proj / time embedder / proj_out stay f32
            assert m.weight.dtype == m.compute_dtype, name


def _f32_storage(model):
    for m in model.modules():
        if isinstance(m, Linear):
            m.float()
    return model


@pytest.mark.parametrize("family", ["wan", "cogvideox"])
def test_bf16_storage_is_bit_identical(family):
    if family == "wan":
        build = lambda dtype: WanModel(WAN_TINY, dtype=dtype)
        x = torch.randn(1, 16, 2, 8, 8, generator=torch.Generator().manual_seed(1))
        text = torch.randn(1, 8, WAN_TINY.text_dim, generator=torch.Generator().manual_seed(2))
    else:
        build = lambda dtype: CogVideoXModel(COGVIDEOX_TINY, dtype=dtype)
        x = torch.randn(1, 2, 16, 8, 8, generator=torch.Generator().manual_seed(1))
        text = torch.randn(1, 8, COGVIDEOX_TINY.text_embed_dim,
                           generator=torch.Generator().manual_seed(2))
    t = torch.tensor([640.0])
    f32_weights = build(torch.float32).random_init_(make_generator(3)).state_dict()
    bf16 = build(torch.bfloat16)
    wide = _f32_storage(build(torch.bfloat16))
    assert any(p.dtype == torch.bfloat16 for p in bf16.parameters())
    assert all(p.dtype == torch.float32 for p in wide.parameters())
    bf16.load_state_dict(f32_weights)
    wide.load_state_dict(f32_weights)
    with torch.no_grad():
        got, want = bf16(x, t, text), wide(x, t, text)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # random init draws in f32 whatever the storage
    a = build(torch.bfloat16).random_init_(make_generator(4))
    b = _f32_storage(build(torch.bfloat16)).random_init_(make_generator(4))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb.to(pa.dtype), atol=0, rtol=0, msg=name)
