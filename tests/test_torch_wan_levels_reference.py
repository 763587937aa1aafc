"""The benchmark's gathered multilevel reference (``bench_torch/reference/
wan_levels.py``, the plain reference of Wan2.1-T2V-14B at 720p) on the CPU,
in f32:

* its gathered attention is ``common.asa_multilevel``'s function (the dense
  one over every level's keys), at a ragged last block;
* the port's per-level lane (the fused lane refused, as past 256 key blocks)
  gives the same level masks and the same output;
* a tiny Wan DiT forward of the port on that lane matches the reference's
  forward on the seed's weights;
* the configuration file is the program's ``wan-14b-720p`` preset.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from bench_torch.reference import common as R  # noqa: E402
from bench_torch.reference import wan_levels as WL  # noqa: E402
from blade_torch import config as C  # noqa: E402
from blade_torch.attention import asa as A  # noqa: E402
from blade_torch.kernels import multilevel_attn as MA  # noqa: E402
from blade_torch.utils.rng import make_generator  # noqa: E402

CONFIG = REPO / "bench_torch" / "configs" / "wan2.1-t2v-14b-720p.json"
RATIOS = {"1": [0.0, 0.05], "2": [0.05, 0.15], "4": [0.15, 0.25], "8": [0.25, 0.5],
          "0": [0.5, 1.0]}
ASA = {"sample_tokens": 16, "q_rows": 128, "mask_ratios": RATIOS}
# 40 key blocks, the last one 91 keys long.
LENGTH = 39 * 128 + 91


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def _qkv(seed, heads=2, length=LENGTH, d=64):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((heads, length, d), generator=g) for _ in range(3)]


@pytest.fixture
def per_level(monkeypatch):
    """The port with the fused multilevel lane refused everywhere."""
    for mod in (A, MA):
        monkeypatch.setattr(mod, "fused_supported", lambda *a, **kw: False)


@pytest.mark.parametrize("seed", [3, 2**40 + 7])
def test_gathered_levels_are_the_dense_multilevel_lane(seed):
    q, k, v = _qkv(seed)
    out, levels = WL.asa_levels(q, k, v, ASA, torch.Generator().manual_seed(seed + 1))
    ref, ref_levels = R.asa_multilevel(q, k, v, ASA, torch.Generator().manual_seed(seed + 1))
    assert torch.equal(levels, ref_levels)
    assert all((levels == lv).any() for lv in (0, 1, 2, 4, 8))
    assert _rel(out, ref) < 1e-6


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_the_ports_per_level_lane_matches_the_gathered_reference(per_level, seed):
    q, k, v = _qkv(seed)
    cfg = A.ASAConfig(latent_width=13, latent_height=17, latent_frames=23, pre_arranged=True,
                      mask_mode="multilevel")
    assert cfg.video_tokens == LENGTH
    out, _, levels = A.asa_attention(q[None], k[None], v[None], cfg,
                                     generator=make_generator(seed + 2), return_mask=True)
    ref, ref_levels = WL.asa_levels(q, k, v, ASA, torch.Generator().manual_seed(seed + 2))
    assert levels.shape == (1, 2, 40, 40) and torch.equal(levels[0].long(), ref_levels)
    assert _rel(out[0], ref) < 1e-5


def _tiny_config():
    c = json.loads((REPO / "bench_torch" / "tests" / "data" / "wan-tiny.json").read_text())
    c["video"] = {"frames": 9, "height": 96, "width": 96, "fps": 4}
    c["asa"] = dict(json.loads(CONFIG.read_text())["asa"])
    return c


def test_a_tiny_dit_forward_on_the_per_level_lane_matches_the_reference(per_level):
    from blade_torch.sampling.t2v import T2VPipeline

    c = _tiny_config()
    preset = dataclasses.replace(C.WAN_TINY_PRESET, video=C.VideoSpec(9, 96, 96, fps=4))
    seed = 2**35 + 9
    pipe = T2VPipeline.random_init(preset, make_generator(seed), mask_mode="multilevel",
                                   dtype=torch.float32)
    shape = pipe.latent_shape(1)
    assert shape[2] * shape[3] * shape[4] // 4 == 2880  # 23 key blocks, the last ragged
    g = torch.Generator().manual_seed(1)
    latents = torch.randn(shape, generator=g)
    text = torch.randn((1, c["text_len"], c["text_dim"]), generator=g)
    step_seed, t = 77, 613.0
    kept = []
    fn = pipe.dit.attention_fn

    def collecting(q, k, v, **kw):
        out, mask = fn(q, k, v, **dict(kw, collect_mask=True))
        kept.append(mask)
        return out

    pipe.dit.attention_fn = collecting
    with torch.no_grad():
        got = pipe.dit(latents, torch.tensor([t]), text,
                       attn_kwargs={"generator": make_generator(step_seed)})
    assert len(kept) == c["num_layers"] and all(m.dtype == torch.int32 for m in kept)
    w = WL.dit_weights(c, seed, torch.device("cpu"))
    with R.strict_f32():
        want = WL.dit_forward(w, c, latents, t, text, step_seed)
    assert _rel(got, want) < 1e-5


def test_the_configuration_is_the_programs_preset():
    from blade_torch.attention.masks import DEFAULT_MASK_RATIOS

    c = json.loads(CONFIG.read_text())
    WL.check_preset(c, C.WAN_14B_720P)
    assert C.WAN_14B_720P.asa_mask_ratios is None and WL.PUBLISHED_RATIOS == DEFAULT_MASK_RATIOS
    assert c["reduced"] == [] and c["family"] == "wan_levels"


@pytest.mark.parametrize("change", [
    ("dim", 5120 + 128), ("num_layers", 39), ("flow_shift", 3.0),
    ("asa.q_rows", 256), ("asa.lane", "energy"),
    ("asa.mask_ratios", dict(RATIOS, **{"1": [0.0, 0.1]})),
])
def test_a_changed_configuration_key_is_refused(change):
    key, value = change
    c = json.loads(CONFIG.read_text())
    if key.startswith("asa."):
        c["asa"][key[4:]] = value
    else:
        c[key] = value
    with pytest.raises(ValueError):
        WL.check_preset(c, C.WAN_14B_720P)
