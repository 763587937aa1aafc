"""The benchmark's plain reference of Wan2.1 image to video
(``bench_torch/reference/wan_i2v.py``) against the port, on the CPU, in f32,
at the ``wan-i2v-tiny`` preset with the seed's weights:

* the port's I2V DiT forward (energy lane, image branch, 36 input channels)
  matches the reference's;
* the port's streaming encode equals its whole-clip encode, and the
  conditioning (mask and normalised encoding) matches the reference
  encoder's;
* the reference's gathered energy lane is ``common.asa_energy``'s function;
* a whole tiny I2V clip through the benchmark's driver (``drivers/i2v.py``:
  warm, one clip, the check) reads velocity, latents, frames and
  conditioning gaps at f32 rounding;
* planted faults each fail the cell's limits
  (``limits/wan-i2v-14b-480p.i2v.json``): the image branch dropped, one
  softmax over the text and image keys together, the mask channels
  zeroed, the encode's chunks without their carried caches;
* the configuration file is the program's ``wan-i2v-14b-480p`` preset, and
  the driver refuses a configuration whose energy threshold the preset
  does not serve;
* the reader ``vae_encode_s`` reads nothing without the program's
  ``encode.seconds`` (a text-to-video cell, or a program without the span)
  and that counter over the window's clips with it.
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

from bench_torch.harness.registry import Registry  # noqa: E402
from bench_torch.harness.trace import Spans  # noqa: E402
from bench_torch.reference import common as R  # noqa: E402
from bench_torch.reference import wan_i2v as WI  # noqa: E402
from blade_torch import config as C  # noqa: E402
from blade_torch.kernels import block_sparse_attn as BSA  # noqa: E402
from blade_torch.models import vae_wan as V  # noqa: E402
from blade_torch.models import wan_dit as WD  # noqa: E402
from blade_torch.sampling.t2v import T2VPipeline  # noqa: E402
from blade_torch.utils.rng import make_generator  # noqa: E402

CELL = "wan-i2v-14b-480p.i2v"
CONFIG = REPO / "bench_torch" / "configs" / "wan2.1-i2v-14b-480p.json"
VIDEO = C.VideoSpec(9, 64, 64, fps=4)
PRESET = dataclasses.replace(C.WAN_I2V_TINY_PRESET, video=VIDEO)


def _tiny_config():
    """The tiny Wan test configuration at ``PRESET``'s sizes, image to
    video."""
    c = json.loads((REPO / "bench_torch" / "tests" / "data" / "wan-tiny.json").read_text())
    d = PRESET.dit
    c.update(name="wan-i2v-tiny", family="wan_i2v", preset="wan-i2v-tiny",
             in_channels=d.in_channels, image_dim=d.image_dim, image_len=d.image_context_tokens,
             video={"frames": VIDEO.num_frames, "height": VIDEO.height, "width": VIDEO.width,
                    "fps": VIDEO.fps})
    c["asa"] = dict(c["asa"], energy_threshold=0.95)
    return c


def _rel(got, want):
    return float((got.float() - want).norm() / want.norm())


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    d = PRESET.dit
    image = torch.randint(0, 256, (1, 3, VIDEO.height, VIDEO.width), generator=g) / 127.5 - 1.0
    feats = torch.randn((1, d.image_context_tokens, d.image_dim), generator=g)
    text = torch.randn((1, PRESET.max_text_len, PRESET.text_dim), generator=g)
    return image, feats, text


def test_the_gathered_energy_lane_is_common_asa_energy():
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((2, 39 * 128 + 91, 64), generator=g) for _ in range(3))
    asa = {"sample_tokens": 16, "sample_gap": 30, "min_retain_ratio": 0.05,
           "max_retain_ratio": 0.2, "energy_threshold": 0.95}
    got, mask = R.asa_energy_grad(q, k, v, asa, torch.Generator().manual_seed(5))
    want, want_mask = R.asa_energy(q, k, v, asa, torch.Generator().manual_seed(5))
    assert torch.equal(mask, want_mask) and not bool(mask.all())
    assert _rel(got, want) < 1e-6


def test_streaming_encode_is_the_whole_clip_and_the_reference_encoder():
    c, seed = _tiny_config(), 2**34 + 3
    pipe = T2VPipeline.random_init(PRESET, make_generator(seed), dtype=torch.float32)
    image, _, _ = _inputs()
    video = torch.randn((1, VIDEO.num_frames, VIDEO.height, VIDEO.width, 3),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        whole, streamed = pipe.vae.encode(video), V.streaming_encode(pipe.vae, video)
    assert streamed.shape == (1, 5, 32, 32, 16)
    assert float((streamed - whole).abs().max()) < 1e-5 * float(whole.abs().max())
    cond = pipe.encode_image(image)
    assert cond.shape == (1, 20, 5, 32, 32)
    _, enc = WI.vae_weights(c, seed, torch.device("cpu"))
    with R.strict_f32():
        ref = WI.vae_encode(enc, c, image)
    assert _rel(cond[:, 4:], ref) < 1e-5
    assert torch.equal(cond[:, :4], WI.mask_channels(c, ref))
    assert bool((cond[:, :4, 0] == 1).all()) and not bool(cond[:, :4, 1:].any())


def test_the_ports_i2v_dit_forward_matches_the_reference():
    c, seed = _tiny_config(), 2**35 + 9
    pipe = T2VPipeline.random_init(PRESET, make_generator(seed), dtype=torch.float32)
    image, feats, text = _inputs(3)
    cond = pipe.encode_image(image)
    latents = torch.randn(pipe.latent_shape(1), generator=torch.Generator().manual_seed(6))
    assert latents.shape == (1, 16, 5, 32, 32)  # 5 x 16 x 16 tokens: 10 key blocks
    step_seed, t = 77, 613.0
    with torch.no_grad():
        got = pipe.dit(latents, torch.tensor([t]), text,
                       attn_kwargs={"generator": make_generator(step_seed)},
                       image_embeds=feats, condition=cond)
    w = WI.dit_weights(c, seed, torch.device("cpu"))
    with R.strict_f32():
        want = WI.dit_forward(w, c, latents, t, text, step_seed, image_embeds=feats,
                              condition=cond)
    assert _rel(got, want) < 1e-5


# -- a whole clip through the benchmark's driver ------------------------------

@pytest.fixture
def tiny_presets(monkeypatch):
    monkeypatch.setitem(C.PRESETS, "wan-i2v-tiny", PRESET)


@pytest.fixture(autouse=True)
def _two_threads():
    """Whole tiny clips are many small operations: two intra-op threads keep
    them from contending with the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _clip_gaps(seed=2**33 + 11):
    """One tiny clip through ``drivers/i2v.py`` (the cell's mix at 2 sampler
    steps, which the check samples both of): warm, one clip, the check."""
    reg = Registry()
    traffic = dict(reg.traffic(reg.workload(CELL)["traffic"]), num_steps=2)
    limits = reg.limits(CELL)
    driver = reg.module("drivers", traffic["driver"]).Driver(
        _tiny_config(), traffic, seed=seed, device=torch.device("cpu"), spans=Spans(False),
        check_steps=limits["check_steps"])
    driver.warm()
    driver.issue(0)
    return driver.check(limits["check_steps"]), limits["limits"]


def test_a_whole_tiny_clip_matches_the_reference(tiny_presets):
    got, limits = _clip_gaps()
    assert set(got) == set(limits) == {"velocity_rel_err", "latents_rel_err", "frames_mae",
                                       "cond_rel_err"}
    assert got["velocity_rel_err"] < 1e-5 and got["latents_rel_err"] < 1e-6
    assert got["cond_rel_err"] < 1e-5 and got["frames_mae"] <= 0.01


def _drop_image_branch(monkeypatch):
    forward = WD.WanCrossAttention.forward
    monkeypatch.setattr(WD.WanCrossAttention, "forward",
                        lambda self, x, context, image_context=None: forward(self, x, context))


def _one_softmax(monkeypatch):
    """The text and image keys under one softmax (769 keys at full size)."""
    def forward(self, x, context, image_context=None):
        c = self.c
        q = WD.heads_pack(self.norm_q(self.to_q(x)), c.num_heads)
        k = torch.cat([self.norm_k(self.to_k(context)),
                       self.norm_added_k(self.add_k_proj(image_context))], 1)
        v = torch.cat([self.to_v(context), self.add_v_proj(image_context)], 1)
        out, _ = BSA.flash_attention(q, WD.heads_pack(k, c.num_heads),
                                     WD.heads_pack(v, c.num_heads))
        return self.to_out[0](WD.heads_unpack(out))

    monkeypatch.setattr(WD.WanCrossAttention, "forward", forward)


def _zero_mask(monkeypatch):
    condition = C.FAMILIES["wan-i2v"].condition

    def zeroed(vae, preset, image):
        out = condition(vae, preset, image)
        return torch.cat([torch.zeros_like(out[:, :4]), out[:, 4:]], 1)

    monkeypatch.setitem(C.FAMILIES, "wan-i2v",
                        dataclasses.replace(C.FAMILIES["wan-i2v"], condition=zeroed))


def _encode_without_cache(monkeypatch):
    encode = V.WanVAE.encode_with_cache
    monkeypatch.setattr(V.WanVAE, "encode_with_cache",
                        lambda self, video, cache=None: encode(self, video, None))


@pytest.mark.parametrize("fault", [_drop_image_branch, _one_softmax, _zero_mask,
                                   _encode_without_cache])
def test_a_planted_fault_fails_the_cells_limits(tiny_presets, monkeypatch, fault):
    fault(monkeypatch)
    got, limits = _clip_gaps()
    assert any(got[name] > lim for name, lim in limits.items()), got


def test_the_configuration_is_the_programs_preset():
    c = json.loads(CONFIG.read_text())
    WI.check_preset(c, C.PRESETS["wan-i2v-14b-480p"])
    assert c["reduced"] == [] and c["family"] == "wan_i2v"
    assert C.PRESETS["wan-i2v-14b-480p"].latent_grid() == (21, 30, 52)


@pytest.mark.parametrize("change", [("in_channels", 16), ("image_dim", 1024), ("image_len", 256),
                                   ("num_layers", 39), ("flow_shift", 5.0)])
def test_a_changed_configuration_key_is_refused(change):
    key, value = change
    c = json.loads(CONFIG.read_text())
    c[key] = value
    with pytest.raises(ValueError):
        WI.check_preset(c, C.PRESETS["wan-i2v-14b-480p"])


def test_the_driver_refuses_another_energy_threshold(tiny_presets):
    reg = Registry()
    traffic = reg.traffic(reg.workload(CELL)["traffic"])
    c = _tiny_config()
    c["asa"] = dict(c["asa"], energy_threshold=0.9)
    with pytest.raises(ValueError, match="energy threshold"):
        reg.module("drivers", traffic["driver"]).Driver(
            c, traffic, seed=1, device=torch.device("cpu"), spans=Spans(False))


def test_vae_encode_s_is_none_without_its_counter_and_its_counter_a_clip(monkeypatch):
    mod = Registry().module("metrics", "vae_encode_s")
    monkeypatch.setattr(mod, "counters", lambda: {"sample.seconds": 4.0, "decode.seconds": 2.0})
    assert mod.read({"units": 2}) is None
    monkeypatch.setattr(mod, "counters", dict)
    assert mod.read({"units": 2}) is None
    monkeypatch.setattr(mod, "counters", lambda: {"encode.seconds": 7.5})
    assert mod.read({"units": 3}) == pytest.approx(2.5)
    assert mod.read({"units": 0}) is None
