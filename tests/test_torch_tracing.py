"""The port's spans and counters (``blade_torch.utils.tracing``) on the CPU.

* Off (no profiler recording): ``span`` hands out one shared
  ``nullcontext``, nothing of ``torch.profiler`` runs and nothing is
  counted, through a whole generation.
* Under a CPU ``torch.profiler``: one ``generate`` of the tiny Wan (energy
  lane) and CogVideoX (multilevel lane) presets, at a video large enough to
  leave blocks unselected and to chunk and tile the decode, opens every
  span of its layers, each inside the span the module doc lists as its
  parent; ``blade.dit`` runs once a step and ``blade.asa`` once a layer a
  step; the ASA counters give the mean density of the masks the model's
  ``collect_mask`` protocol returns in the same run.
* One tiny TDM step with remat: the ``tdm.*`` phases, two host readbacks,
  and the blocks recomputed in the backward kept out of the forward's
  counters.
* ``--profile PATH`` of the inference CLI writes a Chrome trace holding the
  spans.
* Wan's text cross-attention counts ``dit.cross_attn.calls`` once a layer a
  forward (CogVideoX, which has none, counts nothing of it); remat's
  recomputation counts ``dit.cross_attn.recomputed_calls`` alone.
* Wan2.1-I2V's generate opens ``encode`` (with ``encode.chunk`` a chunk of
  the streaming encode), ``dit.image_embed`` once a forward and
  ``dit.cross_attn.image`` inside every ``dit.cross_attn``, and counts
  ``dit.cross_attn.image_calls`` once a layer a forward and
  ``encode.seconds``; the text-to-video families open and count none of
  them.
* Wan's block glue counts ``dit.modulate.fused_calls`` once a layer a
  no-grad forward (CogVideoX counts nothing of it) and
  ``dit.modulate.autograd_calls`` once a layer a forward autograd records;
  remat's recomputation counts neither.
* Past the fused lane's rule an int level mask takes the per-level lane on
  the CPU (the level carry is the card's); the carry itself opens
  ``asa.level_lists`` and counts ``asa.level_carry_calls``, not where
  recomputed.
"""

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blade_torch import config as C
from blade_torch.cli import inference as tcli
from blade_torch.cli import train as T
from blade_torch.models.wan_dit import WAN_TINY, WanModel
from blade_torch.sampling.t2v import T2VPipeline
from blade_torch.training import tdm
from blade_torch.utils import tracing
from blade_torch.utils.rng import fold_generator, make_generator

STEPS = 2
# A span's parent: the innermost other ``blade.*`` span around it on its thread.
PARENTS = {
    "sample": {None}, "sample.step": {"sample"}, "sample.update": {"sample.step"},
    "dit": {"sample.step"}, "dit.embed": {"dit"}, "dit.block": {"dit"}, "dit.head": {"dit"},
    "dit.modulate": {"dit.block"}, "dit.qkv": {"dit.block"}, "dit.self_attn": {"dit.block"},
    "dit.cross_attn": {"dit.block"}, "dit.ffn": {"dit.block"},
    "asa": {"dit.self_attn"}, "asa.predict": {"asa"}, "asa.select": {"asa"},
    "asa.sparse": {"asa"}, "asa.pooled": {"asa"}, "asa.merge": {"asa"},
    "decode": {None}, "decode.tile": {"decode"}, "decode.chunk": {"decode", "decode.tile"},
}
LANES = {
    "wan": (C.WAN_TINY_PRESET, "energy", {"dit.cross_attn", "asa.pooled", "asa.merge"}),
    "cogvideox": (C.COGVIDEOX_TINY_PRESET, "multilevel", {"decode.tile"}),
}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


def _pipe(family):
    preset, mode, _ = LANES[family]
    # 5 x 16 x 16 latent tokens (10 key blocks); CogVideoX's 32 x 32 latent
    # frames take the tiled decode.
    preset = dataclasses.replace(preset, video=C.VideoSpec(9, 64, 64, fps=4))
    return T2VPipeline.random_init(preset, make_generator(0), mask_mode=mode,
                                   dtype=torch.float32)


def _text(pipe):
    p = pipe.preset
    return torch.randn((1, p.max_text_len, p.text_dim), generator=make_generator(1))


def _spans(prof, tmp_path):
    """``[(name without "blade.", start, end, thread)]`` of the trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"][len(tracing.PREFIX):], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["tid"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith(tracing.PREFIX)]


def _parent(spans, s):
    around = [o for o in spans if o is not s and o[3] == s[3] and o[1] <= s[1]
              and s[2] <= o[2] and o[2] - o[1] >= s[2] - s[1]]
    return min(around, key=lambda o: o[2] - o[1])[0] if around else None


def _collecting(pipe, kept):
    """The model's ``attention_fn`` with every mask kept (``collect_mask``)."""
    fn = pipe.dit.attention_fn

    def attention_fn(q, k, v, **kw):
        out, mask = fn(q, k, v, **dict(kw, collect_mask=True))
        kept.append((mask, k.shape[2]))
        return out

    pipe.dit.attention_fn = attention_fn


def _density(mask, lk):
    if isinstance(mask, tuple):  # the multilevel lane's (idx, counts) lists
        return mask[1][..., 0].double().mean() / -(-lk // 128)
    return mask.double().mean()


def test_off_spans_are_one_nullcontext_and_nothing_is_counted(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("torch.profiler.record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.active()
    first = tracing.span("dit")
    assert tracing.span("asa") is first and tracing.timed("sample") is first
    assert tracing.recompute(True) is first
    pipe = _pipe("wan")
    pipe.generate(_text(pipe), generator=make_generator(2), num_steps=1)
    tracing.count("asa.calls")
    assert tracing.readback(torch.tensor(2.5)) == 2.5
    assert tracing.counters() == {}


@pytest.mark.parametrize("family", sorted(LANES))
def test_generate_opens_every_span_nested_and_counts_the_masks_density(family, tmp_path):
    pipe = _pipe(family)
    kept = []
    _collecting(pipe, kept)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frames = pipe.generate(_text(pipe), generator=make_generator(2), num_steps=STEPS)
    assert torch.isfinite(frames).all()
    spans = _spans(prof, tmp_path)
    names = [s[0] for s in spans]
    want = set(PARENTS) - {n for f, (_, _, only) in LANES.items() if f != family for n in only}
    assert set(names) == want
    for s in spans:
        assert _parent(spans, s) in PARENTS[s[0]], s
    layers = pipe.preset.dit.num_layers
    assert names.count("sample") == names.count("decode") == 1
    assert names.count("sample.step") == names.count("dit") == STEPS
    assert names.count("dit.block") == names.count("asa") == STEPS * layers

    got = tracing.counters()
    assert got["asa.calls"] == len(kept) == STEPS * layers
    densities = torch.stack([_density(m, lk) for m, lk in kept])
    assert 0.0 < float(densities.mean()) < 1.0
    assert got["asa.blocks_selected"] / got["asa.blocks_total"] == pytest.approx(
        float(densities.mean()), rel=1e-6)
    assert 0.0 < got["sample.seconds"] and 0.0 < got["decode.seconds"]
    assert "host_syncs" not in got and "asa.recomputed_calls" not in got


def test_tdm_step_opens_its_phases_counts_two_readbacks_and_leaves_out_recomputed_asa(
        tmp_path):
    args = T.get_args(["--family", "wan", "--tiny", "--random-init", "--remat",
                       "--output_dir", str(tmp_path), "--batch_size", "1", "--k_step", "2",
                       "--device", "cpu"])
    preset = T.build_preset(args)
    model = T.build_model(args, preset, torch.device("cpu"))
    assert model.remat
    cfg = T.tdm_config(args)
    root = make_generator(args.seed)
    state = tdm.create_tdm_state(fold_generator(root, 1),
                                 {n: p.detach() for n, p in model.named_parameters()}, cfg)
    step = tdm.make_tdm_train_step(T.model_apply_fn(model),
                                   T.diffusion_family(preset, torch.device("cpu")), cfg)
    text = torch.randn((1, preset.max_text_len, preset.text_dim), generator=make_generator(3))
    batch = {"text_embeds": text, "uncond_embeds": torch.zeros_like(text),
             "noise": torch.randn(T.latent_shape(preset, 1), generator=make_generator(4))}
    grads = []  # a model forward's grad mode, one entry each
    model.register_forward_pre_hook(lambda m, a: grads.append(torch.is_grad_enabled()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, batch, root)
    assert metrics["loss_fake"] == metrics["loss_fake"]  # a finite float
    names = {s[0] for s in _spans(prof, tmp_path)}
    assert {"tdm.step", "tdm.rollout", "tdm.merge", "tdm.fake", "tdm.generator",
            "tdm.backward", "tdm.adam", "sync", "dit", "dit.block", "asa"} <= names

    got = tracing.counters()
    layers = preset.dit.num_layers
    assert got["host_syncs"] == 2
    assert got["asa.calls"] == len(grads) * layers
    # the two backwards recompute every block once
    assert sum(grads) == 2 and got["asa.recomputed_calls"] == 2 * layers
    assert 0 < got["asa.blocks_selected"] <= got["asa.blocks_total"]


def test_inference_cli_profile_writes_a_trace_with_the_spans(tmp_path):
    trace = tmp_path / "trace.json"
    tcli.main(["--family", "wan", "--tiny", "--random-init", "--device", "cpu", "--prompt",
               "a cat surfing", "--steps", "1", "--output_dir", str(tmp_path / "out"),
               "--profile", str(trace)])
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"blade.sample", "blade.dit", "blade.asa", "blade.decode"} <= names
    assert not tracing.active()


# -- the per-level multilevel lane's spans and counters --------------------------

PER_LEVEL_COUNTERS = ("asa.per_level_calls", "asa.levels.seconds", "asa.level_merge.seconds")


def _asa_call(lane, monkeypatch):
    """One ASA call over 10 key blocks on ``lane``: "per_level" (the fused
    lane refused, as past 256 key blocks), "fused" or "energy"."""
    from blade_torch.attention import asa as A
    from blade_torch.kernels import multilevel_attn as MA

    if lane == "per_level":
        for mod in (A, MA):
            monkeypatch.setattr(mod, "fused_supported", lambda *a, **kw: False)
    cfg = A.ASAConfig(latent_width=8, latent_height=8, latent_frames=20, pre_arranged=True,
                      mask_mode="energy" if lane == "energy" else "multilevel")
    g = make_generator(5)
    q, k, v = (torch.randn((1, 2, 1280, 64), generator=g) for _ in range(3))
    out, _, mask = A.asa_attention(q, k, v, cfg, generator=make_generator(6), return_mask=True)
    assert torch.isfinite(out).all()
    return mask


def test_a_per_level_call_opens_its_two_spans_inside_sparse_and_counts_once(
        monkeypatch, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mask = _asa_call("per_level", monkeypatch)
    assert mask.dtype == torch.int32  # the per-level lane's int level mask
    spans = _spans(prof, tmp_path)
    names = [s[0] for s in spans]
    assert names.count("asa.levels") == names.count("asa.level_merge") == 1
    for s in spans:
        if s[0] in ("asa.levels", "asa.level_merge"):
            assert _parent(spans, s) == "asa.sparse", s
    got = tracing.counters()
    assert got["asa.per_level_calls"] == 1
    for name in PER_LEVEL_COUNTERS[1:]:
        assert len(tracing._counts[name]) == 1 and got[name] > 0.0


@pytest.mark.parametrize("lane", ["fused", "energy"])
def test_the_other_lanes_count_nothing_of_the_per_level_lane(monkeypatch, tmp_path, lane):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mask = _asa_call(lane, monkeypatch)
    assert isinstance(mask, tuple) == (lane == "fused")  # the fused lane's lists
    names = {s[0] for s in _spans(prof, tmp_path)}
    assert "asa.sparse" in names and not {"asa.levels", "asa.level_merge"} & names
    got = tracing.counters()
    assert got["asa.calls"] == 1 and not set(PER_LEVEL_COUNTERS) & set(got)


def test_a_recomputed_per_level_call_counts_nothing_of_its_lane(monkeypatch, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recompute(True):
            _asa_call("per_level", monkeypatch)
    names = [s[0] for s in _spans(prof, tmp_path)]
    assert names.count("asa.levels") == names.count("asa.level_merge") == 1
    assert tracing.counters() == {"asa.recomputed_calls": 1}


def test_a_per_level_call_with_tracing_off_counts_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("torch.profiler.record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _asa_call("per_level", monkeypatch)
    assert tracing.counters() == {}


# -- the level carry: an int level mask past the fused lane's rule ----------------

def _past_the_rule():
    """q [1, 1, 256, 64] against 32,933 keys (258 key blocks, past the
    fused lane's 256) and a 128-row level mask over them."""
    from blade_torch.attention.masks import multilevel_mask
    from blade_torch.kernels.multilevel_attn import fused_supported

    g = make_generator(7)
    q = torch.randn((1, 1, 256, 64), generator=g)
    k, v = (torch.randn((1, 1, 257 * 128 + 37, 64), generator=g) for _ in range(2))
    assert not fused_supported(64, k.shape[2])
    levels = multilevel_mask(torch.rand((1, 1, 2, 258), generator=g))
    return q, k, v, levels


def test_past_the_fused_rule_a_cpu_call_takes_the_per_level_lane(tmp_path):
    """The level carry runs on the card alone: on the CPU the same call
    opens the per-level lane's spans, counts its call and none of the
    carry's, and gives ``fused=False``'s answer."""
    from blade_torch.kernels.multilevel_attn import multilevel_attention

    q, k, v, levels = _past_the_rule()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, lse = multilevel_attention(q, k, v, levels)
    names = [s[0] for s in _spans(prof, tmp_path)]
    assert names.count("asa.levels") == names.count("asa.level_merge") == 1
    assert "asa.level_lists" not in names
    got = tracing.counters()
    assert got["asa.per_level_calls"] == 1 and "asa.level_carry_calls" not in got
    want = multilevel_attention(q, k, v, levels, fused=False)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])


def test_the_level_carry_opens_its_span_and_counts_once(tmp_path):
    """The carry itself, run here on its plain versions: one
    ``asa.level_lists`` span, one ``asa.level_carry_calls``, nothing of the
    per-level lane, nothing counted where recomputed, and the per-level
    lane's answer (one f32 carry against four merged outputs)."""
    from blade_torch.kernels.multilevel_attn import _level_carry, multilevel_attention

    q, k, v, levels = _past_the_rule()
    scale = 64 ** -0.5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, lse = _level_carry(q, k, v, levels, scale)
        with tracing.recompute(True):
            _level_carry(q, k, v, levels, scale)
    names = [s[0] for s in _spans(prof, tmp_path)]
    assert names.count("asa.level_lists") == 2
    assert not {"asa.levels", "asa.level_merge"} & set(names)
    assert tracing.counters() == {"asa.level_carry_calls": 1}
    want_out, want_lse = multilevel_attention(q, k, v, levels, fused=False)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="128-row level mask"):
        _level_carry(q, k, v, levels[..., :1, :], scale)


# -- Wan's text cross-attention counters --------------------------------------

CROSS_ATTN = ("dit.cross_attn.calls", "dit.cross_attn.recomputed_calls",
              "dit.cross_attn.image_calls")


def _cross_attn_counters():
    return {n: v for n, v in tracing.counters().items() if n in CROSS_ATTN}


@pytest.mark.parametrize("family", sorted(LANES))
def test_generate_counts_one_cross_attention_a_wan_layer_a_forward(family):
    pipe = _pipe(family)
    forwards = []
    pipe.dit.register_forward_pre_hook(lambda m, a: forwards.append(None))
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.generate(_text(pipe), generator=make_generator(2), num_steps=STEPS)
    assert len(forwards) == STEPS
    layers = pipe.preset.dit.num_layers
    want = {"dit.cross_attn.calls": STEPS * layers} if family == "wan" else {}
    assert _cross_attn_counters() == want


@pytest.mark.parametrize("remat", [False, True])
def test_remat_counts_the_recomputed_cross_attentions_alone(remat):
    model = WanModel(WAN_TINY, dtype=torch.float32, remat=remat)
    model.random_init_(make_generator(7))
    g = make_generator(8)
    latents = torch.randn((1, WAN_TINY.in_channels, 2, 8, 8), generator=g)
    text = torch.randn((1, 12, WAN_TINY.text_dim), generator=g)
    with profile(activities=[ProfilerActivity.CPU]):
        model(latents, torch.tensor([500.0]), text).square().mean().backward()
    layers = WAN_TINY.num_layers
    assert all(p.grad is not None for p in model.blocks[0].attn2.parameters())
    want = {"dit.cross_attn.calls": layers}
    if remat:
        want["dit.cross_attn.recomputed_calls"] = layers
    assert _cross_attn_counters() == want


# -- Wan's block glue: the row kernels' route and the expression's ---------------

MODULATE = ("dit.modulate.fused_calls", "dit.modulate.autograd_calls")


def _modulate_counters():
    return {n: v for n, v in tracing.counters().items() if n in MODULATE}


@pytest.mark.parametrize("family", sorted(LANES))
def test_generate_counts_the_glue_kernels_once_a_wan_layer_a_forward(family):
    pipe = _pipe(family)
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.generate(_text(pipe), generator=make_generator(2), num_steps=STEPS)
    layers = pipe.preset.dit.num_layers
    want = {"dit.modulate.fused_calls": STEPS * layers} if family == "wan" else {}
    assert _modulate_counters() == want


@pytest.mark.parametrize("remat", [False, True])
def test_a_gradient_forward_counts_the_expression_and_remat_counts_neither(remat):
    """A no-grad forward takes the row kernels' route in every block; a
    forward autograd records takes the expression in every block; remat's
    recomputation in the backward counts on neither route."""
    model = WanModel(WAN_TINY, dtype=torch.float32, remat=remat)
    model.random_init_(make_generator(7))
    g = make_generator(8)
    latents = torch.randn((1, WAN_TINY.in_channels, 2, 8, 8), generator=g)
    text = torch.randn((1, 12, WAN_TINY.text_dim), generator=g)
    layers = WAN_TINY.num_layers
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            model(latents, torch.tensor([500.0]), text)
    assert _modulate_counters() == {"dit.modulate.fused_calls": layers}
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        model(latents, torch.tensor([500.0]), text).square().mean().backward()
    assert model.blocks[0].scale_shift_table.grad is not None
    assert _modulate_counters() == {"dit.modulate.autograd_calls": layers}


# -- Wan2.1-I2V: the encode and the image branch ------------------------------

I2V_PARENTS = dict(PARENTS, **{"encode": {None}, "encode.chunk": {"encode"},
                               "dit.image_embed": {"dit"},
                               "dit.cross_attn.image": {"dit.cross_attn"}})


def _i2v_inputs(pipe):
    p, g = pipe.preset, make_generator(3)
    image = torch.rand((1, 3, p.video.height, p.video.width), generator=g) * 2 - 1
    embeds = torch.randn((1, p.dit.image_context_tokens, p.dit.image_dim), generator=g)
    return {"image": image, "image_embeds": embeds}


def test_i2v_generate_opens_the_encode_and_image_spans_and_counts_the_branch(tmp_path):
    preset = dataclasses.replace(C.WAN_I2V_TINY_PRESET, video=C.VideoSpec(9, 64, 64, fps=4))
    pipe = T2VPipeline.random_init(preset, make_generator(0), dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frames = pipe.generate(_text(pipe), generator=make_generator(2), num_steps=STEPS,
                               **_i2v_inputs(pipe))
    assert frames.shape == (1, 9, 64, 64, 3) and torch.isfinite(frames).all()
    spans = _spans(prof, tmp_path)
    names = [s[0] for s in spans]
    assert set(names) == set(I2V_PARENTS) - {"decode.tile"}
    for s in spans:
        assert _parent(spans, s) in I2V_PARENTS[s[0]], s
    layers = preset.dit.num_layers
    assert names.count("encode") == 1
    assert names.count("encode.chunk") == 1 + 8 // preset.vae.temporal_factor
    assert names.count("dit.image_embed") == STEPS
    assert names.count("dit.cross_attn.image") == names.count("dit.cross_attn") == STEPS * layers
    got = tracing.counters()
    assert got["dit.cross_attn.image_calls"] == got["dit.cross_attn.calls"] == STEPS * layers
    assert got["encode.seconds"] > 0.0
