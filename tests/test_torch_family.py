"""The family records of ``blade_torch.config``, on the CPU.

Each preset's ``Family`` answers what the pipeline, the sampler and the
trainer ask of it: the model-layout latent shape, the serving lane, the DiT
and VAE classes, the TDM guards and the solver's schedule.  The values are
pinned, the schedules to the scheduler modules' own tables; the CLI helpers
that the training benchmark calls give the same answers.
"""

import numpy as np
import pytest

from blade_torch import config as C
from blade_torch.cli import train as T
from blade_torch.models.cogvideox_dit import CogVideoXModel
from blade_torch.models.vae_cogvideox import CogVideoXVAE
from blade_torch.models.vae_wan import WanVAE
from blade_torch.models.wan_dit import WanModel
from blade_torch.schedulers.cogvideox_dpm import make_dpm_schedule
from blade_torch.schedulers.ddpm import make_ddpm_schedule
from blade_torch.schedulers.unipc_flow import make_flow_unipc_schedule

WAN = dict(lane="energy", dit=WanModel, vae=WanVAE, weighting=False, skip=2.0)
COG = dict(lane="multilevel", dit=CogVideoXModel, vae=CogVideoXVAE, weighting=True, skip=None)


@pytest.mark.parametrize("name, shape, want", [
    ("wan-1.3b-480p", (1, 16, 21, 60, 104), dict(WAN, flow_shift=3.0)),
    ("wan-14b-720p", (1, 16, 21, 90, 160), dict(WAN, flow_shift=5.0)),
    ("wan-tiny", (1, 16, 3, 16, 16), dict(WAN, flow_shift=3.0)),
    ("cogvideox-5b-480p", (1, 13, 16, 60, 90), COG),
    ("cogvideox-tiny", (1, 3, 16, 16, 16), COG),
])
def test_family_record_answers(name, shape, want):
    preset = C.PRESETS[name]
    family = preset.family
    assert family is C.FAMILIES[preset.name]
    assert family.latent_shape(preset, 1) == T.latent_shape(preset, 1) == shape
    assert shape[family.channel_axis] == preset.dit.in_channels == preset.dit.out_channels
    assert family.mask_mode == C.derive_asa_config(preset).mask_mode == want["lane"]
    assert (family.dit_class, family.vae_class) == (want["dit"], want["vae"])
    cfg = T.tdm_config(T.get_args(["--family", preset.name, "--output_dir", "unused"]))
    assert family.use_weighting_factor is cfg.use_weighting_factor is want["weighting"]
    assert family.fake_loss_skip_threshold == cfg.fake_loss_skip_threshold == want["skip"]
    sched = family.solver(preset, 8).sched
    if "flow_shift" in want:
        ref = make_flow_unipc_schedule(8, flow_shift=want["flow_shift"])
        np.testing.assert_array_equal(sched.sigmas, ref.sigmas)
    else:
        ref = make_dpm_schedule(make_ddpm_schedule(snr_shift_scale=1.0,
                                                   rescale_betas_zero_snr=True), 8)
        np.testing.assert_array_equal(sched.alpha, ref.alpha)
    np.testing.assert_array_equal(sched.timesteps, ref.timesteps)
    assert sched.num_steps == 8


@pytest.mark.parametrize("family, tiny, name", [
    ("wan", False, "wan-1.3b-480p"), ("wan", True, "wan-tiny"),
    ("cogvideox", False, "cogvideox-5b-480p"), ("cogvideox", True, "cogvideox-tiny"),
])
def test_family_flags_name_the_default_presets(family, tiny, name):
    argv = ["--family", family, "--output_dir", "unused"] + ["--tiny"] * tiny
    assert T.build_preset(T.get_args(argv)) is C.PRESETS[name]
