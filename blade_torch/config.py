"""Typed presets: model family, video geometry and sparsity settings.

Counterpart of ``blade/config.py``.  The ASA latent geometry is derived from
the video spec.  The text encoder is not ported yet, so a preset names the
encoder's output width (``text_dim``) instead of a T5 config.  The tiny
presets decode with their family's tiny VAE (``WAN21_VAE_TINY``,
``COGVIDEOX_VAE_TINY``); the JAX tiny presets use the generic tiny VAE,
which is not part of the port.

What differs between the model families -- their modules, serving lane,
latent layout, VAE decode, the conditioning the DiT reads beside the
latents, sampler, training diffusion and TDM guards -- is decided in one
place: the :class:`Family` record ``FAMILIES[preset.name]``
(``preset.family``).  Wan2.1 image-to-video (``"wan-i2v"``) is Wan's record
with the VAE's encoder, the image conditioning and its own presets.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from blade_torch.attention.asa import ASAConfig
from blade_torch.models.cogvideox_dit import (
    COGVIDEOX_5B,
    COGVIDEOX_TINY,
    CogVideoXConfig,
    CogVideoXModel,
)
from blade_torch.models.vae import tiled_decode, uniform_tiling
from blade_torch.models.vae_cogvideox import (
    COGVIDEOX_VAE_FULL,
    COGVIDEOX_VAE_TINY,
    CogVideoXVAE,
    CogVideoXVAEConfig,
    chunked_decode,
)
from blade_torch.models.vae_wan import (
    WAN21_VAE,
    WAN21_VAE_TINY,
    WanVAE,
    WanVAEConfig,
    streaming_decode,
    streaming_encode,
)
from blade_torch.models.wan_dit import (
    WAN_1_3B,
    WAN_14B,
    WAN_I2V_14B,
    WAN_I2V_TINY,
    WAN_TINY,
    WanConfig,
    WanModel,
)
from blade_torch.sampling.pipeline import SDEDPM, FlowUniPC
from blade_torch.schedulers.ddpm import make_ddpm_schedule
from blade_torch.schedulers.unipc_flow import flow_training_sigmas
from blade_torch.training import tdm

__all__ = ["VideoSpec", "FamilyPreset", "Family", "FAMILIES", "WAN_480P", "WAN_14B_720P",
           "WAN_TINY_PRESET", "WAN_I2V_480P", "WAN_I2V_TINY_PRESET", "COGVIDEOX_480P",
           "COGVIDEOX_TINY_PRESET", "PRESETS", "derive_asa_config"]


@dataclasses.dataclass(frozen=True)
class VideoSpec:
    num_frames: int
    height: int
    width: int
    fps: int


@dataclasses.dataclass(frozen=True)
class FamilyPreset:
    name: str  # "wan" | "wan-i2v" | "cogvideox"
    dit: Union[WanConfig, CogVideoXConfig]
    vae: Union[WanVAEConfig, CogVideoXVAEConfig]
    text_dim: int  # width of the text encoder's output (UMT5-XXL, T5-XXL: 4096)
    max_text_len: int
    video: VideoSpec
    flow_shift: Optional[float] = None  # wan only
    snr_shift_scale: float = 1.0  # cog only
    rescale_betas_zero_snr: bool = True  # cog only
    sample_gap: int = 15
    min_retain_ratio: float = 0.05
    max_retain_ratio: float = 0.1
    joint_text_attention: bool = False  # cog: text takes part in self-attention
    # ASA mask predictor and its sampled tokens per 128-token block: "sum"
    # with 16 serves (cheaper, near-identical masks); the reference's own is
    # "max" with 32.
    asa_predictor: str = "sum"
    asa_sample_tokens: int = 16
    # Query rows per multilevel mask row.
    asa_multilevel_q_rows: int = 128
    asa_mask_ratios: Optional[Dict[int, Tuple[float, float]]] = None

    @property
    def family(self) -> "Family":
        """This preset's family record, ``FAMILIES[self.name]``."""
        return FAMILIES[self.name]

    def latent_grid(self) -> Tuple[int, int, int]:
        """(T, H, W) latent token grid: VAE compression x DiT patching."""
        v, vae = self.video, self.vae
        pt, ph, pw = self.family.patch(self.dit)
        t = (v.num_frames - 1) // vae.temporal_factor + 1
        return t // pt, v.height // vae.spatial_factor // ph, v.width // vae.spatial_factor // pw


def derive_asa_config(preset: FamilyPreset, mask_mode: Optional[str] = None) -> ASAConfig:
    """The ASA geometry and lane of a preset's latent token grid."""
    t, h, w = preset.latent_grid()
    return ASAConfig(
        latent_width=w, latent_height=h, latent_frames=t,
        text_length=preset.max_text_len if preset.joint_text_attention else 0,
        sample_gap=preset.sample_gap,
        min_retain_ratio=preset.min_retain_ratio,
        max_retain_ratio=preset.max_retain_ratio,
        predictor=preset.asa_predictor,
        sample_tokens_per_block=preset.asa_sample_tokens,
        mask_mode=mask_mode or preset.family.mask_mode,
        mask_ratios=preset.asa_mask_ratios,
        multilevel_q_rows=preset.asa_multilevel_q_rows,
    )


WAN_480P = FamilyPreset(
    name="wan", dit=WAN_1_3B, vae=WAN21_VAE, text_dim=4096, max_text_len=512,
    video=VideoSpec(81, 480, 832, fps=16), flow_shift=3.0,
    sample_gap=30, max_retain_ratio=0.2, asa_multilevel_q_rows=256,
)
# Wan2.1-T2V-14B at its native 720p: 81 frames of 720x1280 -> 21x45x80
# latents = 75 600 tokens in 591 key blocks, past the fused multilevel
# lane's 256, so ``--mask_mode multilevel`` runs the per-level lane; flow
# shift 5.0 is the diffusers recommendation for 720p.  Its 14.3 B weights
# take 28.6 GB in bf16 and fit one 80 GB H100.
WAN_14B_720P = FamilyPreset(
    name="wan", dit=WAN_14B, vae=WAN21_VAE, text_dim=4096, max_text_len=512,
    video=VideoSpec(81, 720, 1280, fps=16), flow_shift=5.0,
    sample_gap=30, max_retain_ratio=0.2, asa_multilevel_q_rows=128,
)
# CogVideoX-5B: 49 frames 480x720 -> 13x30x45 latents (17 550 video tokens)
# + 226 T5 tokens.
COGVIDEOX_480P = FamilyPreset(
    name="cogvideox", dit=COGVIDEOX_5B, vae=COGVIDEOX_VAE_FULL, text_dim=4096,
    max_text_len=226, video=VideoSpec(49, 480, 720, fps=8),
    sample_gap=15, max_retain_ratio=0.1, joint_text_attention=True,
    asa_multilevel_q_rows=256,
)
# Wan2.1-I2V-14B at its 480P checkpoint's size: 81 frames of 480x832 ->
# 21x30x52 latents = 32 760 tokens on the energy lane as WAN_480P sets it;
# the DiT reads 36 channels and 257 CLIP image tokens.
WAN_I2V_480P = dataclasses.replace(WAN_480P, name="wan-i2v", dit=WAN_I2V_14B)
# CPU-testable end-to-end presets.
WAN_TINY_PRESET = FamilyPreset(
    name="wan", dit=WAN_TINY, vae=WAN21_VAE_TINY, text_dim=WAN_TINY.text_dim,
    max_text_len=16, video=VideoSpec(5, 32, 32, fps=4), flow_shift=3.0,
    sample_gap=4, max_retain_ratio=1.0, min_retain_ratio=0.25,
)
COGVIDEOX_TINY_PRESET = FamilyPreset(
    name="cogvideox", dit=COGVIDEOX_TINY, vae=COGVIDEOX_VAE_TINY,
    text_dim=COGVIDEOX_TINY.text_embed_dim, max_text_len=16,
    video=VideoSpec(5, 32, 32, fps=4), sample_gap=4, max_retain_ratio=1.0,
    min_retain_ratio=0.25, joint_text_attention=True,
)

WAN_I2V_TINY_PRESET = dataclasses.replace(WAN_TINY_PRESET, name="wan-i2v", dit=WAN_I2V_TINY)

PRESETS = {
    "wan-1.3b-480p": WAN_480P,
    "wan-14b-720p": WAN_14B_720P,
    "wan-i2v-14b-480p": WAN_I2V_480P,
    "wan-tiny": WAN_TINY_PRESET,
    "wan-i2v-tiny": WAN_I2V_TINY_PRESET,
    "cogvideox-5b-480p": COGVIDEOX_480P,
    "cogvideox-tiny": COGVIDEOX_TINY_PRESET,
}


@dataclasses.dataclass(frozen=True)
class Family:
    """What differs between the model families: one record a family, in
    :data:`FAMILIES`.  Adding a family means adding a record."""

    dit_class: type  # WanModel | CogVideoXModel
    vae_class: Callable  # WanVAE (with its encoder for "wan-i2v") | CogVideoXVAE
    mask_mode: str  # the reference's serving lane
    patch: Callable  # DiT config -> (pt, ph, pw), its patch in latent pixels
    # of the model-layout latents: Wan [B, C, T, H, W], CogVideoX [B, T, C, H, W]
    channel_axis: int
    decode: Callable  # (vae, z [B, T, H, W, C]) -> frames, f32
    solver: Callable  # (preset, num_steps) -> the sampler's solver
    diffusion: Callable  # (preset, device) -> the TDM trainer's diffusion family
    use_weighting_factor: bool  # of the TDM generator loss
    fake_loss_skip_threshold: Optional[float]  # TDM's fake-loss guard
    full: FamilyPreset  # the presets ``--family`` names, without and with ``--tiny``
    tiny: FamilyPreset
    # (vae, preset, image [B, 3, H, W] in [-1, 1]) -> the model-layout
    # channels the DiT reads beside the latents at every step; None: the
    # family generates from text alone.
    condition: Optional[Callable] = None

    def latent_shape(self, preset: FamilyPreset, batch: int) -> Tuple[int, ...]:
        """Model-layout latents of ``batch`` clips."""
        pt, ph, pw = self.patch(preset.dit)
        t, h, w = preset.latent_grid()
        shape = [t * pt, h * ph, w * pw]
        shape.insert(self.channel_axis - 1, preset.dit.out_channels)
        return (batch, *shape)

    def to_bthwc(self, latents):
        """Model-layout latents -> the VAE's ``[B, T, H, W, C]``."""
        axes = [a for a in range(latents.dim()) if a != self.channel_axis]
        return latents.permute(*axes, self.channel_axis)


def _wan_decode(vae, z):
    """Streaming decode with the conv state carried, past 2 latent frames."""
    return streaming_decode(vae, z) if z.shape[1] > 2 else vae.decode(z)


def _cogvideox_decode(vae, z):
    """Past 3 latent frames, ``frame_batch=2`` chunks, in uniform spatial
    tiles of at most 20 latent pixels once the frame holds 1024 latent pixels
    or more (JAX's decode path)."""
    if z.shape[1] <= 3:
        return vae.decode(z)

    def chunked(zz):
        return chunked_decode(vae, zz, frame_batch=2)

    if z.shape[2] * z.shape[3] < 1024:
        return chunked(z)
    (th, oh), (tw, ow) = uniform_tiling(z.shape[2], 20), uniform_tiling(z.shape[3], 20)
    return tiled_decode(chunked, z, tile_latent=(th, tw), overlap=(oh, ow),
                        spatial_factor=vae.cfg.spatial_factor)


def _wan_i2v_condition(vae, preset: FamilyPreset, image):
    """Wan2.1-I2V's conditioning ``[B, 4 + z, T', H', W']``: the image as
    frame 0 of a clip of ``num_frames`` (the rest zeros) through the
    streaming encode, normalised by the latent statistics, behind a mask
    that is one on the first latent frame (the image's) and zero on the
    rest, of the channels the DiT reads past the latents and the encoding
    (Wan2.1: 4, its VAE's temporal factor)."""
    b, _, h, w = image.shape
    video = image.float()[:, None].permute(0, 1, 3, 4, 2)  # [B, 1, H, W, 3]
    video = torch.cat([video, video.new_zeros((b, preset.video.num_frames - 1, h, w, 3))], 1)
    cond = vae.normalize(streaming_encode(vae, video)).permute(0, 4, 1, 2, 3)
    width = preset.dit.in_channels - preset.dit.out_channels - cond.shape[1]
    mask = torch.zeros((b, width) + cond.shape[2:], device=cond.device, dtype=cond.dtype)
    mask[:, :, 0] = 1.0
    return torch.cat([mask, cond], dim=1)


def _ddpm_schedule(preset: FamilyPreset):
    return make_ddpm_schedule(snr_shift_scale=preset.snr_shift_scale,
                              rescale_betas_zero_snr=preset.rescale_betas_zero_snr)


FAMILIES = {
    # 8-step flow UniPC; trains on flow matching with the fake-loss skip guard.
    "wan": Family(
        dit_class=WanModel, vae_class=WanVAE, mask_mode="energy",
        patch=lambda dit: dit.patch_size, channel_axis=1, decode=_wan_decode,
        solver=lambda p, n: FlowUniPC(n, flow_shift=p.flow_shift),
        diffusion=lambda p, device: tdm.flow_family(
            flow_training_sigmas(1000, p.flow_shift), device=device),
        use_weighting_factor=False, fake_loss_skip_threshold=2.0,
        full=WAN_480P, tiny=WAN_TINY_PRESET),
    # 8-step SDE-DPM++(2M); trains on DDPM v-prediction with the generator
    # loss's weighting factor.
    "cogvideox": Family(
        dit_class=CogVideoXModel, vae_class=CogVideoXVAE, mask_mode="multilevel",
        patch=lambda dit: (1, dit.patch_size, dit.patch_size), channel_axis=2,
        decode=_cogvideox_decode,
        solver=lambda p, n: SDEDPM(n, _ddpm_schedule(p)),
        diffusion=lambda p, device: tdm.ddpm_family(_ddpm_schedule(p), device=device),
        use_weighting_factor=True, fake_loss_skip_threshold=None,
        full=COGVIDEOX_480P, tiny=COGVIDEOX_TINY_PRESET),
}
# Wan's record with the VAE's encoder and the image conditioning.
FAMILIES["wan-i2v"] = dataclasses.replace(
    FAMILIES["wan"], vae_class=functools.partial(WanVAE, encoder=True),
    condition=_wan_i2v_condition, full=WAN_I2V_480P, tiny=WAN_I2V_TINY_PRESET)
