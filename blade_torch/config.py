"""Typed presets: model family, video geometry and sparsity settings.

Counterpart of ``blade/config.py``.  The ASA latent geometry is derived from
the video spec.  The text encoder is not ported yet, so a preset names the
encoder's output width (``text_dim``) instead of a T5 config.  The tiny
presets decode with their family's tiny VAE (``WAN21_VAE_TINY``,
``COGVIDEOX_VAE_TINY``); the JAX tiny presets use the generic tiny VAE,
which is not part of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

from blade_torch.attention.asa import ASAConfig
from blade_torch.models.cogvideox_dit import COGVIDEOX_5B, COGVIDEOX_TINY, CogVideoXConfig
from blade_torch.models.vae_cogvideox import (
    COGVIDEOX_VAE_FULL,
    COGVIDEOX_VAE_TINY,
    CogVideoXVAEConfig,
)
from blade_torch.models.vae_wan import WAN21_VAE, WAN21_VAE_TINY, WanVAEConfig
from blade_torch.models.wan_dit import WAN_1_3B, WAN_14B, WAN_TINY, WanConfig

__all__ = ["VideoSpec", "FamilyPreset", "WAN_480P", "WAN_14B_720P", "WAN_TINY_PRESET",
           "COGVIDEOX_480P",
           "COGVIDEOX_TINY_PRESET", "PRESETS", "derive_asa_config", "default_mask_mode"]


@dataclasses.dataclass(frozen=True)
class VideoSpec:
    num_frames: int
    height: int
    width: int
    fps: int


@dataclasses.dataclass(frozen=True)
class FamilyPreset:
    name: str  # "wan" | "cogvideox"
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

    def latent_grid(self) -> Tuple[int, int, int]:
        """(T, H, W) latent token grid: VAE compression x DiT patching."""
        v, vae = self.video, self.vae
        t = (v.num_frames - 1) // vae.temporal_factor + 1
        if self.name == "wan":
            pt, ph, pw = self.dit.patch_size
            return t // pt, v.height // vae.spatial_factor // ph, \
                v.width // vae.spatial_factor // pw
        p = self.dit.patch_size
        return t, v.height // vae.spatial_factor // p, v.width // vae.spatial_factor // p


def default_mask_mode(preset: FamilyPreset) -> str:
    """The reference's serving lane: multilevel for CogVideoX, the binary
    energy lane for Wan."""
    return "multilevel" if preset.name == "cogvideox" else "energy"


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
        mask_mode=mask_mode or default_mask_mode(preset),
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

PRESETS = {
    "wan-1.3b-480p": WAN_480P,
    "wan-14b-720p": WAN_14B_720P,
    "wan-tiny": WAN_TINY_PRESET,
    "cogvideox-5b-480p": COGVIDEOX_480P,
    "cogvideox-tiny": COGVIDEOX_TINY_PRESET,
}
