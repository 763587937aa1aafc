"""Typed presets: model family, video geometry and sparsity settings.

Counterpart of ``blade/config.py`` (Wan half).  The ASA latent geometry is
derived from the video spec.  The text encoder is not ported yet, so a
preset names the encoder's output width (``text_dim``) instead of a T5
config; ``WAN_TINY_PRESET`` uses ``WAN21_VAE_TINY`` (the JAX tiny preset
uses the generic tiny VAE, which is not part of this slice).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from blade_torch.attention.asa import ASAConfig
from blade_torch.models.vae_wan import WAN21_VAE, WAN21_VAE_TINY, WanVAEConfig
from blade_torch.models.wan_dit import WAN_1_3B, WAN_TINY, WanConfig

__all__ = ["VideoSpec", "FamilyPreset", "WAN_480P", "WAN_TINY_PRESET", "PRESETS",
           "derive_asa_config"]


@dataclasses.dataclass(frozen=True)
class VideoSpec:
    num_frames: int
    height: int
    width: int
    fps: int


@dataclasses.dataclass(frozen=True)
class FamilyPreset:
    name: str  # "wan"
    dit: WanConfig
    vae: WanVAEConfig
    text_dim: int  # width of the text encoder's output (UMT5-XXL: 4096)
    max_text_len: int
    video: VideoSpec
    flow_shift: Optional[float] = None
    sample_gap: int = 15
    min_retain_ratio: float = 0.05
    max_retain_ratio: float = 0.1
    # ASA "sum" predictor with 16 sampled tokens per block (reference parity
    # would be the "max" predictor with 32, not ported yet).
    asa_sample_tokens: int = 16

    def latent_grid(self) -> Tuple[int, int, int]:
        """(T, H, W) latent token grid: VAE compression x DiT patching."""
        v, vae = self.video, self.vae
        pt, ph, pw = self.dit.patch_size
        t = ((v.num_frames - 1) // vae.temporal_factor + 1) // pt
        h = v.height // vae.spatial_factor // ph
        w = v.width // vae.spatial_factor // pw
        return t, h, w


def derive_asa_config(preset: FamilyPreset) -> ASAConfig:
    """The energy-lane ASA geometry of a preset's latent token grid."""
    t, h, w = preset.latent_grid()
    return ASAConfig(
        latent_width=w, latent_height=h, latent_frames=t,
        sample_gap=preset.sample_gap,
        min_retain_ratio=preset.min_retain_ratio,
        max_retain_ratio=preset.max_retain_ratio,
        sample_tokens_per_block=preset.asa_sample_tokens,
    )


WAN_480P = FamilyPreset(
    name="wan", dit=WAN_1_3B, vae=WAN21_VAE, text_dim=4096, max_text_len=512,
    video=VideoSpec(81, 480, 832, fps=16), flow_shift=3.0,
    sample_gap=30, max_retain_ratio=0.2,
)
# CPU-testable end-to-end preset.
WAN_TINY_PRESET = FamilyPreset(
    name="wan", dit=WAN_TINY, vae=WAN21_VAE_TINY, text_dim=WAN_TINY.text_dim,
    max_text_len=16, video=VideoSpec(5, 32, 32, fps=4), flow_shift=3.0,
    sample_gap=4, max_retain_ratio=1.0, min_retain_ratio=0.25,
)

PRESETS = {
    "wan-1.3b-480p": WAN_480P,
    "wan-tiny": WAN_TINY_PRESET,
}
