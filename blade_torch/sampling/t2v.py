"""Text-to-video pipeline (Wan half): text embeddings -> 8-step DiT -> VAE
-> frames.

Counterpart of ``blade/sampling/t2v.py``.  The text encoder is not ported
yet, so callers hand in text embeddings ``[B, max_text_len, text_dim]``.
All entry points run under ``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses

import torch

from blade_torch.config import FamilyPreset, derive_asa_config
from blade_torch.models.vae_wan import WanVAE, streaming_decode
from blade_torch.models.wan_dit import WanModel
from blade_torch.sampling.pipeline import sample_wan
from blade_torch.utils.rng import fold_generator

__all__ = ["T2VPipeline"]


@dataclasses.dataclass
class T2VPipeline:
    """A Wan DiT + VAE decoder for one preset, on one device."""

    preset: FamilyPreset
    dit: WanModel
    vae: WanVAE
    sparse: bool = True

    @classmethod
    def build(cls, preset: FamilyPreset, *, sparse: bool = True, dtype=torch.bfloat16,
              device=None) -> "T2VPipeline":
        """Modules with uninitialised weights (load or ``random_init_`` next).
        The DiT computes in ``dtype``; the VAE decodes in f32."""
        kwargs = {}
        if sparse:
            from blade_torch.attention.integration import asa_model_kwargs

            kwargs = asa_model_kwargs(derive_asa_config(preset))
        dit = WanModel(preset.dit, dtype=dtype, device=device, **kwargs)
        vae = WanVAE(preset.vae, device=device)
        return cls(preset=preset, dit=dit.eval(), vae=vae.eval(), sparse=sparse)

    @classmethod
    def random_init(cls, preset: FamilyPreset, generator: torch.Generator, *,
                    sparse: bool = True, dtype=torch.bfloat16) -> "T2VPipeline":
        """Random-weight pipeline on ``generator``'s device (smoke runs and
        benchmarks without checkpoints)."""
        pipe = cls.build(preset, sparse=sparse, dtype=dtype, device=generator.device)
        pipe.dit.random_init_(fold_generator(generator, 1))
        pipe.vae.random_init_(fold_generator(generator, 2))
        return pipe

    @property
    def device(self) -> torch.device:
        return self.dit.scale_shift_table.device

    @property
    def dtype(self):
        return self.dit.dtype

    def latent_shape(self, batch: int):
        p = self.preset
        t, h, w = p.latent_grid()
        pt, ph, pw = p.dit.patch_size
        return (batch, p.dit.in_channels, t * pt, h * ph, w * pw)

    def model_fn(self):
        def fn(latents, timestep, text_embeds, generator, masks=None,
               collect_mask=False):
            attn_kwargs = {"generator": generator}
            if masks is not None:
                attn_kwargs["masks"] = masks
            if collect_mask:
                attn_kwargs["collect_mask"] = True
            return self.dit(latents, timestep, text_embeds, attn_kwargs=attn_kwargs)

        return fn

    @torch.inference_mode()
    def sample_latents(self, text_embeds, *, generator: torch.Generator,
                       num_steps: int = 8, mask_refresh_every: int = 0):
        b = text_embeds.shape[0]
        noise = torch.randn(self.latent_shape(b), generator=fold_generator(generator, 0),
                            device=self.device, dtype=torch.float32).to(self.dtype)
        return sample_wan(
            self.model_fn(), noise, text_embeds, generator=generator,
            num_steps=num_steps, flow_shift=self.preset.flow_shift or 3.0,
            mask_refresh_every=mask_refresh_every if self.sparse else 0,
        )

    @torch.inference_mode()
    def decode_latents(self, latents):
        """Model-layout latents ``[B, C, T, H, W]`` -> frames ``[B, T', H', W',
        3]`` float in [-1, 1] (f32 streaming decode with conv-state carry)."""
        vae_cfg = self.preset.vae
        z = latents.permute(0, 2, 3, 4, 1).float() / vae_cfg.scaling_factor
        if vae_cfg.latents_mean is not None:
            std = torch.tensor(vae_cfg.latents_std, device=z.device)
            mean = torch.tensor(vae_cfg.latents_mean, device=z.device)
            z = z * std + mean
        if z.shape[1] > 2:
            out = streaming_decode(self.vae, z)
        else:
            out = self.vae.decode(z)
        return out.clamp(-1.0, 1.0)

    @staticmethod
    def frames_to_uint8(frames: torch.Tensor) -> torch.Tensor:
        """[-1, 1] float frames -> uint8 on the frames' device."""
        return ((frames.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)

    def generate(self, text_embeds, *, generator: torch.Generator, num_steps: int = 8,
                 mask_refresh_every: int = 0):
        """Text embeddings -> frames ``[B, T, H, W, 3]`` in [-1, 1] (CFG 1,
        the distilled sampler's setting)."""
        latents = self.sample_latents(text_embeds, generator=generator, num_steps=num_steps,
                                      mask_refresh_every=mask_refresh_every)
        return self.decode_latents(latents)
