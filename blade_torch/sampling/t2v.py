"""Text-to-video pipeline: text embeddings -> 8-step DiT -> VAE -> frames.

Counterpart of ``blade/sampling/t2v.py`` for both families: Wan2.1 (8-step
flow UniPC, f32 streaming Wan VAE decode) and CogVideoX (8-step
SDE-DPM++(2M), f32 CogVideoX VAE decode in ``frame_batch=2`` chunks,
spatially tiled at 480p).  The text encoder is not ported yet, so callers
hand in text embeddings ``[B, max_text_len, text_dim]``.  All entry points
run under ``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from blade_torch.config import FamilyPreset, default_mask_mode, derive_asa_config
from blade_torch.models.cogvideox_dit import CogVideoXModel
from blade_torch.models.vae import tiled_decode, uniform_tiling
from blade_torch.models.vae_cogvideox import CogVideoXVAE, chunked_decode
from blade_torch.models.vae_wan import WanVAE, streaming_decode
from blade_torch.models.wan_dit import WanModel
from blade_torch.sampling.pipeline import sample_cogvideox, sample_wan
from blade_torch.schedulers.ddpm import make_ddpm_schedule
from blade_torch.utils import tracing
from blade_torch.utils.rng import fold_generator

__all__ = ["T2VPipeline"]


@dataclasses.dataclass
class T2VPipeline:
    """A DiT + VAE decoder for one preset, on one device."""

    preset: FamilyPreset
    dit: Union[WanModel, CogVideoXModel]
    vae: Union[WanVAE, CogVideoXVAE]
    sparse: bool = True
    mask_mode: str = "energy"

    @classmethod
    def build(cls, preset: FamilyPreset, *, sparse: bool = True,
              mask_mode: Optional[str] = None, dtype=torch.bfloat16,
              device=None) -> "T2VPipeline":
        """Modules with uninitialised weights (load or ``random_init_`` next).
        The DiT computes in ``dtype``; the VAE decodes in f32.  ``mask_mode``
        defaults to the family's serving lane (multilevel for CogVideoX,
        energy for Wan)."""
        mask_mode = mask_mode or default_mask_mode(preset)
        kwargs = {}
        if sparse:
            from blade_torch.attention.integration import asa_model_kwargs

            kwargs = asa_model_kwargs(derive_asa_config(preset, mask_mode))
        if preset.name == "wan":
            dit = WanModel(preset.dit, dtype=dtype, device=device, **kwargs)
            vae = WanVAE(preset.vae, device=device)
        else:
            dit = CogVideoXModel(preset.dit, dtype=dtype, device=device, **kwargs)
            vae = CogVideoXVAE(preset.vae, device=device)
        return cls(preset=preset, dit=dit.eval(), vae=vae.eval(), sparse=sparse,
                   mask_mode=mask_mode)

    @classmethod
    def random_init(cls, preset: FamilyPreset, generator: torch.Generator, *,
                    sparse: bool = True, mask_mode: Optional[str] = None,
                    dtype=torch.bfloat16) -> "T2VPipeline":
        """Random-weight pipeline on ``generator``'s device (smoke runs and
        benchmarks without checkpoints)."""
        pipe = cls.build(preset, sparse=sparse, mask_mode=mask_mode, dtype=dtype,
                         device=generator.device)
        pipe.dit.random_init_(fold_generator(generator, 1))
        pipe.vae.random_init_(fold_generator(generator, 2))
        return pipe

    @property
    def device(self) -> torch.device:
        return self.dit.proj_out.weight.device

    @property
    def dtype(self):
        return self.dit.dtype

    def latent_shape(self, batch: int):
        """Wan ``[B, C, T, H, W]``; CogVideoX ``[B, T, C, H, W]``."""
        p = self.preset
        t, h, w = p.latent_grid()
        if p.name == "wan":
            pt, ph, pw = p.dit.patch_size
            return (batch, p.dit.in_channels, t * pt, h * ph, w * pw)
        ps = p.dit.patch_size
        return (batch, t, p.dit.in_channels, h * ps, w * ps)

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
        with tracing.timed("sample"):
            b = text_embeds.shape[0]
            noise = torch.randn(self.latent_shape(b), generator=fold_generator(generator, 0),
                                device=self.device, dtype=torch.float32).to(self.dtype)
            refresh = mask_refresh_every if self.sparse else 0
            p = self.preset
            if p.name == "wan":
                return sample_wan(self.model_fn(), noise, text_embeds, generator=generator,
                                  num_steps=num_steps, flow_shift=p.flow_shift or 3.0,
                                  mask_refresh_every=refresh)
            return sample_cogvideox(
                self.model_fn(), noise, text_embeds, generator=generator,
                num_steps=num_steps,
                ddpm_schedule=make_ddpm_schedule(
                    snr_shift_scale=p.snr_shift_scale,
                    rescale_betas_zero_snr=p.rescale_betas_zero_snr),
                mask_refresh_every=refresh)

    @torch.inference_mode()
    def decode_latents(self, latents):
        """Model-layout latents -> frames ``[B, T', H', W', 3]`` float in
        [-1, 1], f32.  Wan: streaming decode with conv-state carry.
        CogVideoX (more than 3 latent frames): ``frame_batch=2`` chunks, in
        uniform spatial tiles of at most 20 latent pixels once the frame
        holds 1024 latent pixels or more (JAX's decode path)."""
        with tracing.timed("decode"):
            return self._decode(latents)

    def _decode(self, latents):
        vae_cfg = self.preset.vae
        if self.preset.name == "wan":
            z = latents.permute(0, 2, 3, 4, 1)  # BCTHW -> BTHWC
        else:
            z = latents.permute(0, 1, 3, 4, 2)  # BTCHW -> BTHWC
        z = z.float() / vae_cfg.scaling_factor
        if vae_cfg.latents_mean is not None:
            std = torch.tensor(vae_cfg.latents_std, device=z.device)
            mean = torch.tensor(vae_cfg.latents_mean, device=z.device)
            z = z * std + mean
        if isinstance(self.vae, WanVAE) and z.shape[1] > 2:
            out = streaming_decode(self.vae, z)
        elif isinstance(self.vae, CogVideoXVAE) and z.shape[1] > 3:
            if z.shape[2] * z.shape[3] >= 1024:
                (th, oh), (tw, ow) = uniform_tiling(z.shape[2], 20), uniform_tiling(z.shape[3], 20)
                out = tiled_decode(lambda zz: chunked_decode(self.vae, zz, frame_batch=2), z,
                                   tile_latent=(th, tw), overlap=(oh, ow),
                                   spatial_factor=vae_cfg.spatial_factor)
            else:
                out = chunked_decode(self.vae, z, frame_batch=2)
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
