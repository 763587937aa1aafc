"""Video pipeline: text embeddings -> 8-step DiT -> VAE -> frames, and for
an image-to-video family image -> VAE encode -> conditioned DiT -> frames.

Counterpart of ``blade/sampling/t2v.py`` for the families: Wan2.1 (8-step
flow UniPC, f32 streaming Wan VAE decode), Wan2.1-I2V (the same, the image
encoded by the f32 streaming Wan VAE encode into the channels every step
reads, CLIP image features beside the text) and CogVideoX (8-step
SDE-DPM++(2M), f32 CogVideoX VAE decode in ``frame_batch=2`` chunks,
spatially tiled at 480p).  The text and image encoders are not ported yet,
so callers hand in text embeddings ``[B, max_text_len, text_dim]`` (and
CLIP image features ``[B, image_context_tokens, image_dim]``).  All entry
points run under ``torch.inference_mode``.  What differs by family comes
from the preset's ``Family`` record (``blade_torch.config``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from blade_torch.config import FamilyPreset, derive_asa_config
from blade_torch.sampling.pipeline import sample
from blade_torch.utils import tracing
from blade_torch.utils.rng import fold_generator

__all__ = ["T2VPipeline"]


@dataclasses.dataclass
class T2VPipeline:
    """A DiT + VAE decoder for one preset, on one device."""

    preset: FamilyPreset
    dit: torch.nn.Module  # the family's DiT and VAE classes
    vae: torch.nn.Module
    sparse: bool = True
    mask_mode: str = "energy"

    @classmethod
    def build(cls, preset: FamilyPreset, *, sparse: bool = True,
              mask_mode: Optional[str] = None, dtype=torch.bfloat16,
              device=None) -> "T2VPipeline":
        """Modules with uninitialised weights (load or ``random_init_`` next).
        The DiT computes in ``dtype``; the VAE runs in f32.  ``mask_mode``
        defaults to the family's serving lane (multilevel for CogVideoX,
        energy for Wan)."""
        family = preset.family
        mask_mode = mask_mode or family.mask_mode
        kwargs = {}
        if sparse:
            from blade_torch.attention.integration import asa_model_kwargs

            kwargs = asa_model_kwargs(derive_asa_config(preset, mask_mode))
        dit = family.dit_class(preset.dit, dtype=dtype, device=device, **kwargs)
        vae = family.vae_class(preset.vae, device=device)
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
        return self.preset.family.latent_shape(self.preset, batch)

    def model_fn(self, **conditioning):
        """The sampler's ``model_fn``, ``conditioning`` (an image-to-video
        family's ``condition`` and ``image_embeds``) bound into every
        forward."""
        def fn(latents, timestep, text_embeds, generator, masks=None,
               collect_mask=False):
            attn_kwargs = {"generator": generator}
            if masks is not None:
                attn_kwargs["masks"] = masks
            if collect_mask:
                attn_kwargs["collect_mask"] = True
            return self.dit(latents, timestep, text_embeds, attn_kwargs=attn_kwargs,
                            **conditioning)

        return fn

    @torch.inference_mode()
    def sample_latents(self, text_embeds, *, generator: torch.Generator,
                       num_steps: int = 8, mask_refresh_every: int = 0, **conditioning):
        """Noise drawn from ``generator`` -> clean latents; ``conditioning``
        goes to every DiT forward (:meth:`model_fn`)."""
        with tracing.timed("sample"):
            b = text_embeds.shape[0]
            noise = torch.randn(self.latent_shape(b), generator=fold_generator(generator, 0),
                                device=self.device, dtype=torch.float32).to(self.dtype)
            refresh = mask_refresh_every if self.sparse else 0
            solver = self.preset.family.solver(self.preset, num_steps)
            return sample(self.model_fn(**conditioning), solver, noise, text_embeds,
                          generator=generator, mask_refresh_every=refresh)

    @torch.inference_mode()
    def encode_image(self, image):
        """Image ``[B, 3, H, W]`` in [-1, 1] at the preset's size -> the
        channels the DiT reads beside the latents (``Family.condition``:
        Wan2.1-I2V's mask and streaming f32 encode), f32."""
        with tracing.timed("encode"):
            return self.preset.family.condition(self.vae, self.preset, image)

    @torch.inference_mode()
    def decode_latents(self, latents):
        """Model-layout latents -> frames ``[B, T', H', W', 3]`` float in
        [-1, 1], f32, by the family's decode (``Family.decode``)."""
        with tracing.timed("decode"):
            return self._decode(latents)

    def _decode(self, latents):
        family, vae_cfg = self.preset.family, self.preset.vae
        z = family.to_bthwc(latents).float() / vae_cfg.scaling_factor
        if vae_cfg.latents_mean is not None:
            std = torch.tensor(vae_cfg.latents_std, device=z.device)
            mean = torch.tensor(vae_cfg.latents_mean, device=z.device)
            z = z * std + mean
        return family.decode(self.vae, z).clamp(-1.0, 1.0)

    @staticmethod
    def frames_to_uint8(frames: torch.Tensor) -> torch.Tensor:
        """[-1, 1] float frames -> uint8 on the frames' device."""
        return ((frames.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)

    def generate(self, text_embeds, *, generator: torch.Generator, num_steps: int = 8,
                 mask_refresh_every: int = 0, image=None, image_embeds=None):
        """Text embeddings -> frames ``[B, T, H, W, 3]`` in [-1, 1] (CFG 1,
        the distilled sampler's setting).  An image-to-video family also
        takes the first frame ``image [B, 3, H, W]`` in [-1, 1] and its CLIP
        features ``image_embeds``: encode, sample under that conditioning,
        decode."""
        conditioning = {}
        if self.preset.family.condition is not None:
            if image is None or image_embeds is None:
                raise ValueError(f"preset family {self.preset.name!r} needs image and "
                                 "image_embeds")
            conditioning = {"condition": self.encode_image(image),
                            "image_embeds": image_embeds}
        latents = self.sample_latents(text_embeds, generator=generator, num_steps=num_steps,
                                      mask_refresh_every=mask_refresh_every, **conditioning)
        return self.decode_latents(latents)
