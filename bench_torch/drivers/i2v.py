"""Image to video: whole clips through ``T2VPipeline.generate`` with a first
frame and its CLIP image features, and ``frames_to_uint8``, one client at
batch 1 (how the port's inference CLI generates with an image-to-video
preset).  ``drivers/t2v.py``'s clips, with these changes:

- each clip's inputs, drawn from the seed: the text embeddings (as
  ``t2v``'s), an RGB image at the preset's size (uniform uint8 levels
  mapped to [-1, 1]: drawn at the target size, so no resize runs) and CLIP
  image features ``[1, image_len, image_dim]`` (N(0, 1) in the served
  dtype);
- ``T2VPipeline.encode_image`` runs inside a ``bench.encode`` span in a
  traced window (the breakdown's device seconds and idle-gap labels), and
  its result, the encoded conditioning, is kept for the clip the check
  compares;
- set-up warms with a one-step clip: it launches every kernel and builds
  every shape of the window's clips (encode, each step's DiT forward,
  decode) in a fraction of a whole clip's time;
- the check (``reference/<family>.py::check_i2v``) also holds the
  program's encoded channels to the reference encoder on the same image;
  the energy lane's threshold, which the reference's ``check_preset``
  cannot read from the program, is held to the configuration's here.

Traffic keys are ``drivers/t2v.py``'s.
"""

from __future__ import annotations

import torch

from bench_torch.drivers import t2v
from bench_torch.harness import seeds

# Streams of a clip's image inputs, mixed into the clip's seed.
IMAGE, FEATURES = 21, 22


class Driver(t2v.Driver):
    def __init__(self, config, *args, **kwargs):
        from blade_torch import config as C

        got = C.derive_asa_config(C.PRESETS[config["preset"]]).energy_threshold
        if got != config["asa"]["energy_threshold"]:
            raise ValueError(f"preset {config['preset']} serves energy threshold {got}, "
                             f"not the configuration's {config['asa']['energy_threshold']}")
        self._condition = self.kept_condition = None
        super().__init__(config, *args, **kwargs)

    def _wire(self):
        super()._wire()
        pipe, spans = self.pipe, self.spans
        encode_image = pipe.encode_image

        def encode(image):
            with spans("encode"):
                self._condition = encode_image(image)
            return self._condition

        pipe.encode_image = encode

    def _image_inputs(self, seed):
        """A clip's first frame ``[1, 3, H, W]`` in [-1, 1] and its CLIP
        features, from the clip's seed."""
        c, dev = self.config, self.device
        v = c["video"]
        g = self._make_generator(seeds.mix(seed, IMAGE), dev)
        levels = torch.randint(0, 256, (1, 3, v["height"], v["width"]), generator=g, device=dev)
        image = levels.float() / 127.5 - 1.0
        g = self._make_generator(seeds.mix(seed, FEATURES), dev)
        feats = torch.randn((1, c["image_len"], c["image_dim"]), generator=g, device=dev)
        return image, feats.to(self.pipe.dtype)

    def _clip(self, stream, index):
        pipe = self.pipe
        self._velocities = []
        text, seed = self._inputs(stream, index)
        image, feats = self._image_inputs(seed)
        frames = pipe.generate(text, generator=self._make_generator(seed, self.device),
                               num_steps=self.steps, mask_refresh_every=self.refresh,
                               image=image, image_embeds=feats)
        u8 = pipe.frames_to_uint8(frames)
        self._sync()
        return u8

    def warm(self):
        steps, self.steps = self.steps, 1
        try:
            super().warm()
        finally:
            self.steps = steps

    def issue(self, i):
        super().issue(i)
        if self.kept[0] == i:
            self.kept_condition = self._condition

    def check(self, check_steps, control=False):
        """Frees the program and returns the gaps of the kept clip to the
        reference (``check_i2v``) at ``check_steps`` sampler steps drawn from
        the seed; with ``control``, the control's too."""
        index, velocities, latents, u8 = self.kept
        condition = self.kept_condition
        steps = sorted(self._rng.sample(range(self.steps), int(check_steps)))
        text, request_seed = self._inputs(seeds.REQUEST, index)
        image, feats = self._image_inputs(request_seed)
        del self.pipe, self._velocities, self._latents, self.kept, self._condition
        self.kept_condition, self.asa = None, []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return self.ref.check_i2v(self.config, self.traffic, weight_seed=self.seed,
                                  request_seed=request_seed, text=text, image=image,
                                  image_embeds=feats, condition=condition,
                                  velocities=velocities, latents=latents, frames=u8,
                                  steps=steps, device=self.device, control=control)
