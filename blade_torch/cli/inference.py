"""Video inference CLI: text to video (Wan, CogVideoX) and image to video
(Wan2.1-I2V) (counterpart of ``blade/cli/inference.py``).

The text and image encoders and checkpoint loading are not ported yet, so
the CLI runs random weights (``--random-init``) with random text embeddings
drawn per prompt from a seed derived from the prompt text.  An
image-to-video preset reads its first frame from ``--image`` (a PNG,
resized to the preset's size where it differs) or, with none,
draws it from ``--seed``; its CLIP image features are always drawn from
``--seed``.

Examples:
  python -m blade_torch.cli.inference --preset wan-1.3b-480p --random-init \\
      --prompt "a cat surfing" --steps 8 --output_dir outputs/
  python -m blade_torch.cli.inference --preset cogvideox-5b-480p --random-init \\
      --prompt "a cat surfing" --steps 8 --output_dir outputs/
  python -m blade_torch.cli.inference --preset wan-14b-720p --mask_mode multilevel \\
      --random-init --prompt "a cat surfing" --steps 8 --output_dir outputs/
  python -m blade_torch.cli.inference --preset wan-i2v-14b-480p --random-init \\
      --image first_frame.png --prompt "a cat surfing" --steps 8 --output_dir outputs/
  python -m blade_torch.cli.inference --family cogvideox --tiny --random-init \\
      --device cpu --prompt "a cat surfing" --steps 2

``--profile PATH`` runs the generation under ``torch.profiler`` with the
port's tracing on (``blade_torch.utils.tracing``: the ``blade.*`` spans of
the sampler, DiT, ASA and VAE) and writes the Chrome trace to ``PATH``
(open it in Perfetto or ``chrome://tracing``; ``python -m
bench_torch.harness.program_trace PATH`` reduces it to device seconds by
span and the idle gaps).  Profile a second prompt to see a warm clip: the
first call builds the kernels.
"""

from __future__ import annotations

import argparse
import os
import zlib

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description="BLADE PyTorch inference")
    p.add_argument("--family", choices=["wan", "cogvideox"], default="wan")
    p.add_argument("--prompts", type=str, help="text file, one prompt per line")
    p.add_argument("--prompt", type=str, help="single prompt")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--seed", type=int, default=8888)
    p.add_argument("--sparse", action="store_true", default=True)
    p.add_argument("--dense", dest="sparse", action="store_false")
    p.add_argument("--mask_mode", choices=["energy", "multilevel"], default=None,
                   help="ASA lane; default: multilevel for cogvideox (the reference "
                        "eval path), energy for wan")
    p.add_argument("--mask_refresh_every", type=int, default=0,
                   help="reuse ASA masks across denoise steps, re-predicting "
                        "every N steps (0/1 = off)")
    p.add_argument("--random-init", action="store_true",
                   help="random weights (smoke/benchmark)")
    p.add_argument("--tiny", action="store_true", help="tiny CPU preset")
    p.add_argument("--preset", type=str, default=None,
                   help="named preset (overrides --family/--tiny): wan-1.3b-480p, "
                        "wan-14b-720p, wan-i2v-14b-480p, cogvideox-5b-480p, wan-tiny, "
                        "wan-i2v-tiny, cogvideox-tiny")
    p.add_argument("--image", type=str, default=None, metavar="PATH",
                   help="first frame of an image-to-video preset (PNG); "
                        "default: drawn from --seed")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--profile", type=str, default=None, metavar="PATH",
                   help="run under torch.profiler with the port's spans on and write "
                        "the Chrome trace to PATH")
    return p.parse_args(argv)


def build_pipeline(args, preset=None):
    """The random-weight pipeline for ``args``: weights drawn from a
    generator seeded with 0 (as the JAX CLI's ``PRNGKey(0)``), on
    ``--device``; f32 for the tiny preset, bf16 otherwise.  ``preset``, a
    ``FamilyPreset``, replaces the one ``args`` name (e.g. a stock preset
    with the reference-parity ``asa_predictor="max"``)."""
    from blade_torch import config as C
    from blade_torch.sampling.t2v import T2VPipeline
    from blade_torch.utils.rng import make_generator

    if preset is None and args.preset:
        preset = C.PRESETS[args.preset]
    elif preset is None:
        family = C.FAMILIES[args.family]
        preset = family.tiny if args.tiny else family.full
    if not args.random_init:
        raise SystemExit("checkpoint loading is not ported yet: pass --random-init")
    device = torch.device(args.device or "cuda")
    return T2VPipeline.random_init(
        preset, make_generator(0, device), sparse=args.sparse, mask_mode=args.mask_mode,
        dtype=torch.float32 if args.tiny else torch.bfloat16)


def random_text_embeds(pipe, prompt: str) -> torch.Tensor:
    """Stand-in for the random-init text encoder: embeddings
    ``[1, max_text_len, text_dim]`` drawn from a seed derived from the
    prompt (crc32, stable across processes)."""
    p = pipe.preset
    rng = np.random.default_rng(zlib.crc32(prompt.encode()))
    e = rng.standard_normal((1, p.max_text_len, p.text_dim)).astype(np.float32)
    return torch.from_numpy(e).to(pipe.device, pipe.dtype)


def image_inputs(pipe, path, seed: int):
    """An image-to-video preset's first frame ``[1, 3, H, W]`` in [-1, 1]
    (``path`` read and resized bicubically to the preset's size where it
    differs, or, with no path, uniform draws from ``seed``) and its CLIP
    image features ``[1, image_context_tokens, image_dim]`` drawn from
    ``seed`` (stand-ins for the image encoder), on the pipeline's device."""
    from blade_torch.utils.rng import fold_generator, make_generator
    from blade_torch.utils.video_io import read_image

    p, dev = pipe.preset, pipe.device
    h, w = p.video.height, p.video.width
    g = make_generator(seed, dev)
    if path is None:
        image = torch.rand((1, 3, h, w), generator=g, device=dev) * 2.0 - 1.0
    else:
        u8 = torch.from_numpy(read_image(path)).to(dev)
        image = u8.permute(2, 0, 1)[None].float() / 127.5 - 1.0
        if image.shape[2:] != (h, w):
            image = torch.nn.functional.interpolate(image, size=(h, w), mode="bicubic",
                                                    align_corners=False).clamp(-1.0, 1.0)
    embeds = torch.randn((1, p.dit.image_context_tokens, p.dit.image_dim),
                         generator=fold_generator(g, 1), device=dev)
    return image, embeds.to(pipe.dtype)


def main(argv=None):
    from blade_torch.utils.rng import make_generator
    from blade_torch.utils.tracing import profile_to
    from blade_torch.utils.video_io import export_video

    args = get_args(argv)
    if args.prompt:
        prompts = [args.prompt]
    elif args.prompts:
        with open(args.prompts) as f:
            prompts = [line.strip() for line in f if line.strip()]
    else:
        raise SystemExit("need --prompt or --prompts")
    pipe = build_pipeline(args)
    os.makedirs(args.output_dir, exist_ok=True)
    with profile_to(args.profile):
        for i, prompt in enumerate(prompts):
            try:
                image = {}
                if pipe.preset.family.condition is not None:
                    image = dict(zip(("image", "image_embeds"),
                                     image_inputs(pipe, args.image, args.seed + i)))
                frames = pipe.generate(
                    random_text_embeds(pipe, prompt),
                    generator=make_generator(args.seed + i, pipe.device),
                    num_steps=args.steps, mask_refresh_every=args.mask_refresh_every, **image)
                path = os.path.join(args.output_dir, f"video_{i:04d}.mp4")
                out = export_video(pipe.frames_to_uint8(frames[0]).cpu().numpy(), path,
                                   fps=pipe.preset.video.fps)
                print(f"[{i + 1}/{len(prompts)}] {out}")
            except Exception as e:  # per-prompt isolation (reference behaviour)
                print(f"prompt {i} failed: {type(e).__name__}: {e}")
    if args.profile:
        print(f"wrote {args.profile}")


if __name__ == "__main__":
    main()
