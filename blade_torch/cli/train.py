"""TDM distillation training CLI, Wan and CogVideoX (counterpart of
``blade/cli/train.py``, with the same flag names).

Data-free: the prompt-embedding store and real weights are not ported yet,
so the CLI trains random weights (``--random-init``) on random text
embeddings drawn per step from the seed.  For non-tiny presets the frozen
base is held in bf16 and each DiT block is rematerialised in the backward.
Both families train with ASA on the energy lane, as the reference trainer
does; Wan on the flow-matching family with the fake-loss guard, CogVideoX
(latents ``[B, T, C, H, W]``) on the DDPM v-prediction family with the
generator loss's weighting factor.

Examples:
  python -m blade_torch.cli.train --family wan --random-init --batch_size 1 \\
      --k_step 2 --cfg 5.0 --lambda_reg 0 --rank 64 --max_train_steps 3 \\
      --checkpointing_steps 2 --output_dir runs/wan_tdm          # one H100
  python -m blade_torch.cli.train --family cogvideox --random-init \\
      --batch_size 1 --k_step 2 --max_train_steps 3 --output_dir runs/cog_tdm
  python -m blade_torch.cli.train --family wan --tiny --random-init \\
      --device cpu --max_train_steps 2 --batch_size 2 --output_dir /tmp/tdm

``--profile PATH`` runs the training steps under ``torch.profiler`` with the
port's tracing on (``blade_torch.utils.tracing``: ``blade.tdm.*`` phases,
the DiT and ASA inside them, ``blade.sync`` at each host readback) and
writes the Chrome trace to ``PATH`` (``python -m
bench_torch.harness.program_trace PATH`` reduces it).  The first step
builds the kernels: profile three or more to see a warm one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description="BLADE PyTorch TDM distillation")
    p.add_argument("--family", choices=["wan", "cogvideox"], default="wan")
    p.add_argument("--weights", type=str)
    p.add_argument("--prompt_embeds", type=str,
                   help="dir with individual_embeddings/*.npy + uncond.npy")
    p.add_argument("--output_dir", type=str, required=True)
    # TDM hyperparameters (reference train_tdm_1.sh defaults)
    p.add_argument("--k_step", type=int, default=8)
    p.add_argument("--eta", type=float, default=0.9)
    p.add_argument("--cfg", type=float, default=3.5)
    p.add_argument("--lambda_reg", type=float, default=0.5)
    p.add_argument("--learning_rate_g", type=float, default=1e-4)
    p.add_argument("--learning_rate_fake", type=float, default=5e-4)
    p.add_argument("--adam_beta1", type=float, default=0.0)
    p.add_argument("--adam_beta2", type=float, default=0.95)
    p.add_argument("--adam_weight_decay", type=float, default=1e-4)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--lr_scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine", "cosine_with_restarts", "polynomial"])
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--lr_num_cycles", type=int, default=1)
    p.add_argument("--lr_power", type=float, default=1.0)
    p.add_argument("--rank", type=int, default=64)
    p.add_argument("--lora_alpha", type=float, default=64)
    p.add_argument("--optimizer", choices=["adamw", "adam", "prodigy"], default="adamw")
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient accumulation steps (reference x4)")
    p.add_argument("--report_to", choices=["none", "tensorboard"], default="none")
    p.add_argument("--batch_size", type=int, default=5)
    p.add_argument("--max_train_steps", type=int, default=None,
                   help="total optimizer steps (default: epochs x 300)")
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--use_sparsity", action="store_true", default=True)
    p.add_argument("--dense", dest="use_sparsity", action="store_false")
    p.add_argument("--checkpointing_steps", type=int, default=50)
    p.add_argument("--sample_at_checkpoint", action="store_true")
    p.add_argument("--checkpoints_total_limit", type=int, default=5)
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help='"latest" or a step number')
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--video", type=int, nargs=3, metavar=("F", "H", "W"), default=None,
                   help="override frames/height/width")
    p.add_argument("--remat", action="store_true", default=None,
                   help="rematerialise each DiT block in the backward "
                        "(default: on for full-size presets)")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    p.add_argument("--profile", type=str, default=None, metavar="PATH",
                   help="run the steps under torch.profiler with the port's spans on and "
                        "write the Chrome trace to PATH")
    return p.parse_args(argv)


def _refuse_later_slices(args) -> None:
    """Flags whose paths are not ported yet fail loudly instead of being
    ignored."""
    todo = []
    if args.prompt_embeds:
        todo.append("--prompt_embeds (the native embedding store)")
    if args.report_to != "none":
        todo.append("--report_to tensorboard")
    if args.sample_at_checkpoint:
        todo.append("--sample_at_checkpoint (the K-step student's samples decoded at a "
                    "checkpoint)")
    if args.dp * args.fsdp * args.tp > 1:
        todo.append("--dp/--fsdp/--tp > 1 (multi-device)")
    if args.optimizer == "prodigy":
        todo.append("--optimizer prodigy")
    if args.use_8bit_adam:
        todo.append("--use_8bit_adam (bf16 optimizer moments)")
    if todo:
        raise SystemExit("not ported yet: " + ", ".join(todo))
    if not args.random_init:
        raise SystemExit("checkpoint loading is not ported yet: pass --random-init")


def build_preset(args):
    from blade_torch import config as C

    family = C.FAMILIES[args.family]
    preset = family.tiny if args.tiny else family.full
    if args.video:
        f, h, w = args.video
        preset = dataclasses.replace(preset, video=C.VideoSpec(f, h, w, preset.video.fps))
    return preset


def build_model(args, preset, device):
    """The DiT with random weights from ``--seed``, frozen: f32 for the tiny
    preset, otherwise bf16 (three merged roles of the base in f32 would not
    fit one card; LoRA factors and optimizer states stay f32)."""
    from blade_torch.config import derive_asa_config
    from blade_torch.utils.rng import make_generator

    kwargs = {}
    if args.use_sparsity:
        from blade_torch.attention.integration import asa_model_kwargs

        # the energy lane for both families, as the reference trainer
        # (CogVideoX serves on the multilevel lane)
        kwargs = asa_model_kwargs(derive_asa_config(preset, "energy"))
    remat = args.remat if args.remat is not None else not args.tiny
    model = preset.family.dit_class(
        preset.dit, dtype=torch.float32 if args.tiny else torch.bfloat16, remat=remat,
        device=device, **kwargs)
    model.random_init_(make_generator(args.seed, device))
    if not args.tiny:
        model.to(torch.bfloat16)
    return model.requires_grad_(False)


def latent_shape(preset, batch: int):
    """Wan ``[B, C, T, H, W]``; CogVideoX ``[B, T, C, H, W]``."""
    return preset.family.latent_shape(preset, batch)


def diffusion_family(preset, device):
    """Wan: flow matching over the shifted training sigmas; CogVideoX: DDPM
    v-prediction over the preset's schedule."""
    return preset.family.diffusion(preset, device)


def tdm_config(args):
    from blade_torch.config import FAMILIES
    from blade_torch.training import tdm

    family = FAMILIES[args.family]
    return tdm.TDMConfig(
        k_step=args.k_step, eta=args.eta, cfg=args.cfg, lambda_reg=args.lambda_reg,
        lr_generator=args.learning_rate_g, lr_fake=args.learning_rate_fake,
        adam_b1=args.adam_beta1, adam_b2=args.adam_beta2,
        max_grad_norm=args.max_grad_norm, lora_rank=args.rank,
        lora_alpha=args.lora_alpha,
        use_weighting_factor=family.use_weighting_factor,
        fake_loss_skip_threshold=family.fake_loss_skip_threshold,
        optimizer=args.optimizer, grad_accum=args.grad_accum,
        lr_scheduler=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps,
        lr_num_cycles=args.lr_num_cycles, lr_power=args.lr_power,
        max_train_steps=args.max_train_steps, weight_decay=args.adam_weight_decay,
        adam_eps=args.adam_epsilon)


def model_apply_fn(model):
    """``apply(params, latents, t, text, generator)``: one role's forward."""

    def apply(params, x, t, text, generator):
        return torch.func.functional_call(model, params, (x, t, text),
                                          {"attn_kwargs": {"generator": generator}})

    return apply


def main(argv=None, *, on_step=None):
    """Train; returns ``(state, history)``, the final ``TDMState`` and one
    metrics record a step.  ``on_step(record, state)``, if given, runs after
    each step (once the device has finished it)."""
    from blade_torch.training import tdm
    from blade_torch.training.checkpointing import CheckpointManager
    from blade_torch.training.lora import export_lora
    from blade_torch.utils.rng import fold_generator, make_generator
    from blade_torch.utils.tracing import profile_to

    args = get_args(argv)
    _refuse_later_slices(args)
    if args.max_train_steps is None:
        args.max_train_steps = args.num_train_epochs * 300
    device = torch.device(args.device or "cuda")
    preset = build_preset(args)
    model = build_model(args, preset, device)
    dtype = model.dtype
    family = diffusion_family(preset, device)
    cfg = tdm_config(args)
    lat_shape = latent_shape(preset, args.batch_size)
    root = make_generator(args.seed, device)

    base = {n: p.detach() for n, p in model.named_parameters()}
    state = tdm.create_tdm_state(fold_generator(root, 1), base, cfg)
    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                             max_to_keep=args.checkpoints_total_limit)
    if args.resume_from_checkpoint:
        step = (None if args.resume_from_checkpoint == "latest"
                else int(args.resume_from_checkpoint))
        state = ckpt.restore(state, step)
        print(f"resumed from step {state.step}")

    def load_batch(r):
        text = torch.randn((args.batch_size, preset.max_text_len, preset.text_dim),
                           generator=fold_generator(r, 1), device=device).to(dtype)
        noise = torch.randn(lat_shape, generator=fold_generator(r, 2), device=device)
        return {"text_embeds": text, "uncond_embeds": torch.zeros_like(text),
                "noise": noise.to(dtype)}

    train_step = tdm.make_tdm_train_step(model_apply_fn(model), family, cfg)
    os.makedirs(args.output_dir, exist_ok=True)
    print(f"training {args.max_train_steps} steps, batch {args.batch_size}, latents "
          f"{list(lat_shape)}, {'ASA' if args.use_sparsity else 'dense'}, "
          f"remat {model.remat}, device {device}")
    history = []
    t0 = time.perf_counter()
    with open(os.path.join(args.output_dir, "metrics.jsonl"), "a") as metrics_log, \
            profile_to(args.profile):
        for step_idx in range(state.step, args.max_train_steps):
            r = fold_generator(root, 1000 + step_idx)
            t_step = time.perf_counter()
            state, metrics = train_step(state, load_batch(r), r)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            rec = dict(step=step_idx, **metrics, step_s=now - t_step, t=time.time())
            history.append(rec)
            lr_str = f" lr={rec['lr']:.2e}" if "lr" in rec else ""
            skip_str = " (fake update skipped: loss_fake over the guard)" if (
                rec["fake_skipped"]) else ""
            print(f"step {step_idx}: loss_fake={rec['loss_fake']:.4f} "
                  f"loss_du={rec['loss_du']:.4f}{lr_str} ({rec['step_s']:.2f} s; "
                  f"{(now - t0) / len(history):.2f} s/step){skip_str}", flush=True)
            if on_step is not None:
                on_step(rec, state)
            metrics_log.write(json.dumps(rec) + "\n")
            metrics_log.flush()
            if (step_idx + 1) % args.checkpointing_steps == 0:
                ckpt.save(step_idx + 1, state)
                print(f"saved checkpoint @ {step_idx + 1}")

    if args.profile:
        print(f"wrote {args.profile}")
    out = os.path.join(args.output_dir, "tdm_lora.npz")
    np.savez(out, **export_lora(model, state.lora_g, alpha=cfg.lora_alpha,
                                rank=cfg.lora_rank))
    print(f"wrote {out}")
    return state, history


if __name__ == "__main__":
    main()
