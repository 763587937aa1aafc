"""TDM distillation: whole training steps through the trainer's step, one
after another at batch 1 (how the port's training CLI runs them, without
its file writes).

Traffic keys (every one required, no other taken): ``diffusion`` (``flow``
or ``ddpm``), ``k_step``, ``eta``, ``cfg``, ``lambda_reg``, ``rank``,
``lora_alpha``, ``learning_rate_g``, ``learning_rate_fake``,
``adam_beta1``, ``adam_beta2``, ``adam_weight_decay``, ``adam_epsilon``,
``max_grad_norm`` (the CLI's flags of those names), ``weighting_factor``,
``fake_loss_skip``, ``total_steps``, ``t_max`` (what the trainer sets for
the family) and ``asa`` (the lane the trainer runs: its sizes), with
``driver`` and ``note``.  The step is assembled as
``blade_torch.cli.train.main`` assembles it (``build_preset``,
``build_model``, ``diffusion_family``, ``tdm_config``, ``model_apply_fn``,
``create_tdm_state``, ``make_tdm_train_step``) from the CLI's own flags,
with ``--seed`` the run's seed folded with 1, and each step's batch drawn as
``main`` draws it; the driver checks that the trainer runs the mix's
settings.

Set-up builds the one training state and drives it through the steps the
check follows (``check_steps``), which also warms every shape; the window
runs the next steps on that same state.  The check: after the window, the
program freed, the plain reference (``reference/tdm.py``) follows the same
first steps from the seed and the harness holds the gaps of each step's
losses, of the first gradient's norm a leaf (from Adam's state after one
step) and of each leaf's change over the steps to ``limits/<workload>.json``.
"""

from __future__ import annotations

import importlib
import time

import torch

from bench_torch.harness import roofline, seeds
from bench_torch.reference import tdm as ref_tdm

KEYS = {"driver", "note", "diffusion", "k_step", "eta", "cfg", "lambda_reg", "rank",
        "lora_alpha", "learning_rate_g", "learning_rate_fake", "adam_beta1", "adam_beta2",
        "adam_weight_decay", "adam_epsilon", "max_grad_norm", "weighting_factor",
        "fake_loss_skip", "total_steps", "t_max", "asa"}
FLAGS = ("k_step", "eta", "cfg", "lambda_reg", "rank", "lora_alpha", "learning_rate_g",
         "learning_rate_fake", "adam_beta1", "adam_beta2", "adam_weight_decay",
         "adam_epsilon", "max_grad_norm")


class Driver:
    def __init__(self, config, traffic, *, seed, device, spans, check_steps):
        from blade_torch.cli import train as T
        from blade_torch.config import derive_asa_config
        from blade_torch.training import tdm
        from blade_torch.utils.rng import fold_generator, make_generator

        if set(traffic) != KEYS:
            raise ValueError(f"traffic keys {sorted(set(traffic) ^ KEYS)} are not this driver's")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans, self.check_steps = device, spans, int(check_steps)
        argv = ["--family", config["family"], "--random-init", "--output_dir", "unused",
                "--batch_size", "1", "--seed", str(seeds.mix(seed, 1)),
                "--device", str(device)]
        argv += [a for k in FLAGS for a in (f"--{k}", str(traffic[k]))]
        if config["dtype"] == "float32":  # the CLI holds only its tiny presets in f32
            argv.append("--tiny")
        args = T.get_args(argv)
        self.preset = preset = T.build_preset(args)
        self.ref = importlib.import_module(f"bench_torch.reference.{config['family']}")
        self.ref.check_preset(config, preset)
        cfg = T.tdm_config(args)
        asa = derive_asa_config(preset, "energy")
        ran = {"weighting_factor": cfg.use_weighting_factor,
               "fake_loss_skip": cfg.fake_loss_skip_threshold, "total_steps": cfg.total_steps,
               "t_max": cfg.t_max, "diffusion": "flow" if preset.name == "wan" else "ddpm",
               "asa": {"lane": asa.mask_mode, "predictor": asa.predictor,
                       "sample_tokens": asa.sample_tokens_per_block,
                       "sample_gap": asa.sample_gap, "min_retain_ratio": asa.min_retain_ratio,
                       "max_retain_ratio": asa.max_retain_ratio,
                       "energy_threshold": asa.energy_threshold, "block": asa.block_size}}
        bad = {k: (traffic[k], v) for k, v in ran.items() if traffic[k] != v}
        if bad:
            raise ValueError(f"the trainer runs other settings than the mix: {bad}")
        self.model = T.build_model(args, preset, device)
        self.dtype = self.model.dtype
        self.root = make_generator(args.seed, device)
        base = {n: p.detach() for n, p in self.model.named_parameters()}
        self.state = tdm.create_tdm_state(fold_generator(self.root, 1), base, cfg)
        self.train_step = tdm.make_tdm_train_step(
            T.model_apply_fn(self.model), T.diffusion_family(preset, device), cfg)
        self.lat_shape = T.latent_shape(preset, 1)
        self._fold = fold_generator
        self.steps = 0
        self.readings = None
        self.host_s = 0.0
        self.asa = []  # per ASA call of a model forward: (mask, lq, lk, d, with gradient)
        self.forwards = self.backwards = 0
        self._recording = False
        self._wire()

    # -- the program, with the benchmark's spans and records around it ------

    def _wire(self):
        model, spans = self.model, self.spans
        if not spans.enabled:
            return

        def before(module, args):
            spans.enter("dit")
            self._recording = True
            self.forwards += 1
            self.backwards += torch.is_grad_enabled()

        def after(module, args, out):
            self._recording = False
            spans.exit()

        model.register_forward_pre_hook(before)
        model.register_forward_hook(after)
        fn = model.attention_fn

        def collecting(q, k, v, **kw):
            """Every ASA call inside a ``bench.asa`` span; a model forward's
            mask kept (the ``collect_mask`` protocol, the same computation)
            and counted after the window.  A block recomputed in the
            backward opens the span again and keeps nothing."""
            with spans("asa"):
                if not self._recording:
                    return fn(q, k, v, **kw)
                out, mask = fn(q, k, v, **dict(kw, collect_mask=True))
            self.asa.append((mask, q.shape[2], k.shape[2], q.shape[3], torch.is_grad_enabled()))
            return out

        model.attention_fn = collecting

    def _step(self):
        """One step of the trainer, with its batch drawn as the CLI draws it."""
        fold, dev = self._fold, self.device
        r = fold(self.root, 1000 + self.steps)
        text = torch.randn((1, self.preset.max_text_len, self.preset.text_dim),
                           generator=fold(r, 1), device=dev).to(self.dtype)
        noise = torch.randn(self.lat_shape, generator=fold(r, 2), device=dev)
        batch = {"text_embeds": text, "uncond_embeds": torch.zeros_like(text),
                 "noise": noise.to(self.dtype)}
        self.state, metrics = self.train_step(self.state, batch, r)
        self.steps += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return metrics

    # -- the harness's interface -----------------------------------------

    def warm(self):
        """The steps the check follows: every shape built, and the program's
        readings of them taken (losses, the first gradient's norms from
        Adam's state after one step, each leaf's change over the steps)."""
        b2 = self.traffic["adam_beta2"]
        start = {"g": self.state.lora_g, "f": self.state.lora_f}  # never written in place
        rd = {"losses": [], "fake_skipped": []}
        for s in range(self.check_steps):
            m = self._step()
            rd["losses"].append([float(m["loss_fake"]), float(m["loss_du"])])
            rd["fake_skipped"].append(bool(m["fake_skipped"]))
            if s == 0:
                rd["first_grad_norms"] = {
                    k: ref_tdm.state_norms({"count": o["count"], "nu": list(o["nu"].values())}, b2)
                    for k, o in (("g", self.state.opt_g), ("f", self.state.opt_f))}
        rd["change_norms"] = {k: [float((p - start[k][n]).norm()) for n, p in lora.items()]
                              for k, lora in (("g", self.state.lora_g), ("f", self.state.lora_f))}
        self.readings = rd
        self.asa, self.forwards, self.backwards = [], 0, 0

    def control_unit(self):
        self.warm()

    def issue(self, i):
        with self.spans("step"):
            t = time.perf_counter()
            self._step()
            self.host_s += time.perf_counter() - t

    def end_to_end(self, window_s, units):
        return {"train_step_s": window_s / units}

    def records(self):
        """Host time of the window's steps, and what its ASA calls did, read
        from the kept masks once the window has closed."""
        rec = {"units": self.steps - self.check_steps, "forwards": self.forwards,
               "backwards": self.backwards, "step_total_s": self.host_s}
        if not self.asa:
            return rec
        asa = self.traffic["asa"]
        dens, fwd, bwd, bound = [], 0.0, 0.0, 0.0
        for mask, lq, lk, d, grad in self.asa:
            dens.append(mask.double().mean())
            f, t = roofline.asa_energy_work(mask, lq, lk, d, asa["sample_tokens"],
                                            asa["sample_gap"])
            fwd, bound = fwd + f, bound + t
            if grad:
                f, t = roofline.asa_energy_backward_work(mask, lq, lk, d, asa["sample_gap"])
                bwd, bound = bwd + f, bound + t
        grid = self.preset.latent_grid()
        tokens = grid[0] * grid[1] * grid[2]
        rec["density"] = float(torch.stack(dens).mean())
        rec["asa_bound_s"] = float(bound)
        rec["model_flops"] = {"train": float(
            self.forwards * self.ref.dense_flops(self.config, tokens) + fwd
            + self.backwards * self.ref.backward_flops(self.config, tokens,
                                                       self.traffic["rank"]) + bwd)}
        return rec

    def check(self, check_steps, control=False):
        """Frees the program and returns the gaps of its readings of the
        first ``check_steps`` steps to the reference's
        (``reference/tdm.py::check_tdm``); with ``control``, the control's
        too."""
        del self.model, self.state, self.train_step, self.asa
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return ref_tdm.check_tdm(self.ref, self.config, self.traffic, seed=self.seed,
                                 steps=int(check_steps), program=self.readings,
                                 device=self.device, control=control)
