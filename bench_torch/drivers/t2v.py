"""Text to video: whole clips through ``T2VPipeline.generate`` and
``frames_to_uint8``, one client at batch 1 (how the port's inference CLI
generates).

Traffic keys: ``num_steps`` (sampler steps a clip), ``mask_refresh_every``
(0: predict every step), ``mask_mode`` (optional; the preset's serving
lane when absent), with ``driver`` and ``note``; no other is taken.  The
pipeline is built as ``blade_torch.cli.inference.build_pipeline`` builds
it, with random weights from the run's seed; each clip's text embeddings
and generator come from the seed too (``harness.seeds``).

The check: after the window, one finished clip drawn from the seed.  The
reference (``reference/<family>.py``) draws the clip's noise again, runs
the sampler over the velocities the program served, runs its own DiT at
sampled steps of that trajectory, and decodes the program's final latents;
the harness holds the gaps it returns to ``limits/<workload>.json``.
"""

from __future__ import annotations

import importlib
import random
import time

import torch

from bench_torch.harness import roofline, seeds

KEYS = {"driver", "note", "num_steps", "mask_refresh_every", "mask_mode"}


class Driver:
    def __init__(self, config, traffic, *, seed, device, spans, check_steps=None):
        from blade_torch import config as C
        from blade_torch.sampling.t2v import T2VPipeline
        from blade_torch.utils.rng import make_generator

        if set(traffic) - KEYS or "num_steps" not in traffic:
            raise ValueError(f"traffic keys {sorted(set(traffic) - KEYS)} are not this "
                             "driver's, or num_steps is missing")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.steps = int(traffic["num_steps"])
        self.refresh = int(traffic.get("mask_refresh_every", 0))
        preset = C.PRESETS[config["preset"]]
        self.ref = importlib.import_module(f"bench_torch.reference.{config['family']}")
        self.ref.check_preset(config, preset)
        self.pipe = T2VPipeline.random_init(
            preset, make_generator(seed, device), sparse=True,
            mask_mode=traffic.get("mask_mode"), dtype=getattr(torch, config["dtype"]))
        self._make_generator = make_generator
        self._rng = random.Random(seeds.derive(seed, seeds.CHECK))
        self.kept = None  # the clip the check will compare (reservoir of one)
        self._velocities = []
        self._latents = None
        self.host = {"denoise_s": 0.0, "decode_s": 0.0}
        self.asa = []  # per ASA call: (mask or lists, lq, lk, d)
        self.forwards = self.clips = 0
        self._wire()

    # -- the program, with the benchmark's spans and records around it ------

    def _wire(self):
        pipe, spans = self.pipe, self.spans
        pipe.dit.register_forward_pre_hook(lambda m, a: spans.enter("dit"))

        def after_forward(module, args, out):
            spans.exit()
            self._velocities.append(out)
            self.forwards += 1

        pipe.dit.register_forward_hook(after_forward)
        sample_latents, decode_latents = pipe.sample_latents, pipe.decode_latents

        def timed(name, fn):
            """Traced runs: the host time of ``fn``, from a synchronize to
            a synchronize."""
            def run(*a, **kw):
                if not spans.enabled:
                    return fn(*a, **kw)
                with spans(name):
                    self._sync()
                    t = time.perf_counter()
                    out = fn(*a, **kw)
                    self._sync()
                    self.host[f"{name}_s"] += time.perf_counter() - t
                return out
            return run

        def decode(latents):
            self._latents = latents
            return decode_latents(latents)

        pipe.sample_latents = timed("denoise", sample_latents)
        pipe.decode_latents = timed("decode", decode)
        if spans.enabled:
            self._wire_asa()

    def _wire_asa(self):
        """Traced runs: every ASA call inside a ``bench.asa`` span; its mask
        kept (the ``collect_mask`` protocol, the same computation) and
        counted once the window has closed (``records``)."""
        dit, spans = self.pipe.dit, self.spans
        fn = dit.attention_fn

        def collecting(q, k, v, **kw):
            with spans("asa"):
                out, mask = fn(q, k, v, collect_mask=True, **kw)
            self.asa.append((mask, q.shape[2], k.shape[2], q.shape[3]))
            return out

        dit.attention_fn = collecting

    def _asa_work(self):
        """Per ASA call kept: its density, model operations and least
        seconds (``harness.roofline``)."""
        asa = self.config["asa"]
        for mask, lq, lk, d in self.asa:
            if isinstance(mask, (tuple, list)) or mask.dtype != torch.bool:
                # multilevel lane: per-level lists, or an int level mask
                idx, cnt = mask if isinstance(mask, (tuple, list)) else \
                    roofline.levels_to_lists(mask)
                q_rows = 128 * -(-(-(-lq // 128)) // idx.shape[-3])
                density = cnt[..., 0].double().mean() / -(-lk // 128)
                flops, least = roofline.asa_multilevel_work(
                    idx, cnt, lq, lk, d, q_rows, asa["sample_tokens"])
            else:  # energy lane: the block mask
                density = mask.double().mean()
                flops, least = roofline.asa_energy_work(
                    mask, lq, lk, d, asa["sample_tokens"], asa["sample_gap"])
            yield torch.stack([density, torch.as_tensor(flops, dtype=torch.float64,
                                                        device=density.device),
                               torch.as_tensor(least, dtype=torch.float64,
                                               device=density.device)])

    def _inputs(self, stream, index):
        """Clip ``index`` of ``stream``: its text embeddings (N(0, 1) in
        the served dtype) and the seed of its generator."""
        c, seed = self.config, seeds.derive(self.seed, stream, index)
        g = self._make_generator(seeds.mix(seed, seeds.TEXT), self.device)
        text = torch.randn((1, c["text_len"], c["text_dim"]), generator=g, device=self.device)
        return text.to(self.pipe.dtype), seed

    def _clip(self, stream, index):
        pipe = self.pipe
        self._velocities = []
        text, seed = self._inputs(stream, index)
        frames = pipe.generate(text, generator=self._make_generator(seed, self.device),
                               num_steps=self.steps, mask_refresh_every=self.refresh)
        u8 = pipe.frames_to_uint8(frames)
        self._sync()
        return u8

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the harness's interface -----------------------------------------

    def warm(self):
        self._clip(seeds.WARM, 0)
        self.host = {"denoise_s": 0.0, "decode_s": 0.0}
        self.asa, self.forwards = [], 0

    def issue(self, i):
        with self.spans("request"):
            u8 = self._clip(seeds.REQUEST, i)
        if self._rng.random() * (i + 1) < 1.0:  # keep clip i with chance 1/(i+1)
            self.kept = (i, list(self._velocities), self._latents, u8)
        self.clips = i + 1

    def control_unit(self):
        self.issue(0)

    def end_to_end(self, window_s, units):
        return {"clip_s": window_s / units}

    def records(self):
        n = self.clips
        rec = {"units": n, "forwards": self.forwards,
               "denoise_s": self.host["denoise_s"] / n, "decode_s": self.host["decode_s"] / n,
               "denoise_total_s": self.host["denoise_s"]}
        if self.asa:
            a = torch.stack(list(self._asa_work())).cpu()
            rec["density"] = float(a[:, 0].mean())
            rec["asa_flops"] = float(a[:, 1].sum())
            rec["asa_bound_s"] = float(a[:, 2].sum())
            grid = self.pipe.preset.latent_grid()
            rec["model_flops"] = {"denoise": self.forwards * self.ref.dense_flops(
                self.config, grid[0] * grid[1] * grid[2]) + rec["asa_flops"]}
        return rec

    def check(self, check_steps, control=False):
        """Frees the program and returns the gaps of the kept clip to the
        reference (``reference/<family>.py::check_t2v``) at ``check_steps``
        sampler steps drawn from the seed; with ``control``, the control's
        too."""
        index, velocities, latents, u8 = self.kept
        steps = sorted(self._rng.sample(range(self.steps), int(check_steps)))
        text, request_seed = self._inputs(seeds.REQUEST, index)
        del self.pipe, self._velocities, self._latents, self.kept
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return self.ref.check_t2v(self.config, self.traffic, weight_seed=self.seed,
                                  request_seed=request_seed, text=text,
                                  velocities=velocities, latents=latents, frames=u8,
                                  steps=steps, device=self.device, control=control)
