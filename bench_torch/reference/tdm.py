"""Plain reference of TDM distillation steps (Trajectory Distribution
Matching, data-free; BLADE's trainer), from the traffic mix's settings and
the configuration's sizes, for either model family.

One step, as the TDM paper and BLADE's reference trainer describe it, with
three roles over one frozen base: the student (base + LoRA_g), the fake
score (base + LoRA_f) and the teacher (the base):

1. a K-step stochastic DDIM rollout of the student from the step's noise
   (no gradient);
2. the fake-score update: the student's x0 at a random segment of the
   rollout, re-noised to a random ``t``; the fake score's x0 there held to
   it (and, with ``lambda_reg``, to the teacher's) in an MSE weighted by
   ``1 / sigma_t^2``; Adam on LoRA_f, rolled back when the loss reaches the
   guard;
3. the generator update: the student's x0 at another segment, re-noised;
   its target ``x0 + teacher(cfg) - fake`` with every term stopped, a
   pseudo-Huber loss (over the weighting factor ``mean |x0 - teacher|``
   clamped at 5, where the mix says so); Adam on LoRA_g.

Every draw (the step's noise and text embeddings, the rollout's and the
distillation points' noises, segments and times, ASA's token samples) is
made again from the run's seed by the protocol the driver states, and the
adapters are drawn again too (``a ~ N(0, 1 / rank)``, ``b = 0``), so
nothing is taken from the program.  The base is the family's reference
DiT with every weight in the configuration's dtype (the served base), the
adapters and Adam's state in f32; products the configuration computes in bf16 run in
TF32, those it computes in f32 in f64, everything else in f32
(``common.TRAIN_REFERENCE``).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch

from bench_torch.reference import common as R


# -- the two diffusion families ------------------------------------------------

class Flow:
    """Flow matching over the shifted training sigmas ``shift(t / T)``:
    ``x_t = (1 - s) x0 + s eps``, the model predicts ``eps - x0``."""

    def __init__(self, c: dict, total: int):
        t = np.arange(total, dtype=np.float64) / total
        shift = c["flow_shift"]
        self.sigma = (shift * t / (1.0 + (shift - 1.0) * t)).astype(np.float32)

    def _s(self, t):
        return float(self.sigma[t])

    def pred_x0(self, out, x, t):
        return x - self._s(t) * out

    def pred_eps(self, x0, x, t):
        s = self._s(t)
        return (x - (1.0 - s) * x0) / max(s, 1e-6)

    def add_noise(self, x0, eps, t):
        s = self._s(t)
        return (1.0 - s) * x0 + s * eps

    def renoise(self, x, xi, t1, t2):
        s1, s2 = np.float32(self._s(t1)), np.float32(self._s(t2))
        ratio = np.float32((np.float32(1.0) - s2) / (np.float32(1.0) - s1))
        beta = np.sqrt(max(s2 * s2 - (ratio * s1) ** 2, np.float32(0.0)), dtype=np.float32)
        return float(ratio) * x + float(beta) * xi

    def sigma_at(self, t):
        return self._s(t)


class DDPM:
    """DDPM v-prediction over the configuration's schedule: ``x_t = a x0 +
    s eps``, the model predicts ``v = a eps - s x0``."""

    def __init__(self, c: dict, total: int):
        self.alpha, self.sigma = R.ddpm_tables(c["schedule"])

    def pred_x0(self, out, x, t):
        return float(self.alpha[t]) * x - float(self.sigma[t]) * out

    def pred_eps(self, x0, x, t):
        return (x - float(self.alpha[t]) * x0) / float(self.sigma[t])

    def add_noise(self, x0, eps, t):
        return float(self.alpha[t]) * x0 + float(self.sigma[t]) * eps

    def renoise(self, x, xi, t1, t2):
        a1, a2, s1, s2 = self.alpha[t1], self.alpha[t2], self.sigma[t1], self.sigma[t2]
        ratio = np.float32(a2 / a1)
        beta = np.sqrt(max(s2 * s2 - (ratio * s1) ** 2, np.float32(0.0)), dtype=np.float32)
        return float(ratio) * x + float(beta) * xi

    def sigma_at(self, t):
        return float(self.sigma[t])


FAMILIES = {"flow": Flow, "ddpm": DDPM}


# -- draws ----------------------------------------------------------------------

def _gen(seed, device):
    return R.generator(seed, device)


def served(c: dict, t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the configuration's dtype (the trainer holds its
    base and its inputs in it), in f32."""
    return t.to(getattr(torch, c["dtype"])).float()


def step_draws(root: int, step: int, shape, c: dict, k_step: int, device) -> dict:
    """Every draw of step ``step`` of a run whose trainer seed is ``root``:
    the step's seed is ``root`` folded with ``1000 + step``; its text
    embeddings (folded 1) and noise (folded 2) are N(0, 1) in the served
    dtype; the step's twelve sub-seeds are its seed folded with ``step`` and then
    with 0..11 (0: the rollout, folded again with k for its k-th forward,
    whose noise is that folded with 1; 1-4 the fake update's segment,
    uniform and two noises; 5 the teacher's and fake score's forwards; 6-9
    the generator update's four; 10 the student's forward in the fake
    update; 11 the generator's forward)."""
    r = R.fold_seed(root, 1000 + step)
    g = R.fold_seed(r, step)
    sub = [R.fold_seed(g, i) for i in range(12)]

    def normal(seed, shp=shape):
        return torch.randn(shp, generator=_gen(seed, device), device=device)

    def ind(seed):
        return int(torch.randint(1, k_step + 1, (1,), generator=_gen(seed, device),
                                 device=device))

    def uniform(seed):
        return torch.rand((1,), generator=_gen(seed, device), device=device)

    traj = [R.fold_seed(sub[0], k) for k in range(k_step)]
    text = normal(R.fold_seed(r, 1), (1, c["text_len"], c["text_dim"]))
    return dict(
        text=served(c, text), noise=served(c, normal(R.fold_seed(r, 2))),
        traj=traj, traj_xi=[normal(R.fold_seed(s, 1)) for s in traj],
        fake=(ind(sub[1]), uniform(sub[2]), normal(sub[3]), normal(sub[4])),
        gen=(ind(sub[6]), uniform(sub[7]), normal(sub[8]), normal(sub[9])),
        teacher=sub[5], student=sub[10], generator=sub[11])


def lora_init(seed: int, shapes: List[tuple], rank: int, device) -> List[torch.Tensor]:
    """Factors ``[a_1, b_1, a_2, b_2, ...]`` of the adapted projections
    ``[(d_out, d_in), ...]`` in order: ``a_j [d_in, r]`` N(0, 1 / r) from
    ``seed`` folded with ``j``, ``b_j [r, d_out]`` zeros."""
    out = []
    for j, (d_out, d_in) in enumerate(shapes, start=1):
        a = torch.randn((d_in, rank), generator=_gen(R.fold_seed(seed, j), device),
                        device=device) / math.sqrt(rank)
        out += [a, torch.zeros((rank, d_out), device=device)]
    return out


# -- the step ------------------------------------------------------------------

class Trainer:
    """TDM steps of one family's reference DiT from a run's seed."""

    def __init__(self, family, c: dict, mix: dict, seed: int, device, prec):
        self.f, self.c, self.mix, self.dev, self.prec = family, c, mix, device, prec
        self.diff = FAMILIES[mix["diffusion"]](c, mix["total_steps"])
        self.w = {k: served(c, t) for k, t in family.dit_weights(c, seed, device).items()}
        self.names = family.lora_targets(c)
        shapes = [tuple(self.w[n].shape) for n in self.names]
        self.root = R.fold_seed(seed, 1)  # the trainer's seed (the weights' too)
        state = R.fold_seed(self.root, 1)
        self.lora = {"g": lora_init(R.fold_seed(state, 0), shapes, mix["rank"], device),
                     "f": lora_init(R.fold_seed(state, 1), shapes, mix["rank"], device)}
        self.opt = {k: {"count": 0, "mu": [torch.zeros_like(p) for p in v],
                        "nu": [torch.zeros_like(p) for p in v]} for k, v in self.lora.items()}
        self.shape = family.latent_shape(c)
        self.step = 0

    def merged(self, lora):
        scale = self.mix["lora_alpha"] / self.mix["rank"]
        w = dict(self.w)
        for j, name in enumerate(self.names):
            w[name] = self.w[name] + scale * (lora[2 * j] @ lora[2 * j + 1]).t()
        return w

    def x0(self, w, x, t, text, seed, guidance=None, uncond=None):
        asa, diff = self.mix["asa"], self.diff
        x0 = diff.pred_x0(self.f.dit_forward(w, self.c, x, float(t), text, seed, self.prec, asa),
                          x, t)
        if guidance is not None:
            x0_u = diff.pred_x0(self.f.dit_forward(w, self.c, x, float(t), uncond, seed,
                                                   self.prec, asa), x, t)
            x0 = x0_u + guidance * (x0 - x0_u)
        return x0

    def adam(self, which, grads, lr):
        m, st, params = self.mix, self.opt[which], self.lora[which]
        norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        clip = 1.0 if norm < m["max_grad_norm"] else m["max_grad_norm"] / norm
        count = st["count"] + 1
        b1, b2 = m["adam_beta1"], m["adam_beta2"]
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        mu, nu, new = [], [], []
        for p, g, m0, v0 in zip(params, grads, st["mu"], st["nu"]):
            g = g * clip
            mu.append((1.0 - b1) * g + b1 * m0)
            nu.append((1.0 - b2) * g * g + b2 * v0)
            u = (mu[-1] / c1) / (torch.sqrt(nu[-1] / c2) + m["adam_epsilon"])
            new.append(p - lr * (u + m["adam_weight_decay"] * p))
        return new, {"count": count, "mu": mu, "nu": nu}

    @torch.no_grad()
    def rollout(self, d):
        """The student's K-step stochastic DDIM rollout: the input of each
        step, then the last x0 (``K + 1``)."""
        m, diff = self.mix, self.diff
        k_step, eta = m["k_step"], m["eta"]
        delta = m["total_steps"] // k_step
        w = self.merged(self.lora["g"])
        x, t, noisy = d["noise"], m["total_steps"] - 1, []
        for k in range(k_step):
            x0 = self.x0(w, x, t, d["text"], d["traj"][k])
            eps = eta * diff.pred_eps(x0, x, t) + math.sqrt(max(1.0 - eta ** 2, 0.0)) * \
                d["traj_xi"][k]
            noisy.append(x)
            x, t = diff.add_noise(x0, eps, max(t - delta, 0)), t - delta
        return noisy + [x0]

    def points(self, noisy, ind, u):
        """The rollout's sample at segment ``ind`` from the end, its time, the
        segment's start and a time drawn above it, truncated like the
        program's integer cast of an f32 product."""
        m = self.mix
        delta = m["total_steps"] // m["k_step"]
        t_g = ind * delta - 1
        t_mid = t_g - delta + 1
        t = t_mid + int((u.float() * torch.tensor(float(m["t_max"] - t_mid),
                                                  device=u.device)).to(torch.long))
        return noisy[::-1][ind], t_g, t_mid, t

    def renoised(self, x0, eps, xi, xi2, t_mid, t):
        m = self.mix
        add = m["eta"] * eps + math.sqrt(max(1.0 - m["eta"] ** 2, 0.0)) * xi
        return self.diff.renoise(self.diff.add_noise(x0, add, t_mid), xi2, t_mid, t)

    def train_step(self) -> dict:
        """One step; returns its losses, whether the fake update was rolled
        back, and each adapter's gradient norms a leaf (as Adam got them)."""
        m, diff, dev = self.mix, self.diff, self.dev
        d = step_draws(self.root, self.step, self.shape, self.c, m["k_step"], dev)
        text, uncond = d["text"], torch.zeros_like(d["text"])
        noisy = self.rollout(d)

        ind, u, xi, xi2 = d["fake"]
        lat, t_g, t_mid, t = self.points(noisy, ind, u)
        with torch.no_grad():
            m_lat = self.x0(self.merged(self.lora["g"]), lat, t_g, text, d["student"])
            noisy_t = self.renoised(m_lat, diff.pred_eps(m_lat, lat, t_g), xi, xi2, t_mid, t)
            wt = 1.0 / max(diff.sigma_at(t) ** 2, 1e-8)
            x0_real = (self.x0(self.w, noisy_t, t, text, d["teacher"])
                       if m["lambda_reg"] > 0 else None)
        leaves = [p.detach().requires_grad_(True) for p in self.lora["f"]]
        x0_f = self.x0(self.merged(leaves), noisy_t, t, text, d["teacher"])
        loss_f = torch.mean(wt * (x0_f - m_lat) ** 2)
        if x0_real is not None:
            loss_f = loss_f + m["lambda_reg"] * torch.mean(wt * (x0_f - x0_real) ** 2)
        grads_f = torch.autograd.grad(loss_f, leaves)
        del x0_f, leaves
        loss_fake = float(loss_f.detach())
        skipped = m["fake_loss_skip"] is not None and not loss_fake < m["fake_loss_skip"]
        if not skipped:
            self.lora["f"], self.opt["f"] = self.adam("f", grads_f, m["learning_rate_fake"])
        norms = {"f": [float(g.norm()) for g in grads_f]}

        ind, u, xi, xi2 = d["gen"]
        lat, t_g, t_mid, t2 = self.points(noisy, ind, u)
        leaves = [p.detach().requires_grad_(True) for p in self.lora["g"]]
        ml = self.x0(self.merged(leaves), lat, t_g, text, d["generator"])
        with torch.no_grad():
            mld = ml.detach()
            noisy_t2 = self.renoised(mld, diff.pred_eps(mld, lat, t_g), xi, xi2, t_mid, t2)
            real = self.x0(self.w, noisy_t2, t2, text, d["teacher"], guidance=m["cfg"],
                           uncond=uncond)
            fake = self.x0(self.merged(self.lora["f"]), noisy_t2, t2, text, d["teacher"])
            revised = mld + real - fake
        c = 1e-3 / (128.0 * math.sqrt(float(np.prod(self.shape[1:]))))
        huber = torch.sqrt((ml - revised) ** 2 + c ** 2) - c
        if m["weighting_factor"]:
            huber = huber / torch.clamp(torch.mean(torch.abs(mld - real)), max=5.0)
        loss_g = torch.mean(huber)
        grads_g = torch.autograd.grad(loss_g, leaves)
        del ml, leaves, huber
        self.lora["g"], self.opt["g"] = self.adam("g", grads_g, m["learning_rate_g"])
        norms["g"] = [float(g.norm()) for g in grads_g]
        self.step += 1
        return {"loss_fake": loss_fake, "loss_du": float(loss_g.detach()), "fake_skipped": skipped,
                "grad_norms": norms}


def state_norms(opt: dict, b2: float) -> List[float]:
    """Each leaf's norm of the gradient Adam took in its first update, from
    its second moment after one update (``nu = (1 - b2) g^2``); zeros where
    no update was applied."""
    if not opt["count"]:
        return [0.0 for _ in opt["nu"]]
    return [math.sqrt(float(v.double().sum()) / (1.0 - b2)) for v in opt["nu"]]


def follow(family, c: dict, mix: dict, *, seed: int, steps: int, device,
           prec=R.TRAIN_REFERENCE) -> dict:
    """The readings of the first ``steps`` steps of a run seeded ``seed``:
    each step's losses and whether its fake update was rolled back, the
    first gradient's norm a leaf from Adam's state after one step, the
    gradient norms of every step, and the change of every leaf over the
    ``steps``."""
    with R.tf32_products():
        tr = Trainer(family, c, mix, seed, device, prec)
        start = {k: [p.clone() for p in v] for k, v in tr.lora.items()}
        out = {"losses": [], "fake_skipped": [], "step_grad_norms": []}
        for s in range(steps):
            rec = tr.train_step()
            out["losses"].append([rec["loss_fake"], rec["loss_du"]])
            out["fake_skipped"].append(rec["fake_skipped"])
            out["step_grad_norms"].append(rec["grad_norms"])
            if s == 0:
                out["first_grad_norms"] = {k: state_norms(tr.opt[k], mix["adam_beta2"])
                                           for k in tr.opt}
        out["change_norms"] = {k: [float((p - p0).norm()) for p, p0 in zip(tr.lora[k], start[k])]
                               for k in tr.lora}
    return out


# -- the gaps ---------------------------------------------------------------------

def _worst_leaf(got: List[float], want: List[float], keep: List[bool]) -> float:
    """The largest gap ``|got - want|`` over the kept leaves, each over the
    larger of its own ``want`` and the kept leaves' median ``want``."""
    kept = [w for w, k in zip(want, keep) if k]
    if not kept:
        return 0.0
    med = statistics.median(kept)
    gaps = [abs(g - w) / max(w, med) if max(w, med) > 0 else (0.0 if g == 0 else math.inf)
            for g, w, k in zip(got, want, keep) if k]
    return max(gaps)


def _moving(norms: List[float]) -> List[bool]:
    """Leaves whose gradient is not nought to rounding: at least a thousandth
    of the median leaf's."""
    med = statistics.median(norms)
    return [n > 1e-3 * med for n in norms]


def gaps(got: dict, want: dict) -> Dict[str, float]:
    """The numbers compared, between a program's (or the control's) readings
    ``got`` and the reference's ``want``:

    - ``loss_rel_err``: the largest relative gap of a step's fake or
      generator loss;
    - ``grad_norm_gap``: the worst leaf's gap of the first gradient's norm
      (from Adam's state after one step), over the leaves whose reference
      gradient is not nought to rounding;
    - ``change_norm_gap``: the worst leaf's gap of its change over the steps
      followed, over the leaves whose reference gradient was not nought to
      rounding in some step;
    - ``change_median_gap``: the gap of the median of those leaves' changes,
      over the reference's median.
    """
    loss = max(abs(g - w) / max(abs(w), 1e-30)
               for gs, ws in zip(got["losses"], want["losses"]) for g, w in zip(gs, ws))
    grad = change = median = 0.0
    for k in ("g", "f"):
        first = want["first_grad_norms"][k]
        grad = max(grad, _worst_leaf(got["first_grad_norms"][k], first, _moving(first)))
        keep = [any(step) for step in zip(*(_moving(s[k]) for s in want["step_grad_norms"]))]
        change = max(change, _worst_leaf(got["change_norms"][k], want["change_norms"][k], keep))
        kept = [(g, w) for g, w, on in zip(got["change_norms"][k], want["change_norms"][k], keep)
                if on]
        if kept:
            mg, mw = (statistics.median(x) for x in zip(*kept))
            median = max(median, abs(mg - mw) / mw if mw > 0 else (0.0 if mg == 0 else math.inf))
    return {"loss_rel_err": loss, "grad_norm_gap": grad, "change_norm_gap": change,
            "change_median_gap": median}


def check_tdm(family, c: dict, mix: dict, *, seed: int, steps: int, program: dict, device,
              control: bool = False) -> dict:
    """The gaps of the program's readings of its first ``steps`` steps to
    the reference's; with ``control``, also ``control.<name>``: the control
    (``common.TRAIN_CONTROL``) put in the program's place."""
    want = follow(family, c, mix, seed=seed, steps=steps, device=device)
    out = gaps(program, want)
    out["fake_updates"] = float(steps - sum(want["fake_skipped"]))
    if control:
        ctl = follow(family, c, mix, seed=seed, steps=steps, device=device,
                     prec=R.TRAIN_CONTROL)
        out.update({f"control.{k}": v for k, v in gaps(ctl, want).items()})
    return out
