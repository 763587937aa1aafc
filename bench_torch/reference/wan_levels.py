"""Plain reference of the Wan2.1 text-to-video family on ASA's multilevel
lane at a size the dense form cannot check within a run (Wan2.1-T2V-14B at
720p: 75,600 tokens in 591 key blocks).

The same functions as ``reference/wan.py`` with ``common.asa_multilevel``
as self-attention, computed another way where the size asks it:

- self-attention gathers, for each mask row, the full-resolution keys of
  its level-1 blocks and the L-token means of its level-L blocks (L in 2, 4,
  8), each pooled score raised by ``log L``, into one key matrix, and takes
  one softmax over it: ``common.asa_multilevel``'s function over about
  12,000 keys a row instead of every level's 141,750;
- the predictor's scores are formed a group of heads at a time (the same
  draws, in the same order, as ``common.block_scores``);
- a weight the configuration serves in bf16 is held in bf16 storage and
  cast to f32 where it is used: the same values as ``wan.dit_weights``'
  f32 copies, at half the memory (14.3 B parameters).

Everything else is ``reference/wan.py``'s: the weight draws' order, the VAE
and its decode, the sampler, the FLOP counts.  Plain PyTorch in f32 (TF32
off in ``check_t2v``), importing nothing of the program.
"""

from __future__ import annotations

import gc
import math
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.reference import common as R
from bench_torch.reference import wan as W
from bench_torch.reference.wan import (  # noqa: F401  (the family's interface)
    backward_flops,
    dense_flops,
    latent_shape,
    vae_decode,
    vae_weights,
)

BLOCK = R.BLOCK
LEVELS = (1, 2, 4, 8)
# About this many bytes of f32 scores, gathered keys and values at once.
_WORK_BYTES = 2 << 30
# The rank bands of a preset that names none: BLADE's published multilevel
# bands (level 0 skips the rest).
PUBLISHED_RATIOS = {1: (0.0, 0.05), 2: (0.05, 0.15), 4: (0.15, 0.25), 8: (0.25, 0.5),
                    0: (0.5, 1.0)}


def check_preset(config: dict, preset) -> None:
    """``wan.check_preset``, and the multilevel lane's settings: the lane,
    ``q_rows`` (the per-level lane takes 128 alone) and the rank bands."""
    W.check_preset(config, preset)
    asa = config["asa"]
    ratios = preset.asa_mask_ratios or PUBLISHED_RATIOS
    got = {"lane": "multilevel", "q_rows": preset.asa_multilevel_q_rows,
           "mask_ratios": {int(lv): [float(x) for x in b] for lv, b in ratios.items()}}
    want = {"lane": asa["lane"], "q_rows": asa["q_rows"],
            "mask_ratios": {int(lv): [float(x) for x in b]
                            for lv, b in asa["mask_ratios"].items()}}
    bad = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    if bad:
        raise ValueError(f"preset {config['preset']} differs from the configuration: {bad}")


# -- weights ------------------------------------------------------------------

def dit_weights(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``wan.dit_weights``' draws, in its order; a weight served in the
    configuration's ``dtype`` is kept in that dtype (its values exactly),
    the others in f32."""
    gen = R.generator(R.fold_seed(seed, 1), device)
    d, f = c["dim"], c["ffn_dim"]
    p = list(c["patch_size"])
    dtype = getattr(torch, c["dtype"])
    w = {}

    def draw(name, shape, served=True):
        t = R.lecun_draw(shape, gen, device)
        w[name] = t.to(dtype) if served else t

    draw("patch", [d, c["in_channels"]] + p)
    draw("txt1", [d, c["text_dim"]])
    draw("txt2", [d, d])
    draw("t1", [d, c["freq_dim"]], False)
    draw("t2", [d, d], False)
    draw("tproj", [6 * d, d], False)
    for i in range(c["num_layers"]):
        for part in ("self", "cross"):
            for m in ("q", "k", "v", "o"):
                draw(f"{i}.{part}.{m}", [d, d])
        draw(f"{i}.ffn0", [f, d])
        draw(f"{i}.ffn2", [d, f])
    draw("out", [int(np.prod(p)) * c["out_channels"], d], False)
    for i in range(c["num_layers"]):
        w[f"{i}.sst"] = torch.empty((1, 6, d), device=device).normal_(0.0, 0.02, generator=gen)[0]
    w["sst"] = torch.empty((1, 2, d), device=device).normal_(0.0, 0.02, generator=gen)[0]
    return w


# -- ASA, multilevel lane, gathered --------------------------------------------

def block_scores(q, k, tokens: int, gen: torch.Generator) -> torch.Tensor:
    """``common.block_scores``: the same offsets drawn in the same order,
    the sampled softmax formed a group of heads at a time."""
    h, _, d = q.shape
    qp, kp = R._edge_pad(q, BLOCK), R._edge_pad(k, BLOCK)
    nq, nk = qp.shape[1] // BLOCK, kp.shape[1] // BLOCK

    def sample(x, n):
        offs = torch.rand((1, h, BLOCK), generator=gen, device=gen.device).topk(tokens).indices[0]
        idx = offs[:, None, :, None].expand(h, n, tokens, d)
        return torch.gather(x.reshape(h, n, BLOCK, d), 2, idx).reshape(h, n * tokens, d)

    q_s, k_s = sample(qp, nq), sample(kp, nk)
    step = max(1, _WORK_BYTES // (8 * nq * tokens * nk * tokens))
    out = []
    for g in range(0, h, step):
        p = torch.softmax((q_s[g:g + step] @ k_s[g:g + step].transpose(1, 2)) / math.sqrt(d),
                          dim=-1)
        mass = p.reshape(-1, nq * tokens, nk, tokens).sum(-1)
        out.append(mass.reshape(-1, nq, tokens, nk).mean(2))
    return torch.cat(out)


def level_tables(k, v):
    """Per level L: ``(L, keys a block, K table, V table, live keys)``, the
    tables ``[H n_k, 128/L x d]`` (a row a key block of a head: its keys, or
    the L-token means of the edge-padded keys), ``live [n_k, 128/L]`` false
    past ``Lk`` (level 1) or ``ceil(Lk / L)`` pooled keys."""
    h, lk, d = k.shape
    kp, vp = R._edge_pad(k, BLOCK), R._edge_pad(v, BLOCK)
    nk = kp.shape[1] // BLOCK
    out = []
    for lv in LEVELS:
        seg = BLOCK // lv
        kl, vl = (t if lv == 1 else t.reshape(h, -1, lv, d).mean(2) for t in (kp, vp))
        live = (torch.arange(nk * seg, device=k.device) < -(-lk // lv)).reshape(nk, seg)
        out.append((lv, seg, kl.reshape(h * nk, seg * d), vl.reshape(h * nk, seg * d), live))
    return out


def _chunks(widths, per_key: int):
    """Consecutive runs of rows (ordered by width) whose widest row times
    their number stays near ``_WORK_BYTES`` of ``per_key`` bytes a key."""
    start, n = 0, len(widths)
    while start < n:
        end = start + 1
        while end < n and (end + 1 - start) * widths[end] * per_key <= _WORK_BYTES:
            end += 1
        yield start, end
        start = end


def gathered_levels(q, k, v, levels) -> torch.Tensor:
    """Softmax attention of ``q [H, Lq, d]`` over the keys ``levels [H, n_q,
    n_k]`` (128-row mask rows) gives each row: the full-resolution keys of
    its level-1 blocks and the ``L``-token means of its level-``L`` blocks,
    scores raised by ``log L``, in one softmax; the keys are gathered, a run
    of mask rows at a time, into one matrix."""
    h, lq, d = q.shape
    nq, nk = levels.shape[-2:]
    scale = 1.0 / math.sqrt(d)
    tables = level_tables(k, v)
    qb = F.pad(q, (0, 0, 0, nq * BLOCK - lq)).reshape(h * nq, BLOCK, d)
    flat = levels.reshape(h * nq, nk)
    base = (torch.arange(h * nq, device=q.device) // nq * nk)[:, None]
    sel = [flat == lv for lv in LEVELS]
    counts = torch.stack([s.sum(-1) for s in sel], -1)  # [H n_q, 4]
    orders = [torch.argsort((~s).to(torch.uint8), dim=-1, stable=True) for s in sel]
    segs = torch.tensor([BLOCK // lv for lv in LEVELS], device=q.device)
    width = (counts * segs).sum(-1)
    by_width = torch.argsort(width, stable=True)
    widths = width[by_width].tolist()
    out = torch.empty_like(qb)
    for a, b in _chunks(widths, 4 * (2 * d + 2 * BLOCK)):
        rows = by_width[a:b]
        cnt = counts[rows]
        caps = cnt.amax(0).tolist()
        ks, vs, bias = [], [], []
        for li, (lv, seg, ktab, vtab, live) in enumerate(tables):
            cap = caps[li]
            if not cap:
                continue
            idx = orders[li][rows, :cap]
            at = (base[rows] + idx).reshape(-1)
            ks.append(ktab.index_select(0, at).reshape(len(rows), cap * seg, d))
            vs.append(vtab.index_select(0, at).reshape(len(rows), cap * seg, d))
            ok = (torch.arange(cap, device=q.device) < cnt[:, li, None])[..., None] & live[idx]
            bias.append(torch.where(ok, math.log(lv), float("-inf")).reshape(len(rows), -1))
        s = torch.bmm(qb[rows], torch.cat(ks, 1).transpose(1, 2)).mul_(scale)
        s.add_(torch.cat(bias, 1)[:, None, :])
        out[rows] = torch.bmm(torch.softmax(s, dim=-1), torch.cat(vs, 1))
    return out.reshape(h, nq * BLOCK, d)[:, :lq]


def asa_levels(q, k, v, asa: dict, gen: torch.Generator):
    """``common.asa_multilevel`` over arranged ``[H, L, d]``, the keys
    gathered (:func:`gathered_levels`).  Returns ``(out, levels)``."""
    if asa["q_rows"] != BLOCK:
        raise ValueError("the gathered multilevel lane takes 128-row mask rows")
    ratios = {int(lv): band for lv, band in asa["mask_ratios"].items()}
    levels = R.level_mask(block_scores(q, k, asa["sample_tokens"], gen), ratios)
    return gathered_levels(q, k, v, levels), levels


# -- the DiT ------------------------------------------------------------------

def dit_forward(w, c: dict, latents, t: float, text, step_seed: int,
                prec=R.REFERENCE) -> torch.Tensor:
    """``wan.dit_forward`` with :func:`asa_levels` as self-attention and
    each weight cast to f32 where it is used."""
    dev = latents.device
    d, h, eps = c["dim"], c["num_heads"], c["eps"]
    hd = d // h
    _, ch, tt, hh, ww = latents.shape
    pt, ph, pw = c["patch_size"]
    gt, gh, gw = tt // pt, hh // ph, ww // pw

    def mm(x, name):
        return prec.mm(x, w[name].float())

    x = latents.float().reshape(ch, gt, pt, gh, ph, gw, pw).permute(1, 3, 5, 0, 2, 4, 6)
    x = prec.mm(x.reshape(gt * gh * gw, -1), w["patch"].float().reshape(d, -1))
    ctx = mm(R.gelu_tanh(mm(text[0].float(), "txt1")), "txt2")
    temb = R.timestep_features(torch.tensor([t], device=dev), c["freq_dim"])
    temb = prec.mm32(F.silu(prec.mm32(temb, w["t1"])), w["t2"])
    temb6 = prec.mm32(F.silu(temb), w["tproj"]).reshape(6, d)
    perm = torch.from_numpy(R.gilbert_order(gw, gh, gt)).to(dev)
    cos, sin = (torch.from_numpy(a).to(dev)[perm] for a in R.rope_tables(hd, (gt, gh, gw)))
    x = x[perm]
    heads = W._heads

    for i in range(c["num_layers"]):
        e = w[f"{i}.sst"] + temb6
        n = R.layer_norm(x, eps) * (1 + e[1]) + e[0]
        q = R.rotate_half(heads(R.rms_norm(mm(n, f"{i}.self.q"), eps), h), cos, sin)
        k = R.rotate_half(heads(R.rms_norm(mm(n, f"{i}.self.k"), eps), h), cos, sin)
        v = heads(mm(n, f"{i}.self.v"), h)
        del n
        gen = R.generator(R.fold_seed(step_seed, i), dev)
        o, _ = asa_levels(prec.low(q), prec.low(k), prec.low(v), c["asa"], gen)
        del q, k, v
        x = x + e[2] * mm(o.transpose(0, 1).reshape(-1, d), f"{i}.self.o")
        del o
        n = R.layer_norm(x, eps)
        q = heads(R.rms_norm(mm(n, f"{i}.cross.q"), eps), h)
        k = heads(R.rms_norm(mm(ctx, f"{i}.cross.k"), eps), h)
        v = heads(mm(ctx, f"{i}.cross.v"), h)
        o = R.masked_attention(prec.low(q), prec.low(k), prec.low(v))
        x = x + mm(o.transpose(0, 1).reshape(-1, d), f"{i}.cross.o")
        del q, o
        n = R.layer_norm(x, eps) * (1 + e[4]) + e[3]
        x = x + e[5] * mm(R.gelu_tanh(mm(n, f"{i}.ffn0")), f"{i}.ffn2")
        del n
    e = w["sst"] + temb
    out = prec.mm32(R.layer_norm(x, eps) * (1 + e[1]) + e[0], w["out"])
    out = out[torch.argsort(perm)]
    out = out.reshape(gt, gh, gw, pt, ph, pw, c["out_channels"]).permute(6, 0, 3, 1, 4, 2, 5)
    return out.reshape(1, c["out_channels"], tt, hh, ww)


def check_t2v(c: dict, traffic: dict, *, velocities, **kw) -> dict:
    """``common.t2v_gaps`` of a served clip under flow UniPC, this module as
    the family.  What the freed program still holds in reference cycles is
    collected first, so its memory is the reference's."""
    if traffic.get("mask_mode") != c["asa"]["lane"]:
        raise ValueError(f"mix lane {traffic.get('mask_mode')!r} is not the configuration's "
                         f"{c['asa']['lane']!r}")
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    n = int(traffic["num_steps"])
    return R.t2v_gaps(
        sys.modules[__name__], c, velocities=velocities,
        timesteps=R.unipc_schedule(n, c["flow_shift"])[1],
        trajectory=lambda noise, state: R.unipc_trajectory(noise, velocities, n,
                                                           c["flow_shift"], state), **kw)
