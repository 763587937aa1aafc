"""Parts of the plain references that every family shares: the program's
random-number protocol, the gilbert token order, ASA's energy lane, the
flow UniPC sampler, and the precisions a reference computes in.

Plain PyTorch in f32 (TF32 off), written from the published descriptions
(ASA: the BLADE paper and its reference code; UniPC: diffusers'
``UniPCMultistepScheduler`` with flow sigmas), importing nothing of the
program.  Attention is computed densely, a block of query rows at a time,
with the mask applied to the scores, so no kernel's tiling is repeated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

_MASK64 = (1 << 64) - 1


# -- the program's random-number protocol (its ``utils/rng.py``) ------------

def fold_seed(seed: int, data: int) -> int:
    """splitmix64 finaliser of ``seed`` and ``data`` (a 63-bit seed): how the
    program derives the generator of a step, a layer and a draw."""
    x = (int(seed) ^ ((int(data) + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def lecun_draw(shape, gen: torch.Generator, device) -> torch.Tensor:
    """flax's default kernel init, ``N(0, 1 / fan_in)``, drawn in f32."""
    fan_in = int(np.prod(shape[1:]))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)


# -- precisions -------------------------------------------------------------

def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448), back in f32; where ``t`` takes a gradient, the
    gradient passes the rounding unchanged."""
    with torch.no_grad():
        s = t.abs().amax().float().clamp_min(1e-30) / 448.0
        low = (t / s).to(torch.float8_e4m3fn).float() * s
    return t + (low - t).detach() if t.requires_grad else low


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


@dataclasses.dataclass(frozen=True)
class Precision:
    """How a reference computes.  ``low`` maps the inputs of every product
    the configuration computes in bf16 (f32 or fp8); ``state`` rounds the
    sampler's state; ``vae`` is the decoder's compute dtype.  ``train``:
    the forward is differentiated (each DiT block and each head's attention
    recomputed in the backward), runs under :func:`tf32_products`, and
    computes the products the configuration states in f32 in f64."""

    low: Callable[[torch.Tensor], torch.Tensor]
    state: Callable[[torch.Tensor], torch.Tensor]
    vae: torch.dtype
    train: bool = False

    def mm(self, x, w):
        """``x @ w.T`` of a layer the configuration computes in bf16."""
        return self.low(x) @ self.low(w).t()

    def mm32(self, x, w):
        """``x @ w.T`` of a layer the configuration computes in f32."""
        if self.train:
            return (x.double() @ w.double().t()).float()
        return x @ w.t()

    def block(self, fn, *args):
        """``fn(*args)``; recomputed in the backward when training."""
        if self.train:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)


REFERENCE = Precision(lambda t: t, lambda t: t, torch.float32)
# The control: the step below each stated precision (bf16 -> fp8 products,
# f32 sampler state -> bf16, f32 VAE -> bf16).
CONTROL = Precision(fp8, bf16, torch.bfloat16)
# The same two for a training step (``reference/tdm.py``).
TRAIN_REFERENCE = dataclasses.replace(REFERENCE, train=True)
TRAIN_CONTROL = dataclasses.replace(CONTROL, train=True)


@contextlib.contextmanager
def tf32_products():
    """TF32 tensor-core products inside (10-bit mantissas of f32 inputs,
    f32 sums): finer than the bf16 products the configuration states, and
    fast enough that a reference follows whole training steps.  The flags
    are put back on the way out."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@contextlib.contextmanager
def strict_f32():
    """No TF32 inside: f32 products run in f32.  The flags are global, so
    they are put back on the way out (a program run after a reference in
    one process keeps its own precision)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# -- norms, activations, rotary ---------------------------------------------

def layer_norm(x, eps):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], eps=eps)


def rms_norm(x, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def gelu_tanh(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def timestep_features(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal features ``[cos | sin]`` of ``t [B]`` (``dim`` even)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@functools.lru_cache(maxsize=8)
def rope_tables(head_dim, grid, dims_thw=None):
    """3-D rotary angles ``[T*H*W, head_dim / 2]`` as (cos, sin), theta
    10000, tokens t-major: the half-dims split as ``(c - 2 (c // 3), c // 3,
    c // 3)`` (Wan) or as halves of ``dims_thw`` (CogVideoX)."""
    t_len, h_len, w_len = grid
    c = head_dim // 2
    if dims_thw is None:
        ch = cw = c // 3
        ct = c - 2 * ch
    else:
        ct, ch, cw = (n // 2 for n in dims_thw)

    def axis(n, cdim):
        inv = 1.0 / (10000.0 ** (np.arange(cdim, dtype=np.float64) / cdim))
        return np.outer(np.arange(n, dtype=np.float64), inv)

    ang = np.concatenate([
        np.broadcast_to(axis(t_len, ct)[:, None, None], (t_len, h_len, w_len, ct)),
        np.broadcast_to(axis(h_len, ch)[None, :, None], (t_len, h_len, w_len, ch)),
        np.broadcast_to(axis(w_len, cw)[None, None, :], (t_len, h_len, w_len, cw)),
    ], axis=-1).reshape(t_len * h_len * w_len, c)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rotate_half(x, cos, sin):
    """RoPE on ``x [..., L, d]`` pairing channel ``i`` with ``i + d/2``."""
    half = x.shape[-1] // 2
    re, im = x[..., :half], x[..., half:]
    return torch.cat([re * cos - im * sin, re * sin + im * cos], dim=-1)


# -- gilbert token order ----------------------------------------------------

def _sgn(v):
    return (v > 0) - (v < 0)


@functools.lru_cache(maxsize=8)
def gilbert_order(width: int, height: int, depth: int) -> np.ndarray:
    """Flat indices ``x + width (y + height z)`` in the order the
    generalized Hilbert curve of a ``width x height x depth`` cuboid visits
    them (J. Cerveny's gilbert3d, the order ASA arranges tokens in)."""
    if width >= height and width >= depth:
        job = ((0, 0, 0), (width, 0, 0), (0, height, 0), (0, 0, depth))
    elif height >= width and height >= depth:
        job = ((0, 0, 0), (0, height, 0), (width, 0, 0), (0, 0, depth))
    else:
        job = ((0, 0, 0), (0, 0, depth), (width, 0, 0), (0, height, 0))
    out = []
    stack = [job]

    def add(*us):
        return tuple(sum(t) for t in zip(*us))

    def sub(u, v):
        return tuple(a - b for a, b in zip(u, v))

    def neg(u):
        return tuple(-a for a in u)

    while stack:
        p, a, b, c = stack.pop()
        w, h, d = abs(sum(a)), abs(sum(b)), abs(sum(c))
        da, db, dc = (tuple(_sgn(x) for x in v) for v in (a, b, c))
        if h == 1 and d == 1:
            line, n = da, w
        elif w == 1 and d == 1:
            line, n = db, h
        elif w == 1 and h == 1:
            line, n = dc, d
        else:
            line = None
        if line is not None:
            q = p
            for _ in range(n):
                out.append(q)
                q = add(q, line)
            continue
        a2, b2, c2 = (tuple(x // 2 for x in v) for v in (a, b, c))
        if abs(sum(a2)) % 2 and w > 2:
            a2 = add(a2, da)
        if abs(sum(b2)) % 2 and h > 2:
            b2 = add(b2, db)
        if abs(sum(c2)) % 2 and d > 2:
            c2 = add(c2, dc)
        ra, rb, rc = sub(a, a2), sub(b, b2), sub(c, c2)
        if 2 * w > 3 * h and 2 * w > 3 * d:
            parts = [(p, a2, b, c), (add(p, a2), ra, b, c)]
        elif 3 * h > 4 * d:
            parts = [(p, b2, c, a2), (add(p, b2), a, rb, c),
                     (add(p, sub(a, da), sub(b2, db)), neg(b2), c, neg(ra))]
        elif 3 * d > 4 * h:
            parts = [(p, c2, a2, b), (add(p, c2), a, b, rc),
                     (add(p, sub(a, da), sub(c2, dc)), neg(c2), neg(ra), b)]
        else:
            parts = [(p, b2, c2, a2), (add(p, b2), c, a2, rb),
                     (add(p, sub(b2, db), sub(c, dc)), a, neg(b2), neg(rc)),
                     (add(p, sub(a, da), b2, sub(c, dc)), neg(c), neg(ra), rb),
                     (add(p, sub(a, da), sub(b2, db)), neg(b2), c2, neg(ra))]
        stack.extend(reversed(parts))
    xyz = np.asarray(out, dtype=np.int64)
    if len(xyz) != width * height * depth:
        raise AssertionError("gilbert curve missed cells")
    return xyz[:, 0] + width * (xyz[:, 1] + height * xyz[:, 2])


# -- ASA, energy lane ---------------------------------------------------------

BLOCK = 128


def _edge_pad(x, block):
    """Pad ``x [..., L, d]`` along L to a multiple of ``block`` by
    repeating its last token."""
    rem = x.shape[-2] % block
    if not rem:
        return x
    return torch.cat([x, x[..., -1:, :].expand(*x.shape[:-2], block - rem, x.shape[-1])],
                     dim=-2)


def block_scores(q, k, tokens: int, gen: torch.Generator) -> torch.Tensor:
    """The "sum" predictor: ``[H, n_q, n_k]``, the softmax mass each key
    block takes from ``tokens`` sampled rows of each query block, over
    ``tokens`` sampled keys of every key block, averaged over a block's
    rows.  One set of offsets a head for Q, then one for K (the draws of the
    program's protocol: ``tokens`` largest of 128 uniforms)."""
    h, _, d = q.shape
    qp, kp = _edge_pad(q, BLOCK), _edge_pad(k, BLOCK)
    nq, nk = qp.shape[1] // BLOCK, kp.shape[1] // BLOCK

    def sample(x, n):
        offs = torch.rand((1, h, BLOCK), generator=gen, device=gen.device).topk(tokens).indices[0]
        idx = offs[:, None, :, None].expand(h, n, tokens, d)
        return torch.gather(x.reshape(h, n, BLOCK, d), 2, idx).reshape(h, n * tokens, d)

    q_s, k_s = sample(qp, nq), sample(kp, nk)
    p = torch.softmax((q_s @ k_s.transpose(1, 2)) / math.sqrt(d), dim=-1)
    mass = p.reshape(h, nq * tokens, nk, tokens).sum(-1)
    return mass.reshape(h, nq, tokens, nk).mean(2)


def energy_mask(scores, min_ratio, max_ratio, threshold):
    """Each row keeps its top-ranked key blocks up to the first rank whose
    running mass reaches ``threshold`` of the row's, the count clamped to
    ``[n_k min_ratio, n_k max_ratio]`` (at least 1); ranks are stable
    (ties: lower index first); the last two block rows and columns are on."""
    n_k = scores.shape[-1]
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    cap = max(int(n_k * max_ratio), 1)
    vals = torch.gather(scores, -1, order[..., :cap])
    reached = torch.cumsum(vals, -1) >= threshold * scores.sum(-1, keepdim=True)
    first = torch.where(reached.any(-1), reached.int().argmax(-1),
                        torch.full_like(reached[..., 0], cap, dtype=torch.long))
    count = first.clamp(max(int(n_k * min_ratio), 1), cap)
    keep = torch.arange(n_k, device=scores.device) < count[..., None]
    mask = torch.zeros_like(scores, dtype=torch.bool).scatter(-1, order, keep)
    mask[..., :, -2:] = True
    mask[..., -2:, :] = True
    return mask


def masked_attention(q, k, v, key_allowed: Optional[Callable] = None, extra=None,
                     rows: int = 4096):
    """Softmax attention of ``q [H, Lq, d]`` over ``k, v [H, Lk, d]``, a
    block of ``rows`` query rows at a time.  ``key_allowed(h, r0, r1)``
    gives the ``[r1 - r0, Lk]`` keys a row may see; ``extra = (k2, v2,
    bias)`` adds keys every row sees, their scores raised by ``bias``."""
    h, lq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    for hi in range(h):
        keys, vals = k[hi], v[hi]
        if extra is not None:
            keys, vals = torch.cat([keys, extra[0][hi]]), torch.cat([vals, extra[1][hi]])
        for r0 in range(0, lq, rows):
            r1 = min(r0 + rows, lq)
            s = (q[hi, r0:r1] @ keys.t()) * scale
            if extra is not None:
                s[:, k.shape[1]:] += extra[2]
            if key_allowed is not None:
                s[:, :k.shape[1]].masked_fill_(~key_allowed(hi, r0, r1), float("-inf"))
            out[hi, r0:r1] = torch.softmax(s, dim=-1) @ vals
    return out


def asa_energy(q, k, v, asa: dict, gen: torch.Generator):
    """ASA on the energy lane over arranged ``[H, L, d]``: the predictor's
    mask (``block_scores``, ``energy_mask``) selects full-resolution key
    blocks; every row also sees the ``sample_gap``-mean-pooled keys with
    their scores raised by ``log(sample_gap)``; one softmax over both.
    Returns ``(out, mask)``."""
    _, lq, _ = q.shape
    lk = k.shape[1]
    mask = energy_mask(block_scores(q, k, asa["sample_tokens"], gen),
                       asa["min_retain_ratio"], asa["max_retain_ratio"],
                       asa["energy_threshold"])
    gap = asa["sample_gap"]
    kp = _edge_pad(k, gap).reshape(k.shape[0], -1, gap, k.shape[2]).mean(2)
    vp = _edge_pad(v, gap).reshape(v.shape[0], -1, gap, v.shape[2]).mean(2)
    key_block = torch.arange(lk, device=q.device) // BLOCK

    def allowed(hi, r0, r1):
        row_block = torch.arange(r0, r1, device=q.device) // BLOCK
        return mask[hi][row_block][:, key_block]

    out = masked_attention(q, k, v, allowed, extra=(kp, vp, math.log(gap)))
    return out, mask


def _row_groups(mask):
    """Rows of ``mask [h, n_q, n_k]`` in two groups, those that select at
    most half the key blocks in every head and the rest, each with its
    widest selection ``cap``, every row's selected blocks first in ``idx
    [h, m, cap]`` and which of them are live."""
    nk = mask.shape[-1]
    count = mask.sum(-1)
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    wide = (count > nk // 2).any(0)
    for rows in (torch.nonzero(~wide).flatten(), torch.nonzero(wide).flatten()):
        if rows.numel():
            cap = int(count[:, rows].max())
            live = torch.arange(cap, device=mask.device) < count[:, rows, None]
            yield rows, order[:, rows, :cap], live


def _gathered(q, k, v, kp, vp, mask, bias: float, grad=None, lse=True):
    """The energy lane's attention of heads ``q [h, Lq, d]`` over ``k, v
    [h, Lk, d]``: each 128-row block of queries sees the full-resolution key
    blocks its row of ``mask [h, n_q, n_k]`` selects and every pooled key
    of ``kp, vp [h, Lp, d]``, its score raised by ``bias``; one softmax over
    both.  A group of rows gathers its blocks and the pooled keys (in
    blocks of 128 behind the full-resolution ones) into one key matrix.
    Returns ``(out, lse)`` (``lse`` None where ``lse`` is false: no
    gradient will be asked for); with ``grad = (d_out, out, lse)`` the
    scores are computed again and ``(dq, dk, dv, dkp, dvp)`` returned."""
    h, lq, d = q.shape
    lk, lp = k.shape[1], kp.shape[1]
    nq, nk = mask.shape[-2:]
    npb = -(-lp // BLOCK)
    pad = torch.nn.functional.pad

    def blocks(t, n):
        return pad(t, (0, 0, 0, n * BLOCK - t.shape[1])).reshape(h, n, BLOCK, d)

    def table(full, pooled):  # [h (nk + npb), BLOCK d]: a row a block
        return torch.cat([blocks(full, nk), blocks(pooled, npb)], 1).reshape(-1, BLOCK * d)

    qb = blocks(q, nq) * (1.0 / math.sqrt(d))
    ktab, vtab = table(k, kp), table(v, vp)
    dev = q.device
    key_ok = (torch.arange(nk * BLOCK, device=dev) < lk).reshape(nk, BLOCK)
    pool_bias = torch.full((npb * BLOCK,), float("-inf"), device=dev)
    pool_bias[:lp] = bias
    heads = torch.arange(h, device=dev)[:, None, None] * (nk + npb)
    if grad is None:
        out, lse = q.new_zeros(h, nq, BLOCK, d), q.new_zeros(h, nq, BLOCK, 1) if lse else None
    else:
        dob, ob, lse = blocks(grad[0], nq), blocks(grad[1], nq), grad[2]
        dq, dk, dv = torch.zeros_like(qb), torch.zeros_like(ktab), torch.zeros_like(vtab)
    for rows, idx, live in _row_groups(mask):
        m, cap = rows.numel(), idx.shape[-1]
        width = (cap + npb) * BLOCK
        pooled = torch.arange(nk, nk + npb, device=dev).expand(h, m, npb)
        flat = (heads + torch.cat([idx, pooled], -1)).reshape(-1)
        kall = ktab.index_select(0, flat).reshape(h, m, width, d)
        vall = vtab.index_select(0, flat).reshape(h, m, width, d)
        col = torch.where(live[..., None] & key_ok[idx], 0.0, float("-inf"))
        col = torch.cat([col.reshape(h, m, cap * BLOCK), pool_bias.expand(h, m, -1)], -1)
        qr = qb[:, rows]
        s = torch.baddbmm(col.reshape(h * m, 1, width), qr.reshape(h * m, BLOCK, d),
                          kall.reshape(h * m, width, d).transpose(1, 2)).reshape(h, m, BLOCK, width)
        if grad is None:
            if lse is None:  # no gradient to come: the softmax alone
                out[:, rows] = torch.matmul(torch.softmax(s, -1), vall)
                continue
            top = torch.logsumexp(s, -1, keepdim=True)
            out[:, rows] = torch.matmul(s.sub_(top).exp_(), vall)
            lse[:, rows] = top
            continue
        p = s.sub_(lse[:, rows]).exp_()
        do = dob[:, rows]
        delta = (do * ob[:, rows]).sum(-1, keepdim=True)
        dv.index_add_(0, flat, torch.matmul(p.transpose(-1, -2), do).reshape(-1, BLOCK * d))
        ds = torch.matmul(do, vall.transpose(-1, -2)).sub_(delta).mul_(p)
        del p
        dq[:, rows] = torch.matmul(ds, kall) * (1.0 / math.sqrt(d))
        dk.index_add_(0, flat, torch.matmul(ds.transpose(-1, -2), qr).reshape(-1, BLOCK * d))
    if grad is None:
        return out.reshape(h, nq * BLOCK, d)[:, :lq], lse
    dk, dv = (t.reshape(h, nk + npb, BLOCK, d) for t in (dk, dv))
    return (dq.reshape(h, nq * BLOCK, d)[:, :lq],
            dk[:, :nk].reshape(h, -1, d)[:, :lk], dv[:, :nk].reshape(h, -1, d)[:, :lk],
            dk[:, nk:].reshape(h, -1, d)[:, :lp], dv[:, nk:].reshape(h, -1, d)[:, :lp])


# Heads the training reference's attention takes at once: about this many
# bytes of f32 scores.
_SCORE_BYTES = 2 << 30


class _GatheredAttention(torch.autograd.Function):
    """:func:`_gathered` a group of heads at a time, differentiable in ``q,
    k, v`` and the pooled keys; the backward computes the scores again from
    the saved ``lse``, so no score matrix outlives its group."""

    @staticmethod
    def forward(ctx, q, k, v, kp, vp, mask, bias):
        nq, nk = mask.shape[-2:]
        count = mask.sum(-1)
        narrow = int(count.masked_fill(count > nk // 2, 0).max()) + -(-kp.shape[1] // BLOCK)
        step = max(1, _SCORE_BYTES // (4 * nq * BLOCK * BLOCK * narrow))
        groups = [slice(i, i + step) for i in range(0, q.shape[0], step)]
        grad = any(ctx.needs_input_grad)
        parts = [_gathered(q[g], k[g], v[g], kp[g], vp[g], mask[g], bias, lse=grad)
                 for g in groups]
        out = torch.cat([o for o, _ in parts])
        if grad:
            ctx.save_for_backward(q, k, v, kp, vp, mask, out, torch.cat([t for _, t in parts]))
        ctx.bias, ctx.groups = bias, groups
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, kp, vp, mask, out, lse = ctx.saved_tensors
        parts = [_gathered(q[g], k[g], v[g], kp[g], vp[g], mask[g], ctx.bias,
                           grad=(d_out[g], out[g], lse[g])) for g in ctx.groups]
        return tuple(torch.cat(t) for t in zip(*parts)) + (None, None)


def asa_energy_grad(q, k, v, asa: dict, gen: torch.Generator):
    """:func:`asa_energy`, differentiable in ``q, k, v`` and with no score
    matrix wider than a row's selection: the same mask (no gradient through
    the predictor), the selected blocks gathered (``_GatheredAttention``).
    Returns ``(out, mask)``."""
    with torch.no_grad():
        mask = energy_mask(block_scores(q.detach(), k.detach(), asa["sample_tokens"], gen),
                           asa["min_retain_ratio"], asa["max_retain_ratio"],
                           asa["energy_threshold"])
    gap = asa["sample_gap"]
    kp = _edge_pad(k, gap).reshape(k.shape[0], -1, gap, k.shape[2]).mean(2)
    vp = _edge_pad(v, gap).reshape(v.shape[0], -1, gap, v.shape[2]).mean(2)
    return _GatheredAttention.apply(q, k, v, kp, vp, mask, math.log(gap)), mask


def dense_attention(q, k, v):
    """Softmax attention of ``q [H, Lq, d]`` over ``k, v [H, Lk, d]``, every
    head and row at once (a short ``Lk``: cross-attention over the text)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def asa_attention(q, k, v, asa: dict, gen: torch.Generator, prec: "Precision"):
    """ASA on the lane ``asa["lane"]`` names; ``(out, mask or levels)``."""
    if asa["lane"] == "multilevel":
        if prec.train:
            raise NotImplementedError("no differentiable multilevel lane in the reference")
        return asa_multilevel(q, k, v, asa, gen)
    return (asa_energy_grad if prec.train else asa_energy)(q, k, v, asa, gen)


# -- flow UniPC (diffusers UniPCMultistepScheduler, flow sigmas) ------------

def unipc_schedule(num_steps: int, shift: float, train_steps: int = 1000):
    """``(sigmas [N + 1], timesteps [N], lambdas [N + 1])``: sigmas on
    ``1 - linspace(1, 1/T, N + 1)``, shifted, flipped, the terminal 0
    appended; ``lambda = log((1 - sigma) / sigma)`` clamped to +-60."""
    alphas = np.linspace(1.0, 1.0 / train_steps, num_steps + 1)
    s = 1.0 - alphas
    s = shift * s / (1.0 + (shift - 1.0) * s)
    s = np.flip(s)[:-1].copy()
    timesteps = (s * train_steps).astype(np.int64)
    sig = np.concatenate([s, [0.0]]).astype(np.float32)
    with np.errstate(divide="ignore"):
        lam = np.log((1.0 - sig) / np.maximum(sig, 1e-30))
    return sig, timesteps, np.clip(lam, -60.0, 60.0).astype(np.float32)


def unipc_trajectory(noise, velocities, num_steps, shift, state=lambda t: t):
    """UniPC of order 2 (bh2, predict-x0, corrector on, lower order at the
    last step) from ``noise`` over the given velocities.  Returns the
    sample before each step and the final one (``num_steps + 1``);
    ``state`` rounds the solver's state after each step."""
    f = np.float32
    sig, _, lam = unipc_schedule(num_steps, shift)

    def phi(h):
        hh = f(-h)
        return hh, f(np.expm1(hh))

    x = noise.float()
    m0 = m1 = last = torch.zeros_like(x)
    xs = [x]
    for i in range(num_steps):
        x0 = x - float(sig[i]) * velocities[i].float()
        xi = x
        if i > 0:  # corrector at sigma[i] from last at sigma[i - 1]
            s0, st = sig[i - 1], sig[i]
            h = f(lam[i] - lam[i - 1])
            hh, hp1 = phi(h)
            a_t = f(1.0) - st
            base = f(st / max(s0, f(1e-30))) * last - f(a_t * hp1) * m0
            d1t = x0 - m0
            if i >= 2:
                r1 = f((lam[i - 2] - lam[i - 1]) / h)
                d10 = (m1 - m0) / float(r1 if r1 != 0 else f(1.0))
                b1 = f((hp1 / hh - f(1.0)) / hp1)
                hp2 = f(hp1 / hh - f(1.0))
                b2 = f((hp2 / hh - f(0.5)) * f(2.0) / hp1)
                det = f(1.0) - r1
                rho0, rho1 = f((b1 - b2) / det), f((b2 - r1 * b1) / det)
                xi = base - f(a_t * hp1) * (float(rho0) * d10 + float(rho1) * d1t)
            else:
                xi = base - f(a_t * hp1) * (0.5 * d1t)
        s0, st = sig[i], sig[i + 1]
        h = f(lam[i + 1] - lam[i])
        _, hp1 = phi(h)
        a_t = f(1.0) - st
        nxt = f(st / max(s0, f(1e-30))) * xi - f(a_t * hp1) * x0
        if 1 <= i < num_steps - 1:  # order 2 predictor
            r1 = f((lam[i - 1] - lam[i]) / h)
            nxt = nxt - f(a_t * hp1) * (0.5 * ((m0 - x0) / float(r1 if r1 != 0 else f(1.0))))
        x, m1, m0, last = state(nxt), state(m0), state(x0), state(xi)
        xs.append(x)
    return xs


# -- ASA, multilevel lane -------------------------------------------------------

def coarsen_rows(scores, rows: int):
    """Mean of every ``rows // 128`` score rows (the last row repeated to a
    whole group): mask rows of ``rows`` queries."""
    g = rows // BLOCK
    if g == 1:
        return scores
    nq = scores.shape[-2]
    if nq % g:
        scores = torch.cat([scores, scores[..., -1:, :].expand(
            *scores.shape[:-2], g - nq % g, scores.shape[-1])], dim=-2)
    return scores.reshape(*scores.shape[:-2], -1, g, scores.shape[-1]).mean(-2)


def level_mask(scores, ratios: dict):
    """Int levels: the key block of descending (stable) rank ``r`` in a row
    gets the level whose band ``[int(n_k lo), int(n_k hi))`` holds ``r``
    (0: skipped); the last two rows and columns are level 1."""
    n_k = scores.shape[-1]
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    ranks = torch.arange(n_k, device=scores.device)
    band = torch.zeros(n_k, dtype=torch.long, device=scores.device)
    for level, (lo, hi) in ratios.items():
        band[(ranks >= int(n_k * lo)) & (ranks < int(n_k * hi))] = int(level)
    levels = torch.empty_like(order).scatter_(-1, order, band.expand(order.shape).contiguous())
    levels[..., :, -2:] = 1
    levels[..., -2:, :] = 1
    return levels


def asa_multilevel(q, k, v, asa: dict, gen: torch.Generator):
    """ASA on the multilevel lane over arranged ``[H, L, d]``: the
    predictor's scores, pooled to mask rows of ``q_rows`` queries, rank each
    row's key blocks into levels; a row sees the full-resolution keys of its
    level-1 blocks and, for level L in 2, 4, 8, the L-token means of its
    level-L blocks with their scores raised by ``log L``; one softmax over
    all of them.  Returns ``(out, levels)``."""
    h, lq, d = q.shape
    lk = k.shape[1]
    ratios = {int(lv): band for lv, band in asa["mask_ratios"].items()}
    levels = level_mask(coarsen_rows(block_scores(q, k, asa["sample_tokens"], gen),
                                     asa["q_rows"]), ratios)
    keys, vals, col_level, col_block, bias = [k], [v], [], [], []
    kp, vp = _edge_pad(k, BLOCK), _edge_pad(v, BLOCK)
    for lv in (2, 4, 8):
        n = -(-lk // lv)
        keys.append(kp.reshape(h, -1, lv, d).mean(2)[:, :n])
        vals.append(vp.reshape(h, -1, lv, d).mean(2)[:, :n])
    for lv, kl in zip((1, 2, 4, 8), keys):
        cols = torch.arange(kl.shape[1], device=q.device)
        col_level.append(torch.full_like(cols, lv))
        col_block.append(cols // (BLOCK // lv))
        bias.append(torch.full(cols.shape, math.log(lv), device=q.device))
    col_level, col_block = torch.cat(col_level), torch.cat(col_block)
    bias = torch.cat(bias)
    kall, vall = torch.cat(keys, dim=1), torch.cat(vals, dim=1)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    rows = 4096
    for hi in range(h):
        for r0 in range(0, lq, rows):
            r1 = min(r0 + rows, lq)
            mrow = torch.arange(r0, r1, device=q.device) // asa["q_rows"]
            ok = levels[hi][mrow][:, col_block] == col_level
            s = (q[hi, r0:r1] @ kall[hi].t()) * scale + bias
            s.masked_fill_(~ok, float("-inf"))
            out[hi, r0:r1] = torch.softmax(s, dim=-1) @ vall[hi]
    return out, levels


# -- DDPM tables and SDE-DPM-Solver++(2M) (CogVideoXDPMScheduler) -------------

def ddpm_tables(s: dict):
    """``(alpha, sigma)`` per training timestep: scaled-linear betas, the
    SNR shift, the zero-terminal-SNR rescale (f32)."""
    n = s["num_train_timesteps"]
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, n) ** 2
    ac = np.cumprod(1.0 - betas)
    shift = s["snr_shift_scale"]
    if shift != 1.0:
        ac = ac / (shift + (1 - shift) * ac)
    if s["rescale_betas_zero_snr"]:
        a = np.sqrt(ac)
        a0, at = a[0], a[-1]
        ac = np.clip(((a - at) * a0 / (a0 - at)) ** 2, 1e-12, 1.0)
    ac = ac.astype(np.float32)
    return np.sqrt(ac).astype(np.float32), np.sqrt(1.0 - ac).astype(np.float32)


def dpm_schedule(s: dict, num_steps: int):
    """``(timesteps, alpha [N + 1], sigma [N + 1], lambdas [N + 1])`` on the
    trailing spacing, the terminal (1, 0) appended."""
    n = s["num_train_timesteps"]
    ts = (np.round(np.arange(n, 0, -n / num_steps)).astype(np.int64) - 1)[:num_steps]
    alpha, sigma = ddpm_tables(s)
    a = np.concatenate([alpha[ts], [1.0]]).astype(np.float32)
    sg = np.concatenate([sigma[ts], [0.0]]).astype(np.float32)
    lam = np.clip(np.log(np.maximum(a, 1e-30) / np.maximum(sg, 1e-30)), -60, 60)
    return ts, a, sg, lam.astype(np.float32)


def dpm_trajectory(noise, velocities, xis, s: dict, num_steps: int, state=lambda t: t):
    """SDE-DPM-Solver++(2M) of v-predictions from ``noise`` over the given
    velocities and step noises: the sample before each step and the final
    one (``num_steps + 1``)."""
    f = np.float32
    _, a, sg, lam = dpm_schedule(s, num_steps)
    x = noise.float()
    m0 = torch.zeros_like(x)
    xs = [x]
    for i in range(num_steps):
        x0 = float(a[i]) * x - float(sg[i]) * velocities[i].float()
        h = f(lam[i + 1] - lam[i])
        if 0 < i < num_steps - 1:
            r = f(f(lam[i] - lam[i - 1]) / (h if h != 0 else f(1.0)))
            inv2r = f(f(1.0) / (f(2.0) * r))
            dd = float(f(1.0) + inv2r) * x0 - float(inv2r) * m0
        else:
            dd = x0
        exp_h = np.exp(-h, dtype=f)
        mult1 = f(sg[i + 1] / max(sg[i], f(1e-30))) * exp_h
        mult2 = np.expm1(f(-2.0) * h, dtype=f) * a[i + 1]
        noise_mult = sg[i + 1] * np.sqrt(max(f(1.0) - exp_h * exp_h, f(0.0)), dtype=f)
        x = state(float(mult1) * x - float(mult2) * dd + float(noise_mult) * xis[i])
        m0 = state(x0)
        xs.append(x)
    return xs


# -- the gaps of a served clip ---------------------------------------------------

def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _uint8(frames):
    return ((frames + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)[0].float()


@torch.no_grad()
@strict_f32()
def t2v_gaps(family, c: dict, *, trajectory, timesteps, weight_seed: int, request_seed: int,
             text, velocities, latents, frames, steps, device, control: bool = False) -> dict:
    """The gaps between a served clip and the reference of ``family`` (a
    module with ``dit_weights``, ``dit_forward``, ``vae_weights``,
    ``vae_decode``):

    - ``latents_rel_err``: the served final latents against the reference
      sampler, ``trajectory(noise, state)``, run from the clip's own noise
      over the served velocities (relative L2);
    - ``velocity_rel_err``: the largest, over the sampled ``steps``, of the
      served velocity against the reference DiT's at that step of the
      trajectory (relative L2);
    - ``frames_mae``: the mean absolute difference, in uint8 levels, of the
      served frames and the reference decode of the served latents.

    With ``control``, also ``control.<name>``: the same gaps of the control
    (``CONTROL``, the reference a precision lower) put in the program's
    place on the same inputs.
    """
    noise = torch.randn(latents.shape, generator=generator(fold_seed(request_seed, 0), device),
                        device=device)
    noise = noise.to(getattr(torch, c["dtype"])).float()  # drawn in the served dtype
    xs = trajectory(noise, REFERENCE.state)
    out = {"latents_rel_err": _rel(latents, xs[-1])}
    if control:
        out["control.latents_rel_err"] = _rel(trajectory(noise, CONTROL.state)[-1], xs[-1])
    w = family.dit_weights(c, weight_seed, device)
    errs, cerrs = [], []
    for i in steps:
        args = (w, c, xs[i], float(timesteps[i]), text, fold_seed(request_seed, i))
        v = family.dit_forward(*args)
        errs.append(_rel(velocities[i], v))
        if control:
            cerrs.append(_rel(family.dit_forward(*args, CONTROL), v))
    out["velocity_rel_err"] = max(errs)
    if control:
        out["control.velocity_rel_err"] = max(cerrs)
    del w
    wv = family.vae_weights(c, weight_seed, device)
    ref = _uint8(family.vae_decode(wv, c, latents))
    out["frames_mae"] = float((frames[0].float() - ref).abs().mean())
    if control:
        ctl = _uint8(family.vae_decode(wv, c, latents, CONTROL))
        out["control.frames_mae"] = float((ctl - ref).abs().mean())
    return out
