"""Plain reference of the Wan2.1 text-to-video family: the DiT (Wan2.1
``WanTransformer3DModel``), its ASA self-attention, the flow UniPC sampler
and the Wan2.1 VAE decoder (``AutoencoderKLWan``), in f32 from the sizes of
a configuration file.

Weights are drawn again from the run's seed in the program's order of
draws (flax's default init: every projection and convolution ``N(0,
1/fan_in)`` in module order, biases 0, norm scales 1, then the modulation
tables ``N(0, 0.02)``), so nothing is taken from the program.  A weight the
configuration computes with in its ``dtype`` (bf16) takes that value (what
is served);
every sum and product is f32.  Zero biases and unit norm scales are left
out of the arithmetic.  The q/k projections keep the draw's row order, which
the served model stores de-interleaved per head, and rotary embedding is
applied in the matching rotate-half form: the same function as the
published interleaved form on the un-permuted weights.

Also the model FLOP count of a forward (``dense_flops``), the operations of
everything outside self-attention, which the ASA calls' counts complete.
"""

from __future__ import annotations

import math
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.harness import roofline
from bench_torch.reference import common as R

# Keys of the configuration file that must equal the program's preset.
_DIT_KEYS = ("dim", "ffn_dim", "num_layers", "num_heads", "in_channels", "out_channels",
             "text_dim", "freq_dim", "eps")


def check_preset(config: dict, preset) -> None:
    """Raise unless the program's preset runs the configuration's sizes."""
    d = preset.dit
    got = {k: getattr(d, k) for k in _DIT_KEYS}
    got.update(patch_size=list(d.patch_size), text_len=preset.max_text_len,
               frames=preset.video.num_frames, height=preset.video.height,
               width=preset.video.width, flow_shift=preset.flow_shift,
               vae_base_dim=preset.vae.base_dim, vae_dim_mult=list(preset.vae.dim_mult),
               vae_num_res_blocks=preset.vae.num_res_blocks,
               vae_temporal_downsample=list(preset.vae.temporal_downsample),
               sample_tokens=preset.asa_sample_tokens, sample_gap=preset.sample_gap,
               min_retain_ratio=preset.min_retain_ratio,
               max_retain_ratio=preset.max_retain_ratio, predictor=preset.asa_predictor)
    want = dict({k: config[k] for k in _DIT_KEYS}, patch_size=config["patch_size"],
                text_len=config["text_len"], **{k: config["video"][k] for k in
                                                 ("frames", "height", "width")},
                flow_shift=config["flow_shift"],
                **{"vae_" + k: config["vae"][k] for k in
                   ("base_dim", "dim_mult", "num_res_blocks", "temporal_downsample")},
                **{k: config["asa"][k] for k in ("sample_tokens", "sample_gap",
                                                 "min_retain_ratio", "max_retain_ratio",
                                                 "predictor")})
    bad = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    if bad:
        raise ValueError(f"preset {config['preset']} differs from the configuration: {bad}")


def dense_flops(c: dict, tokens: int) -> float:
    """Model operations of one forward outside self-attention over
    ``tokens`` video tokens: every projection, cross-attention over the
    text, the embedders and the head."""
    d, f, n, lt = c["dim"], c["ffn_dim"], c["num_layers"], c["text_len"]
    mm = roofline.linear_flops
    p = int(np.prod(c["patch_size"]))
    per_layer = (6 * mm(tokens, d, d) + 2 * mm(lt, d, d) + mm(tokens, d, f) + mm(tokens, f, d)
                 + roofline.attention_flops(float(tokens) * lt * c["num_heads"],
                                            d // c["num_heads"]))
    return (n * per_layer + mm(tokens, c["in_channels"] * p, d)
            + mm(lt, c["text_dim"], d) + mm(lt, d, d)
            + mm(1, c["freq_dim"], d) + mm(1, d, d) + mm(1, d, 6 * d)
            + mm(tokens, d, p * c["out_channels"]))


def backward_flops(c: dict, tokens: int, rank: int) -> float:
    """Model operations of one backward outside self-attention, with the
    base frozen and LoRA of ``rank`` on every attention projection: the
    input gradient of every block projection and of the head (as many
    operations as their forward), cross-attention's (twice its forward), and
    the adapters' factor gradients, ``4 rows r (d_in + d_out)`` a projection
    (no weight gradient of the base; the embedders need none)."""
    d, f, n, lt = c["dim"], c["ffn_dim"], c["num_layers"], c["text_len"]
    mm = roofline.linear_flops
    p = int(np.prod(c["patch_size"]))
    proj = 6 * mm(tokens, d, d) + 2 * mm(lt, d, d) + mm(tokens, d, f) + mm(tokens, f, d)
    cross = roofline.attention_flops(float(tokens) * lt * c["num_heads"], d // c["num_heads"])
    lora = 4.0 * rank * 2 * d * (6 * tokens + 2 * lt)
    return n * (proj + 2 * cross + lora) + mm(tokens, d, p * c["out_channels"])


def lora_targets(c: dict):
    """The adapted projections in the order the trainer numbers them: each
    block's self-attention q, k, v, o, then its cross-attention's."""
    return [f"{i}.{part}.{m}" for i in range(c["num_layers"]) for part in ("self", "cross")
            for m in ("q", "k", "v", "o")]


def latent_shape(c: dict):
    """``[1, C, T, H, W]`` of a clip's latents."""
    v, vid = c["vae"], c["video"]
    s = 2 ** (len(v["dim_mult"]) - 1)
    t = (vid["frames"] - 1) // 2 ** sum(map(bool, v["temporal_downsample"])) + 1
    return (1, c["in_channels"], t, vid["height"] // s, vid["width"] // s)


# -- weights ------------------------------------------------------------------

def dit_weights(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The DiT's weights from the run's seed (the program folds 1 into it)."""
    gen = R.generator(R.fold_seed(seed, 1), device)
    d, f = c["dim"], c["ffn_dim"]
    p = list(c["patch_size"])
    dtype = getattr(torch, c["dtype"])
    w = {}

    def served_dtype(t):
        return t.to(dtype).float()

    def draw(name, shape, served=served_dtype):
        w[name] = served(R.lecun_draw(shape, gen, device))

    draw("patch", [d, c["in_channels"]] + p)
    draw("txt1", [d, c["text_dim"]])
    draw("txt2", [d, d])
    draw("t1", [d, c["freq_dim"]], lambda t: t)
    draw("t2", [d, d], lambda t: t)
    draw("tproj", [6 * d, d], lambda t: t)
    for i in range(c["num_layers"]):
        for part in ("self", "cross"):
            for m in ("q", "k", "v", "o"):
                draw(f"{i}.{part}.{m}", [d, d])
        draw(f"{i}.ffn0", [f, d])
        draw(f"{i}.ffn2", [d, f])
    draw("out", [int(np.prod(p)) * c["out_channels"], d], lambda t: t)
    for i in range(c["num_layers"]):
        w[f"{i}.sst"] = torch.empty((1, 6, d), device=device).normal_(0.0, 0.02, generator=gen)[0]
    w["sst"] = torch.empty((1, 2, d), device=device).normal_(0.0, 0.02, generator=gen)[0]
    return w


def _vae_dims(v: dict):
    mult = list(v["dim_mult"])
    return [v["base_dim"] * m for m in [mult[-1]] + mult[::-1]]


def _vae_layout(v: dict):
    """``(name, shape)`` of every decoder convolution in the program's draw
    order, then ``post_quant_conv``."""
    dims = _vae_dims(v)
    z = v["z_dim"]

    def res(prefix, i, o):
        yield f"{prefix}.conv1", [o, i, 3, 3, 3]
        yield f"{prefix}.conv2", [o, o, 3, 3, 3]
        if i != o:
            yield f"{prefix}.short", [o, i, 1, 1, 1]

    yield "conv_in", [dims[0], z, 3, 3, 3]
    yield from res("mid.0", dims[0], dims[0])
    yield from res("mid.1", dims[0], dims[0])
    yield "mid.qkv", [3 * dims[0], dims[0], 1, 1]
    yield "mid.proj", [dims[0], dims[0], 1, 1]
    ups = list(v["temporal_downsample"])[::-1]
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        cin = cin // 2 if i > 0 else cin
        chans = [cin] + [cout] * (v["num_res_blocks"] + 1)
        for j in range(v["num_res_blocks"] + 1):
            yield from res(f"up{i}.{j}", chans[j], cout)
        if i != len(v["dim_mult"]) - 1:
            yield f"up{i}.resample", [cout // 2, cout, 3, 3]
            if ups[i]:
                yield f"up{i}.time", [2 * cout, cout, 3, 1, 1]
    yield "conv_out", [3, dims[-1], 3, 3, 3]
    yield "post_quant", [z, z, 1, 1, 1]


def vae_weights(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The VAE decoder's weights from the run's seed (folded with 2)."""
    gen = R.generator(R.fold_seed(seed, 2), device)
    return {name: R.lecun_draw(shape, gen, device) for name, shape in _vae_layout(c["vae"])}


# -- the DiT ------------------------------------------------------------------

def _heads(x, h):
    return x.reshape(x.shape[0], h, -1).transpose(0, 1)


def dit_forward(w, c: dict, latents, t: float, text, step_seed: int,
                prec=R.REFERENCE, asa=None) -> torch.Tensor:
    """Velocity ``[1, C, T, H, W]`` of latents ``[1, C, T, H, W]`` at
    timestep ``t`` given text embeddings ``[1, Lt, text_dim]``; ASA's
    draws come from ``step_seed`` folded with the layer index, its lane and
    sizes from ``asa`` (the configuration's by default)."""
    dev = latents.device
    d, h, eps = c["dim"], c["num_heads"], c["eps"]
    hd = d // h
    _, ch, tt, hh, ww = latents.shape
    pt, ph, pw = c["patch_size"]
    gt, gh, gw = tt // pt, hh // ph, ww // pw
    mm = prec.mm
    x = latents.float().reshape(ch, gt, pt, gh, ph, gw, pw).permute(1, 3, 5, 0, 2, 4, 6)
    x = mm(x.reshape(gt * gh * gw, -1), w["patch"].reshape(d, -1))
    ctx = mm(R.gelu_tanh(mm(text[0].float(), w["txt1"])), w["txt2"])
    temb = R.timestep_features(torch.tensor([t], device=dev), c["freq_dim"])
    temb = prec.mm32(F.silu(prec.mm32(temb, w["t1"])), w["t2"])
    temb6 = prec.mm32(F.silu(temb), w["tproj"]).reshape(6, d)
    perm = torch.from_numpy(R.gilbert_order(gw, gh, gt)).to(dev)
    cos, sin = (torch.from_numpy(a).to(dev)[perm] for a in R.rope_tables(hd, (gt, gh, gw)))
    x = x[perm]
    asa = asa or c["asa"]

    def block(i, x):
        e = w[f"{i}.sst"] + temb6
        n = R.layer_norm(x, eps) * (1 + e[1]) + e[0]
        q = R.rotate_half(_heads(R.rms_norm(mm(n, w[f"{i}.self.q"]), eps), h), cos, sin)
        k = R.rotate_half(_heads(R.rms_norm(mm(n, w[f"{i}.self.k"]), eps), h), cos, sin)
        v = _heads(mm(n, w[f"{i}.self.v"]), h)
        gen = R.generator(R.fold_seed(step_seed, i), dev)
        o, _ = R.asa_attention(prec.low(q), prec.low(k), prec.low(v), asa, gen, prec)
        x = x + e[2] * mm(o.transpose(0, 1).reshape(-1, d), w[f"{i}.self.o"])
        n = R.layer_norm(x, eps)
        q = _heads(R.rms_norm(mm(n, w[f"{i}.cross.q"]), eps), h)
        k = _heads(R.rms_norm(mm(ctx, w[f"{i}.cross.k"]), eps), h)
        v = _heads(mm(ctx, w[f"{i}.cross.v"]), h)
        o = (R.dense_attention if prec.train else R.masked_attention)(
            prec.low(q), prec.low(k), prec.low(v))
        x = x + mm(o.transpose(0, 1).reshape(-1, d), w[f"{i}.cross.o"])
        n = R.layer_norm(x, eps) * (1 + e[4]) + e[3]
        return x + e[5] * mm(R.gelu_tanh(mm(n, w[f"{i}.ffn0"])), w[f"{i}.ffn2"])

    for i in range(c["num_layers"]):
        x = prec.block(block, i, x)
    e = w["sst"] + temb
    out = prec.mm32(R.layer_norm(x, eps) * (1 + e[1]) + e[0], w["out"])
    out = out[torch.argsort(perm)]
    out = out.reshape(gt, gh, gw, pt, ph, pw, c["out_channels"]).permute(6, 0, 3, 1, 4, 2, 5)
    return out.reshape(1, c["out_channels"], tt, hh, ww)


# -- the VAE decoder -------------------------------------------------------------

class _Decoder:
    """Streaming decode, latent frame by latent frame: every causal
    temporal convolution carries its last ``k_t - 1`` input frames (zeros
    before the first), as the published decoder does."""

    def __init__(self, w, dtype):
        self.w = {k: t.to(dtype) for k, t in w.items()}
        self.dtype = dtype
        self.cache: Dict[str, torch.Tensor] = {}

    def conv(self, name, x):
        wt = self.w[name]
        kt = wt.shape[2]
        if kt > 1:
            prev = self.cache.get(name)
            if prev is None:
                prev = x.new_zeros(x.shape[:2] + (kt - 1,) + x.shape[3:])
            x = torch.cat([prev, x], dim=2)
            self.cache[name] = x[:, :, -(kt - 1):]
        return F.conv3d(x, wt, padding=(0, wt.shape[3] // 2, wt.shape[4] // 2))

    def norm(self, x):
        y = F.normalize(x.float(), dim=1, eps=1e-12) * math.sqrt(x.shape[1])
        return y.to(self.dtype)

    def res(self, name, x):
        hx = self.conv(f"{name}.conv1", F.silu(self.norm(x)))
        hx = self.conv(f"{name}.conv2", F.silu(self.norm(hx)))
        if f"{name}.short" in self.w:
            x = self.conv(f"{name}.short", x)
        return x + hx

    def attn(self, x):
        b, ch, t, hh, ww = x.shape
        y = self.norm(x).permute(0, 2, 3, 4, 1).reshape(b * t, hh * ww, ch)
        q, k, v = (y @ self.w["mid.qkv"][..., 0, 0].t()).chunk(3, dim=-1)
        p = torch.softmax((q @ k.transpose(1, 2)).float() / math.sqrt(ch), -1).to(self.dtype)
        o = (p @ v) @ self.w["mid.proj"][..., 0, 0].t()
        return x + o.reshape(b, t, hh, ww, ch).permute(0, 4, 1, 2, 3)

    def resample(self, name, x):
        if f"{name}.time" in self.w:
            key = f"{name}.time"
            if key not in self.cache:  # the first frame bypasses the time conv
                self.cache[key] = x.new_zeros(x.shape[:2] + (2,) + x.shape[3:])
            else:
                y = self.conv(key, x)
                b, c2, t, hh, ww = y.shape
                x = y.reshape(b, 2, c2 // 2, t, hh, ww).permute(0, 2, 3, 1, 4, 5)
                x = x.reshape(b, c2 // 2, 2 * t, hh, ww)
        b, ch, t, hh, ww = x.shape
        y = x.permute(0, 2, 1, 3, 4).reshape(b * t, ch, hh, ww)
        y = F.conv2d(F.interpolate(y, scale_factor=2.0, mode="nearest"),
                     self.w[f"{name}.resample"], padding=1)
        return y.reshape(b, t, ch // 2, 2 * hh, 2 * ww).permute(0, 2, 1, 3, 4)

    def frame(self, z, v: dict):
        x = self.conv("post_quant", z.to(self.dtype))
        x = self.conv("conv_in", x)
        x = self.res("mid.0", x)
        x = self.attn(x)
        x = self.res("mid.1", x)
        for i in range(len(v["dim_mult"])):
            for j in range(v["num_res_blocks"] + 1):
                x = self.res(f"up{i}.{j}", x)
            if f"up{i}.resample" in self.w:
                x = self.resample(f"up{i}", x)
        return self.conv("conv_out", F.silu(self.norm(x)))


def vae_decode(wv, c: dict, latents, prec=R.REFERENCE) -> torch.Tensor:
    """Latents ``[1, C, T, H, W]`` -> frames ``[1, T', H', W', 3]`` in
    [-1, 1]: the published per-channel statistics undone, then the
    streaming decode."""
    v = c["vae"]
    z = latents.float() / v["scaling_factor"]
    if v.get("latents_mean") is not None:
        mean, std = (torch.tensor(v[k], device=z.device)[None, :, None, None, None]
                     for k in ("latents_mean", "latents_std"))
        z = z * std + mean
    dec = _Decoder(wv, prec.vae)
    frames = [dec.frame(z[:, :, i:i + 1], v).float() for i in range(z.shape[2])]
    return torch.cat(frames, dim=2).permute(0, 2, 3, 4, 1).clamp(-1.0, 1.0)


def check_t2v(c: dict, traffic: dict, *, velocities, **kw) -> dict:
    """``common.t2v_gaps`` of a served clip under flow UniPC."""
    n = int(traffic["num_steps"])
    return R.t2v_gaps(
        sys.modules[__name__], c, velocities=velocities,
        timesteps=R.unipc_schedule(n, c["flow_shift"])[1],
        trajectory=lambda noise, state: R.unipc_trajectory(noise, velocities, n,
                                                           c["flow_shift"], state), **kw)
