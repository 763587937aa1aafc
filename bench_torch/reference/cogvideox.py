"""Plain reference of the CogVideoX text-to-video family: the DiT
(``CogVideoXTransformer3DModel``: joint text + video attention, per-head
q/k LayerNorm, 3-D RoPE on the video tokens, LayerNormZero AdaLN), its ASA
self-attention on the multilevel lane, the SDE-DPM-Solver++(2M) sampler and
the CogVideoX VAE decoder (``AutoencoderKLCogVideoX``) with the chunked,
spatially tiled decode, in f32 from the sizes of a configuration file.

Weights are drawn again from the run's seed in the program's order of
draws (flax's default init: every projection and convolution ``N(0,
1/fan_in)`` in module order; biases 0, norm scales 1, left out of the
arithmetic), as ``reference/wan.py`` says.  The video tokens are arranged
in gilbert order, the text tokens behind them.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch
import torch.nn.functional as F

from bench_torch.harness import roofline
from bench_torch.reference import common as R

_DIT_KEYS = ("dim", "num_heads", "num_layers", "in_channels", "out_channels",
             "time_embed_dim", "patch_size", "ffn_mult", "eps")


def check_preset(config: dict, preset) -> None:
    """Raise unless the program's preset runs the configuration's sizes."""
    d, v = preset.dit, preset.vae
    got = {k: getattr(d, k) for k in _DIT_KEYS}
    got.update(text_dim=d.text_embed_dim, rope_dims=list(d.rope_dims),
               text_len=preset.max_text_len, frames=preset.video.num_frames,
               height=preset.video.height, width=preset.video.width,
               block_out_channels=list(v.block_out_channels),
               layers_per_block=v.layers_per_block, norm_groups=v.norm_groups,
               temporal_compress_level=v.temporal_compress_level,
               scaling_factor=v.scaling_factor, sample_tokens=preset.asa_sample_tokens,
               q_rows=preset.asa_multilevel_q_rows, predictor=preset.asa_predictor,
               snr_shift_scale=preset.snr_shift_scale,
               rescale_betas_zero_snr=preset.rescale_betas_zero_snr)
    want = dict({k: config[k] for k in _DIT_KEYS}, text_dim=config["text_dim"],
                rope_dims=config["rope_dims"], text_len=config["text_len"],
                **{k: config["video"][k] for k in ("frames", "height", "width")},
                **{k: config["vae"][k] for k in ("block_out_channels", "layers_per_block",
                                                 "norm_groups", "temporal_compress_level",
                                                 "scaling_factor")},
                **{k: config["asa"][k] for k in ("sample_tokens", "q_rows", "predictor")},
                **{k: config["schedule"][k] for k in ("snr_shift_scale",
                                                      "rescale_betas_zero_snr")})
    bad = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    if bad:
        raise ValueError(f"preset {config['preset']} differs from the configuration: {bad}")


def dense_flops(c: dict, tokens: int) -> float:
    """Model operations of one forward outside self-attention over
    ``tokens`` video tokens: every projection over the joint sequence, the
    modulations, the embedders and the head."""
    d, n, lt, te = c["dim"], c["num_layers"], c["text_len"], c["time_embed_dim"]
    f = c["ffn_mult"] * d
    joint = tokens + lt
    mm = roofline.linear_flops
    p2 = c["patch_size"] ** 2
    per_layer = 4 * mm(joint, d, d) + mm(joint, d, f) + mm(joint, f, d) + 2 * mm(1, te, 6 * d)
    return (n * per_layer + mm(tokens, c["in_channels"] * p2, d) + mm(lt, c["text_dim"], d)
            + mm(1, d, te) + mm(1, te, te) + mm(1, te, 2 * d)
            + mm(tokens, d, p2 * c["out_channels"]))


def backward_flops(c: dict, tokens: int, rank: int) -> float:
    """Model operations of one backward outside self-attention, with the
    base frozen and LoRA of ``rank`` on every attention projection: the
    input gradient of every block projection over the joint sequence and of
    the head (as many operations as their forward) and the adapters' factor
    gradients, ``4 rows r (d_in + d_out)`` a projection (no weight gradient
    of the base; the embedders and the modulations need none)."""
    d, n, lt = c["dim"], c["num_layers"], c["text_len"]
    f = c["ffn_mult"] * d
    joint = tokens + lt
    mm = roofline.linear_flops
    proj = 4 * mm(joint, d, d) + mm(joint, d, f) + mm(joint, f, d)
    lora = 4 * 4.0 * joint * rank * 2 * d
    return n * (proj + lora) + mm(tokens, d, c["patch_size"] ** 2 * c["out_channels"])


def lora_targets(c: dict):
    """The adapted projections in the order the trainer numbers them: each
    block's attention q, k, v, o."""
    return [f"{i}.{m}" for i in range(c["num_layers"]) for m in ("q", "k", "v", "o")]


def latent_shape(c: dict):
    """``[1, T, C, H, W]`` of a clip's latents."""
    v, vid = c["vae"], c["video"]
    s = 2 ** (len(v["block_out_channels"]) - 1)
    t = (vid["frames"] - 1) // 2 ** v["temporal_compress_level"] + 1
    return (1, t, c["in_channels"], vid["height"] // s, vid["width"] // s)


# -- weights ------------------------------------------------------------------

def dit_weights(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The DiT's weights from the run's seed (the program folds 1 into it)."""
    gen = R.generator(R.fold_seed(seed, 1), device)
    d, te, p = c["dim"], c["time_embed_dim"], c["patch_size"]
    dtype = getattr(torch, c["dtype"])
    w = {}

    def draw(name, shape, served=True):
        t = R.lecun_draw(shape, gen, device)
        w[name] = t.to(dtype).float() if served else t

    draw("patch", [d, c["in_channels"], p, p])
    draw("text", [d, c["text_dim"]])
    draw("t1", [te, d], False)
    draw("t2", [te, te], False)
    for i in range(c["num_layers"]):
        draw(f"{i}.n1", [6 * d, te], False)
        for m in ("q", "k", "v", "o"):
            draw(f"{i}.{m}", [d, d])
        draw(f"{i}.n2", [6 * d, te], False)
        draw(f"{i}.ff0", [c["ffn_mult"] * d, d])
        draw(f"{i}.ff2", [d, c["ffn_mult"] * d])
    draw("nout", [2 * d, te], False)
    draw("out", [p * p * c["out_channels"], d], False)
    return w


def _vae_layout(v: dict):
    """``(name, shape)`` of every decoder convolution in the program's draw
    order."""
    rev = list(v["block_out_channels"])[::-1]
    z = v["latent_channels"]

    def norm(prefix, ch):
        yield f"{prefix}.y", [ch, z, 1, 1, 1]
        yield f"{prefix}.b", [ch, z, 1, 1, 1]

    def res(prefix, i, o):
        yield from norm(f"{prefix}.norm1", i)
        yield f"{prefix}.conv1", [o, i, 3, 3, 3]
        yield from norm(f"{prefix}.norm2", o)
        yield f"{prefix}.conv2", [o, o, 3, 3, 3]
        if i != o:
            yield f"{prefix}.short", [o, i, 1, 1, 1]

    yield "conv_in", [rev[0], z, 3, 3, 3]
    yield from res("mid.0", rev[0], rev[0])
    yield from res("mid.1", rev[0], rev[0])
    cin = rev[0]
    for i, ch in enumerate(rev):
        chans = [cin] + [ch] * (v["layers_per_block"] + 1)
        for j in range(v["layers_per_block"] + 1):
            yield from res(f"up{i}.{j}", chans[j], ch)
        if i < len(rev) - 1:
            yield f"up{i}.up", [ch, ch, 3, 3]
        cin = ch
    yield from norm("norm_out", rev[-1])
    yield "conv_out", [3, rev[-1], 3, 3, 3]


def vae_weights(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The VAE decoder's weights from the run's seed (folded with 2)."""
    gen = R.generator(R.fold_seed(seed, 2), device)
    return {name: R.lecun_draw(shape, gen, device) for name, shape in _vae_layout(c["vae"])}


# -- the DiT ------------------------------------------------------------------

def _heads(x, h):
    return x.reshape(x.shape[0], h, -1).transpose(0, 1)


def dit_forward(w, c: dict, latents, t: float, text, step_seed: int,
                prec=R.REFERENCE, asa=None) -> torch.Tensor:
    """v-prediction ``[1, T, C, H, W]`` of latents ``[1, T, C, H, W]`` at
    timestep ``t`` given text embeddings ``[1, Lt, text_dim]``; ASA's draws
    come from ``step_seed`` folded with the layer index, its lane and sizes
    from ``asa`` (the configuration's by default)."""
    dev = latents.device
    d, h, eps, p = c["dim"], c["num_heads"], c["eps"], c["patch_size"]
    hd = d // h
    _, tt, ch, hh, ww = latents.shape
    gh, gw = hh // p, ww // p
    mm = prec.mm
    x = latents[0].float().reshape(tt, ch, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = mm(x.reshape(tt * gh * gw, -1), w["patch"].reshape(d, -1))
    enc = mm(text[0].float(), w["text"])
    temb = F.silu(prec.mm32(R.timestep_features(torch.tensor([t], device=dev), d), w["t1"]))
    temb = prec.mm32(temb, w["t2"])
    perm = torch.from_numpy(R.gilbert_order(gw, gh, tt)).to(dev)
    cos, sin = (torch.from_numpy(a).to(dev)[perm]
                for a in R.rope_tables(hd, (tt, gh, gw), tuple(c["rope_dims"])))
    x = x[perm]
    nv = x.shape[0]
    asa = asa or c["asa"]

    def block(i, x, enc):
        m = prec.mm32(F.silu(temb), w[f"{i}.n1"]).reshape(6, d)
        hn = R.layer_norm(x, eps) * (1 + m[1]) + m[0]
        en = R.layer_norm(enc, eps) * (1 + m[4]) + m[3]
        joint = torch.cat([hn, en])  # video first, text last
        q = R.layer_norm(_heads(mm(joint, w[f"{i}.q"]), h), 1e-6)
        k = R.layer_norm(_heads(mm(joint, w[f"{i}.k"]), h), 1e-6)
        v = _heads(mm(joint, w[f"{i}.v"]), h)
        q = torch.cat([R.rotate_half(q[:, :nv], cos, sin), q[:, nv:]], dim=1)
        k = torch.cat([R.rotate_half(k[:, :nv], cos, sin), k[:, nv:]], dim=1)
        gen = R.generator(R.fold_seed(step_seed, i), dev)
        o, _ = R.asa_attention(prec.low(q), prec.low(k), prec.low(v), asa, gen, prec)
        o = mm(o.transpose(0, 1).reshape(-1, d), w[f"{i}.o"])
        x = x + m[2] * o[:nv]
        enc = enc + m[5] * o[nv:]
        m = prec.mm32(F.silu(temb), w[f"{i}.n2"]).reshape(6, d)
        hn = R.layer_norm(x, eps) * (1 + m[1]) + m[0]
        en = R.layer_norm(enc, eps) * (1 + m[4]) + m[3]
        ff = mm(R.gelu_tanh(mm(torch.cat([en, hn]), w[f"{i}.ff0"])), w[f"{i}.ff2"])
        lt = enc.shape[0]
        return x + m[2] * ff[lt:], enc + m[5] * ff[:lt]

    for i in range(c["num_layers"]):
        x, enc = prec.block(block, i, x, enc)
    hidden = R.layer_norm(torch.cat([enc, x]), eps)[enc.shape[0]:]
    m = prec.mm32(F.silu(temb), w["nout"]).reshape(2, d)
    out = prec.mm32(R.layer_norm(hidden, eps) * (1 + m[1]) + m[0], w["out"])
    out = out[torch.argsort(perm)]
    out = out.reshape(tt, gh, gw, c["out_channels"], p, p).permute(0, 3, 1, 4, 2, 5)
    return out.reshape(1, tt, c["out_channels"], hh, ww)


# -- the VAE decoder -------------------------------------------------------------

class _Decoder:
    """One tile's decode, a chunk of latent frames at a time: causal
    temporal convolutions carry their last ``k_t - 1`` input frames (a fresh
    stream repeats its first frame), GroupNorm statistics are the chunk's,
    and the resnets' norms are modulated by the chunk's latents."""

    def __init__(self, w, v: dict, dtype):
        self.w, self.v, self.dtype = w, v, dtype
        self.cache: Dict[str, torch.Tensor] = {}

    def conv(self, name, x):
        wt = self.w[name]
        kt = wt.shape[2]
        if kt > 1:
            prev = self.cache.get(name)
            if prev is None:
                prev = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
            x = torch.cat([prev, x], dim=2)
            self.cache[name] = x[:, :, -(kt - 1):]
        return F.conv3d(x, wt, padding=(0, wt.shape[3] // 2, wt.shape[4] // 2))

    def norm(self, name, f, zq):
        t, hh, ww = f.shape[2:]

        def resize(z, tn):
            return (z.repeat_interleave(tn // z.shape[2], 2)
                    .repeat_interleave(hh // z.shape[3], 3).repeat_interleave(ww // z.shape[4], 4))

        if t > 1 and t % 2 == 1:
            zq = torch.cat([resize(zq[:, :, :1], 1), resize(zq[:, :, 1:], t - 1)], dim=2)
        else:
            zq = resize(zq, t)
        g = F.group_norm(f.float(), self.v["norm_groups"], eps=1e-6).to(self.dtype)
        return g * self.conv(f"{name}.y", zq) + self.conv(f"{name}.b", zq)

    def res(self, name, x, zq):
        hx = self.conv(f"{name}.conv1", F.silu(self.norm(f"{name}.norm1", x, zq)))
        hx = self.conv(f"{name}.conv2", F.silu(self.norm(f"{name}.norm2", hx, zq)))
        if f"{name}.short" in self.w:
            x = F.conv3d(x, self.w[f"{name}.short"])
        return x + hx

    def up(self, name, x, compress_time):
        t = x.shape[2]
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        if compress_time and t > 1:
            x = (torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)
                 if t % 2 else x.repeat_interleave(2, dim=2))
        b, ch, tn, hh, ww = x.shape
        y = F.conv2d(x.transpose(1, 2).reshape(b * tn, ch, hh, ww), self.w[name], padding=1)
        return y.reshape(b, tn, ch, hh, ww).transpose(1, 2)

    def chunk(self, z):
        v = self.v
        x = self.conv("conv_in", z)
        x = self.res("mid.0", x, z)
        x = self.res("mid.1", x, z)
        n_up = len(v["block_out_channels"])
        for i in range(n_up):
            for j in range(v["layers_per_block"] + 1):
                x = self.res(f"up{i}.{j}", x, z)
            if i < n_up - 1:
                x = self.up(f"up{i}.up", x, i < v["temporal_compress_level"])
        return self.conv("conv_out", F.silu(self.norm("norm_out", x, z)))


def _decode_tile(w, v, z, dtype):
    """``z [1, C, T, h, w]`` in chunks of ``frame_batch`` latent frames, the
    first taking the remainder."""
    t, fb = z.shape[2], v["frame_batch"]
    bounds = [0, fb + t % fb] if t > fb else [0, t]
    while bounds[-1] < t:
        bounds.append(min(bounds[-1] + fb, t))
    dec = _Decoder(w, v, dtype)
    return torch.cat([dec.chunk(z[:, :, s:e]).float() for s, e in zip(bounds[:-1], bounds[1:])],
                     dim=2)


def uniform_tiling(n: int, max_tile: int):
    """``(tile, overlap)``: ``n`` latent pixels in equal tiles of at most
    ``max_tile`` that overlap by 4 to 12 (the first fit in the order the
    decode path tries), or ``(n, 0)`` when one tile holds them."""
    if n <= max_tile:
        return n, 0
    for parts in range(2, n):
        for ov in (6, 8, 4, 9, 12, 10, 5, 7, 11):
            if (n + ov * (parts - 1)) % parts == 0:
                tile = (n + ov * (parts - 1)) // parts
                if ov < tile <= max_tile:
                    return tile, ov
    return max_tile, 4


def vae_decode(wv, c: dict, latents, prec=R.REFERENCE) -> torch.Tensor:
    """Latents ``[1, T, C, H, W]`` -> frames ``[1, T', H', W', 3]`` in
    [-1, 1]: each spatial tile decoded on its own, tiles crossfaded
    linearly over their overlap (along the width within a row of tiles,
    then along the height)."""
    v = c["vae"]
    dtype = prec.vae
    w = {k: t.to(dtype) for k, t in wv.items()}
    z = (latents.float() / v["scaling_factor"]).permute(0, 2, 1, 3, 4).to(dtype)
    _, _, _, hh, ww = z.shape
    sf = 2 ** (len(v["block_out_channels"]) - 1)
    if hh * ww >= v["tile_from_latent_pixels"]:
        (th, oh), (tw, ow) = (uniform_tiling(hh, v["max_tile_latent"]),
                              uniform_tiling(ww, v["max_tile_latent"]))
    else:
        (th, oh), (tw, ow) = (hh, 0), (ww, 0)

    def blend(a, b, dim, ov):
        ov *= sf
        if not ov:
            return torch.cat([a, b], dim=dim)
        shape = [1] * a.dim()
        shape[dim] = ov
        ramp = torch.linspace(0, 1, ov, device=a.device, dtype=a.dtype).reshape(shape)
        n = a.shape[dim]
        mixed = a.narrow(dim, n - ov, ov) * (1 - ramp) + b.narrow(dim, 0, ov) * ramp
        return torch.cat([a.narrow(dim, 0, n - ov), mixed, b.narrow(dim, ov, b.shape[dim] - ov)],
                         dim=dim)

    out = None
    for i0 in range(0, max(hh - oh, 1), th - oh):
        row = None
        for j0 in range(0, max(ww - ow, 1), tw - ow):
            tile = _decode_tile(w, v, z[:, :, :, i0:i0 + th, j0:j0 + tw], dtype)
            row = tile if row is None else blend(row, tile, 4, ow)
        out = row if out is None else blend(out, row, 3, oh)
    return out.permute(0, 2, 3, 4, 1).clamp(-1.0, 1.0)


def check_t2v(c: dict, traffic: dict, *, velocities, request_seed: int, device,
              **kw) -> dict:
    """``common.t2v_gaps`` of a served clip under SDE-DPM-Solver++(2M),
    whose step noises the reference draws again."""
    n, s = int(traffic["num_steps"]), c["schedule"]
    shape = velocities[0].shape
    xis = [torch.randn(shape, device=device, generator=R.generator(
        R.fold_seed(R.fold_seed(request_seed, i), 1), device)) for i in range(n)]
    return R.t2v_gaps(
        sys.modules[__name__], c, velocities=velocities, request_seed=request_seed,
        device=device, timesteps=R.dpm_schedule(s, n)[0],
        trajectory=lambda noise, state: R.dpm_trajectory(noise, velocities, xis, s, n, state),
        **kw)
