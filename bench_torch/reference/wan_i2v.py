"""Plain reference of Wan2.1 image to video (Wan2.1-I2V-14B at 480p): the
Wan VAE encoder that makes the conditioning, the I2V DiT (Wan2.1's
``WanTransformer3DModel`` with ``image_dim`` set) on ASA's energy lane, the
flow UniPC sampler and the Wan VAE decoder, in f32 from the sizes of a
configuration file.

What image to video adds to ``reference/wan.py``:

- the conditioning: the image as frame 0 of ``[image, frames - 1 zeros]``
  through the encoder (the published encode loop: frame 0, then chunks of
  the temporal factor, every causal convolution carrying its last ``k_t - 1``
  input frames and every temporal downsample its last frame), its posterior
  mean normalised as ``(mu - latents_mean) / latents_std``; in front of it a
  mask, one on the first latent frame and zero after, of the channels the
  DiT reads past the latents and the encoding;
- the DiT reads ``[latents, mask, encoding]`` through its patch embedding;
  the CLIP image features go through the image embedder (LayerNorm, Linear,
  exact GELU, Linear, LayerNorm, eps 1e-5, in f32); every block's
  cross-attention adds, to the text branch, a second softmax over the image
  tokens (keys ``rms_norm(img add_k)``, values ``img add_v``) of the same
  queries.

Weights are drawn from the run's seed in the program's order (the DiT:
``wan.dit_weights``' order with the image embedder after the time
projection and each block's ``add_k``, ``add_v`` after its cross-attention
output; the VAE: the decoder and ``post_quant_conv`` as ``wan.vae_weights``,
then the encoder and ``quant_conv``).  A weight the configuration serves in
bf16 is held in bf16 and cast to f32 where it is used, as
``reference/wan_levels.py`` does.  Self-attention is ``common.asa_energy``'s
function over each row's gathered blocks (``common.asa_energy_grad`` with
no gradient: the same mask from the same draws, one softmax over the
selected blocks and the pooled keys).  Plain PyTorch in f32 with TF32 off,
importing nothing of the program.

The check (:func:`check_i2v`) holds a served clip to this reference:
``cond_rel_err`` (the program's encoded channels against this encoder on
the same image), then ``common.t2v_gaps`` with the DiT teacher-forced on the
program's encoding (and this reference's own mask), so the encoder's gap
and the DiT's stay apart.
"""

from __future__ import annotations

import gc
import types
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.harness import roofline
from bench_torch.reference import common as R
from bench_torch.reference import wan as W
from bench_torch.reference.wan import vae_decode

LN_EPS = 1e-5  # the image embedder's LayerNorms


def check_preset(config: dict, preset) -> None:
    """``wan.check_preset``, and image to video's sizes: the CLIP features'
    width and tokens, and the lane (``drivers/i2v.py`` holds the lane's
    energy threshold, which the preset does not carry)."""
    W.check_preset(config, preset)
    d = preset.dit
    got = {"image_dim": d.image_dim, "image_len": d.image_context_tokens,
           "lane": preset.family.mask_mode}
    want = {"image_dim": config["image_dim"], "image_len": config["image_len"],
            "lane": config["asa"]["lane"]}
    bad = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    if bad:
        raise ValueError(f"preset {config['preset']} differs from the configuration: {bad}")


def dense_flops(c: dict, tokens: int) -> float:
    """``wan.dense_flops`` (the patch embedding over ``in_channels``), plus
    the image embedder and every block's image branch: its K/V projections
    and the attention of every query over the image tokens."""
    d, li, h = c["dim"], c["image_len"], c["num_heads"]
    mm = roofline.linear_flops
    branch = 2 * mm(li, d, d) + roofline.attention_flops(float(tokens) * li * h, d // h)
    return (W.dense_flops(c, tokens) + c["num_layers"] * branch
            + mm(li, c["image_dim"], c["image_dim"]) + mm(li, c["image_dim"], d))


# -- weights ------------------------------------------------------------------

def dit_weights(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The DiT's weights from the run's seed (the program folds 1 into it),
    in the program's order; a weight served in the configuration's
    ``dtype`` is kept in it, the others in f32."""
    gen = R.generator(R.fold_seed(seed, 1), device)
    d, f, idim = c["dim"], c["ffn_dim"], c["image_dim"]
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
    draw("img1", [idim, idim], False)
    draw("img2", [d, idim], False)
    for i in range(c["num_layers"]):
        for part in ("self", "cross"):
            for m in ("q", "k", "v", "o"):
                draw(f"{i}.{part}.{m}", [d, d])
        draw(f"{i}.image.k", [d, d])
        draw(f"{i}.image.v", [d, d])
        draw(f"{i}.ffn0", [f, d])
        draw(f"{i}.ffn2", [d, f])
    draw("out", [int(np.prod(p)) * c["out_channels"], d], False)
    for i in range(c["num_layers"]):
        w[f"{i}.sst"] = torch.empty((1, 6, d), device=device).normal_(0.0, 0.02, generator=gen)[0]
    w["sst"] = torch.empty((1, 2, d), device=device).normal_(0.0, 0.02, generator=gen)[0]
    return w


def _encoder_layout(v: dict):
    """``(name, shape)`` of every encoder convolution in the program's draw
    order, then ``quant``: stage ``i`` of ``num_res_blocks`` residual
    blocks, then its stride-2 downsample (and, where the stage halves time,
    its stride-2 time convolution)."""
    dims = [v["base_dim"] * m for m in [1] + list(v["dim_mult"])]
    z = v["z_dim"]

    def res(prefix, i, o):
        yield f"{prefix}.conv1", [o, i, 3, 3, 3]
        yield f"{prefix}.conv2", [o, o, 3, 3, 3]
        if i != o:
            yield f"{prefix}.short", [o, i, 1, 1, 1]

    yield "conv_in", [dims[0], 3, 3, 3, 3]
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        for j in range(v["num_res_blocks"]):
            yield from res(f"down{i}.{j}", cin if j == 0 else cout, cout)
        if i != len(v["dim_mult"]) - 1:
            yield f"down{i}.resample", [cout, cout, 3, 3]
            if v["temporal_downsample"][i]:
                yield f"down{i}.time", [cout, cout, 3, 1, 1]
    yield from res("mid.0", dims[-1], dims[-1])
    yield from res("mid.1", dims[-1], dims[-1])
    yield "mid.qkv", [3 * dims[-1], dims[-1], 1, 1]
    yield "mid.proj", [dims[-1], dims[-1], 1, 1]
    yield "conv_out", [2 * z, dims[-1], 3, 3, 3]
    yield "quant", [2 * z, 2 * z, 1, 1, 1]


def vae_weights(c: dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor]]:
    """``(decoder, encoder)`` weights from the run's seed (folded with 2):
    the decoder's as ``wan.vae_weights`` draws them, the encoder's after."""
    gen = R.generator(R.fold_seed(seed, 2), device)
    dec = {name: R.lecun_draw(shape, gen, device) for name, shape in W._vae_layout(c["vae"])}
    enc = {name: R.lecun_draw(shape, gen, device) for name, shape in _encoder_layout(c["vae"])}
    return dec, enc


# -- the VAE encoder -----------------------------------------------------------

class _Encoder(W._Decoder):
    """The published streaming encode over one clip: the decoder's causal
    convolutions, norms, residual blocks and mid attention over the
    encoder's weights, and the downsamples."""

    def down(self, name, x):
        b, ch, t, hh, ww = x.shape
        y = F.pad(x.permute(0, 2, 1, 3, 4).reshape(b * t, ch, hh, ww), (0, 1, 0, 1))
        y = F.conv2d(y, self.w[f"{name}.resample"], stride=2)
        x = y.reshape(b, t, ch, y.shape[2], y.shape[3]).permute(0, 2, 1, 3, 4)
        key = f"{name}.time"
        if key not in self.w:
            return x
        prev = self.cache.get(key)
        self.cache[key] = x[:, :, -1:]
        if prev is None:  # the first chunk, frame 0 alone, passes through
            return x
        return F.conv3d(torch.cat([prev, x], dim=2), self.w[key], stride=(2, 1, 1))

    def chunk(self, x, v: dict):
        x = self.conv("conv_in", x.to(self.dtype))
        for i in range(len(v["dim_mult"])):
            for j in range(v["num_res_blocks"]):
                x = self.res(f"down{i}.{j}", x)
            if f"down{i}.resample" in self.w:
                x = self.down(f"down{i}", x)
        x = self.res("mid.0", x)
        x = self.attn(x)
        x = self.res("mid.1", x)
        x = self.conv("conv_out", F.silu(self.norm(x)))
        return self.conv("quant", x)[:, :v["z_dim"]]


def vae_encode(we, c: dict, image, prec=R.REFERENCE) -> torch.Tensor:
    """Image ``[1, 3, H, W]`` in [-1, 1] -> the normalised posterior mean
    ``[1, z, T', H', W']`` of ``[image, frames - 1 zero frames]`` (f32)."""
    v = c["vae"]
    step = 2 ** sum(map(bool, v["temporal_downsample"]))
    frames = c["video"]["frames"]
    video = torch.cat([image.float()[:, :, None],
                       image.new_zeros((1, 3, frames - 1) + image.shape[2:]).float()], dim=2)
    enc = _Encoder(we, prec.vae)
    bounds = [(0, 1)] + [(s, s + step) for s in range(1, frames, step)]
    mu = torch.cat([enc.chunk(video[:, :, a:b], v).float() for a, b in bounds], dim=2)
    if v.get("latents_mean") is not None:
        mean, std = (torch.tensor(v[k], device=mu.device)[None, :, None, None, None]
                     for k in ("latents_mean", "latents_std"))
        mu = (mu - mean) / std
    return mu


def mask_channels(c: dict, encoded: torch.Tensor) -> torch.Tensor:
    """The first-frame mask in front of ``encoded [1, z, T', H', W']``: one
    on latent frame 0, zero after, over the DiT's remaining input channels."""
    n = c["in_channels"] - c["out_channels"] - encoded.shape[1]
    mask = encoded.new_zeros((1, n) + encoded.shape[2:])
    mask[:, :, 0] = 1.0
    return mask


# -- the DiT ------------------------------------------------------------------

def dit_forward(w, c: dict, latents, t: float, text, step_seed: int, prec=R.REFERENCE, *,
                image_embeds, condition) -> torch.Tensor:
    """Velocity ``[1, C, T, H, W]`` of latents ``[1, C, T, H, W]`` read with
    ``condition [1, C_cond, T, H, W]`` at timestep ``t``, given text
    embeddings ``[1, Lt, text_dim]`` and CLIP features ``[1, Li,
    image_dim]``; ASA's draws come from ``step_seed`` folded with the layer
    index (``wan.dit_forward``'s protocol)."""
    dev = latents.device
    d, h, eps = c["dim"], c["num_heads"], c["eps"]
    hd = d // h
    _, ch, tt, hh, ww = latents.shape
    pt, ph, pw = c["patch_size"]
    gt, gh, gw = tt // pt, hh // ph, ww // pw

    def mm(x, name):
        return prec.mm(x, w[name].float())

    x = torch.cat([latents.float(), condition.float()], dim=1)
    cin = x.shape[1]
    x = x.reshape(cin, gt, pt, gh, ph, gw, pw).permute(1, 3, 5, 0, 2, 4, 6)
    x = prec.mm(x.reshape(gt * gh * gw, -1), w["patch"].float().reshape(d, -1))
    ctx = mm(R.gelu_tanh(mm(text[0].float(), "txt1")), "txt2")
    img = R.layer_norm(image_embeds[0].float(), LN_EPS)
    img = prec.mm32(F.gelu(prec.mm32(img, w["img1"])), w["img2"])
    img = R.layer_norm(img, LN_EPS)
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
        o, _ = R.asa_energy_grad(prec.low(q), prec.low(k), prec.low(v), c["asa"], gen)
        del q, k, v
        x = x + e[2] * mm(o.transpose(0, 1).reshape(-1, d), f"{i}.self.o")
        del o
        n = R.layer_norm(x, eps)
        q = prec.low(heads(R.rms_norm(mm(n, f"{i}.cross.q"), eps), h))
        k = heads(R.rms_norm(mm(ctx, f"{i}.cross.k"), eps), h)
        v = heads(mm(ctx, f"{i}.cross.v"), h)
        o = R.masked_attention(q, prec.low(k), prec.low(v))
        k = heads(R.rms_norm(mm(img, f"{i}.image.k"), eps), h)
        v = heads(mm(img, f"{i}.image.v"), h)
        o = o + R.masked_attention(q, prec.low(k), prec.low(v))
        x = x + mm(o.transpose(0, 1).reshape(-1, d), f"{i}.cross.o")
        del q, o, n
        n = R.layer_norm(x, eps) * (1 + e[4]) + e[3]
        x = x + e[5] * mm(R.gelu_tanh(mm(n, f"{i}.ffn0")), f"{i}.ffn2")
        del n
    e = w["sst"] + temb
    out = prec.mm32(R.layer_norm(x, eps) * (1 + e[1]) + e[0], w["out"])
    out = out[torch.argsort(perm)]
    out = out.reshape(gt, gh, gw, pt, ph, pw, c["out_channels"]).permute(6, 0, 3, 1, 4, 2, 5)
    return out.reshape(1, c["out_channels"], tt, hh, ww)


def _rel(got, want):
    return float((got.float() - want).norm() / want.norm())


def check_i2v(c: dict, traffic: dict, *, image, image_embeds, condition, velocities,
              weight_seed: int, device, control: bool = False, **kw) -> dict:
    """The gaps of a served clip: ``cond_rel_err`` (relative L2 of the
    program's encoded channels, the last ``z_dim`` of ``condition``, against
    :func:`vae_encode` of ``image``), then ``common.t2v_gaps`` under flow
    UniPC with the DiT reading this reference's mask and the program's
    encoded channels.  With ``control``, ``control.cond_rel_err`` is the
    encoder a precision lower (bf16) against it.  What the freed program
    still holds in reference cycles is collected first."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    z = c["vae"]["z_dim"]
    dec, enc = vae_weights(c, weight_seed, device)
    served = condition[:, -z:].float()
    with R.strict_f32():
        ref = vae_encode(enc, c, image)
        out = {"cond_rel_err": _rel(served, ref)}
        if control:
            out["control.cond_rel_err"] = _rel(vae_encode(enc, c, image, R.CONTROL), ref)
    del enc, ref
    cond = torch.cat([mask_channels(c, served), served], dim=1)

    def forward(w, cc, latents, t, text, step_seed, prec=R.REFERENCE):
        return dit_forward(w, cc, latents, t, text, step_seed, prec,
                           image_embeds=image_embeds, condition=cond)

    family = types.SimpleNamespace(dit_weights=dit_weights, dit_forward=forward,
                                   vae_weights=lambda *a: dec, vae_decode=vae_decode)
    n = int(traffic["num_steps"])
    out.update(R.t2v_gaps(
        family, c, velocities=velocities, weight_seed=weight_seed, device=device,
        control=control, timesteps=R.unipc_schedule(n, c["flow_shift"])[1],
        trajectory=lambda noise, state: R.unipc_trajectory(noise, velocities, n,
                                                           c["flow_shift"], state), **kw))
    return out


__all__ = ["check_preset", "dense_flops", "dit_weights", "vae_weights", "vae_encode",
           "mask_channels", "dit_forward", "check_i2v", "vae_decode"]
