"""Wan2.1 causal video VAE with streaming decode and encode (PyTorch).

Counterpart of ``blade/models/vae_wan.py`` (``AutoencoderKLWan`` parity):
RMS channel norms, zero-padded causal temporal convs, channel-halving
upsample convs and the learned 2x temporal upsample whose first frame
bypasses the time conv; in the encoder, stride-2 spatial downsample convs
(zero-padded right and bottom) and the learned stride-2 temporal downsample
whose first frame passes through.  Parameter names follow the diffusers
state dict (``decoder.*``, ``post_quant_conv.*``; with ``encoder=True``
also ``encoder.*`` and ``quant_conv.*``, the original's ``conv1``).

Public functions keep the JAX package's ``[B, T, H, W, C]`` layout; inside,
tensors are ``[B, C, T, H, W]`` for ``torch.nn.functional.conv3d``.  The
VAE runs in f32, as the reference runs the Wan VAE.

Streaming: every temporal conv takes and returns a cache of its last
``k_t - 1`` input frames (a temporal downsample, its last input frame), so
:func:`streaming_decode` decodes latent frame by latent frame, and
:func:`streaming_encode` encodes the first frame and then chunks of
``temporal_factor`` frames (the published encode loop), with bounded memory
and exactly the whole-clip result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from blade_torch.models.layers import init_lecun_
from blade_torch.utils import tracing

__all__ = ["WanVAEConfig", "WanVAE", "WAN21_VAE", "WAN21_VAE_TINY",
           "streaming_decode", "streaming_encode", "WAN21_LATENTS_MEAN",
           "WAN21_LATENTS_STD"]

# Published Wan2.1 per-channel latent statistics (vae/config.json of
# Wan-AI/Wan2.1-T2V-1.3B-Diffusers; applied as z * std + mean before decode).
WAN21_LATENTS_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
WAN21_LATENTS_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    in_channels: int = 3
    scaling_factor: float = 1.0
    latents_mean: Optional[Tuple[float, ...]] = WAN21_LATENTS_MEAN
    latents_std: Optional[Tuple[float, ...]] = WAN21_LATENTS_STD

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @property
    def temporal_factor(self) -> int:
        return 2 ** sum(self.temporal_downsample)

    @property
    def encoder_dims(self) -> Tuple[int, ...]:
        return tuple(self.base_dim * m for m in (1,) + tuple(self.dim_mult))

    @property
    def decoder_dims(self) -> Tuple[int, ...]:
        mult = tuple(self.dim_mult)
        return tuple(self.base_dim * m for m in (mult[-1],) + mult[::-1])


WAN21_VAE = WanVAEConfig()
# Tiny variant for CPU tests (same topology, 2 stages, 1 temporal up).
WAN21_VAE_TINY = WanVAEConfig(
    base_dim=8, dim_mult=(1, 2), num_res_blocks=1,
    temporal_downsample=(True,), latents_mean=None, latents_std=None,
)


class WanRMSNorm(nn.Module):
    """Channel RMS norm ``F.normalize(x, dim=C) * sqrt(C) * gamma``;
    ``gamma`` is ``(C, 1, 1, 1)`` (or ``(C, 1, 1)`` in attention blocks)."""

    def __init__(self, dim: int, images: bool = False, device=None):
        super().__init__()
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape, device=device))
        self.scale = math.sqrt(dim)

    def forward(self, x):  # [B, C, T, H, W]
        y = F.normalize(x.float(), dim=1, eps=1e-12) * self.scale
        return (y * self.gamma.reshape(-1, 1, 1, 1)).to(x.dtype)


class WanCausalConv3d(nn.Conv3d):
    """Causal 3-D conv: ``k_t - 1`` zero frames (or the cache) in front,
    zero spatial padding.  ``forward`` returns ``(y, new_cache)``; the cache
    holds the last ``pad_time`` frames of the time-padded input."""

    def __init__(self, in_dim, out_dim, kernel=(3, 3, 3), stride=(1, 1, 1),
                 pad_time: Optional[int] = None, device=None):
        super().__init__(in_dim, out_dim, kernel, stride=stride, device=device)
        self.pad_time = kernel[0] - 1 if pad_time is None else pad_time
        self.pad_hw = ((kernel[1] - 1) // 2, (kernel[2] - 1) // 2)

    def forward(self, x, cache=None):
        pt = self.pad_time
        if cache is not None:
            x = torch.cat([cache.to(x.dtype), x], dim=2)
        elif pt:
            b, c, _, h, w = x.shape
            x = torch.cat([x.new_zeros((b, c, pt, h, w)), x], dim=2)
        # clone: a view would keep the whole padded input alive.
        new_cache = x[:, :, x.shape[2] - pt:].clone() if pt else None
        y = F.conv3d(x, self.weight, self.bias, self.stride, (0,) + self.pad_hw)
        return y, new_cache


class WanResidualBlock(nn.Module):
    def __init__(self, in_dim, out_dim, device=None):
        super().__init__()
        self.norm1 = WanRMSNorm(in_dim, device=device)
        self.conv1 = WanCausalConv3d(in_dim, out_dim, device=device)
        self.norm2 = WanRMSNorm(out_dim, device=device)
        self.conv2 = WanCausalConv3d(out_dim, out_dim, device=device)
        self.conv_shortcut = (WanCausalConv3d(in_dim, out_dim, (1, 1, 1), device=device)
                              if in_dim != out_dim else None)

    def forward(self, x, cache=None):
        cache = cache or {}
        out = {}
        h, out["conv1"] = self.conv1(F.silu(self.norm1(x)), cache.get("conv1"))
        h, out["conv2"] = self.conv2(F.silu(self.norm2(h)), cache.get("conv2"))
        if self.conv_shortcut is not None:
            x, _ = self.conv_shortcut(x)
        return x + h, out


class WanAttentionBlock(nn.Module):
    """Single-head per-frame spatial self-attention (1x1-conv qkv / proj)."""

    def __init__(self, dim, device=None):
        super().__init__()
        self.norm = WanRMSNorm(dim, images=True, device=device)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1, device=device)
        self.proj = nn.Conv2d(dim, dim, 1, device=device)

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
        qkv = F.linear(y, self.to_qkv.weight[..., 0, 0], self.to_qkv.bias)
        q, k, v = qkv.chunk(3, dim=-1)
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(c), dim=-1)
        o = F.linear(torch.matmul(p, v), self.proj.weight[..., 0, 0], self.proj.bias)
        return x + o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


class WanResample(nn.Module):
    """``upsample2d`` / ``upsample3d`` / ``downsample2d`` / ``downsample3d``
    stage.  upsample3d: learned time conv (C -> 2C, interleaved to 2x
    frames; on a fresh stream the first frame bypasses it), then nearest 2x
    spatial + channel-halving 3x3 conv.  downsample: zero pad right and
    bottom + stride-2 3x3 conv; downsample3d then a stride-2 time conv
    (kernel 3) whose windows start at frame 0, frame 0 passing through on a
    fresh stream; its cache is the last input frame."""

    def __init__(self, dim: int, mode: str, device=None):
        super().__init__()
        self.mode = mode
        if mode.startswith("upsample"):
            self.resample = nn.ModuleList([
                nn.Upsample(scale_factor=(2.0, 2.0), mode="nearest"),
                nn.Conv2d(dim, dim // 2, 3, padding=1, device=device),
            ])
        else:
            self.resample = nn.ModuleList([
                nn.ZeroPad2d((0, 1, 0, 1)),
                nn.Conv2d(dim, dim, 3, stride=2, device=device),
            ])
        self.time_conv = None
        if mode == "upsample3d":
            self.time_conv = WanCausalConv3d(dim, dim * 2, (3, 1, 1), pad_time=2,
                                             device=device)
        elif mode == "downsample3d":
            self.time_conv = WanCausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1),
                                             pad_time=0, device=device)

    @staticmethod
    def _interleave(y):
        """``[B, 2C, T, H, W] -> [B, C, 2T, H, W]``: channel half s of frame t
        becomes frame 2t + s."""
        b, c2, t, h, w = y.shape
        y = y.reshape(b, 2, c2 // 2, t, h, w).permute(0, 2, 3, 1, 4, 5)
        return y.reshape(b, c2 // 2, 2 * t, h, w)

    def forward(self, x, cache=None):
        cache = cache or {}
        out = {}
        if self.mode == "upsample3d":
            if "time_conv" not in cache:
                first, rest = x[:, :, :1], x[:, :, 1:]
                if rest.shape[2]:
                    y, out["time_conv"] = self.time_conv(rest, None)
                    x = torch.cat([first, self._interleave(y)], dim=2)
                else:
                    x = first
                    _, out["time_conv"] = self.time_conv(torch.zeros_like(first), None)
            else:
                y, out["time_conv"] = self.time_conv(x, cache["time_conv"])
                x = self._interleave(y)
        b, c, t, h, w = x.shape
        y = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
        y = self.resample[1](self.resample[0](y))
        x = y.reshape(b, t, *y.shape[1:]).permute(0, 2, 1, 3, 4)
        if self.mode == "downsample3d":
            last = x[:, :, -1:].clone()
            if "time_conv" not in cache:  # fresh: frame 0 passes through
                y = self.time_conv(x)[0] if x.shape[2] >= 3 else x[:, :, :0]
                x = torch.cat([x[:, :, :1], y], dim=2)
            else:
                x, _ = self.time_conv(torch.cat([cache["time_conv"].to(x.dtype), x], dim=2))
            out["time_conv"] = last
        return x, out


class WanMidBlock(nn.Module):
    def __init__(self, dim, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(dim, dim, device),
                                      WanResidualBlock(dim, dim, device)])
        self.attentions = nn.ModuleList([WanAttentionBlock(dim, device)])

    def forward(self, x, cache=None):
        cache = cache or {}
        out = {}
        x, out["resnets_0"] = self.resnets[0](x, cache.get("resnets_0"))
        x = self.attentions[0](x)
        x, out["resnets_1"] = self.resnets[1](x, cache.get("resnets_1"))
        return x, out


class WanEncoder3d(nn.Module):
    """diffusers ``WanEncoder3d``: ``conv_in``, a flat list ``down_blocks``
    (``num_res_blocks`` residual blocks a stage, then its downsample),
    ``mid_block``, ``norm_out``, ``conv_out`` to ``2 z_dim`` channels (mean
    and log-variance)."""

    def __init__(self, cfg: WanVAEConfig, device=None):
        super().__init__()
        c = cfg
        dims = c.encoder_dims
        self.conv_in = WanCausalConv3d(c.in_channels, dims[0], device=device)
        downs = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for j in range(c.num_res_blocks):
                downs.append(WanResidualBlock(in_dim if j == 0 else out_dim, out_dim, device))
            if i != len(c.dim_mult) - 1:
                mode = "downsample3d" if c.temporal_downsample[i] else "downsample2d"
                downs.append(WanResample(out_dim, mode, device))
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = WanMidBlock(dims[-1], device)
        self.norm_out = WanRMSNorm(dims[-1], device=device)
        self.conv_out = WanCausalConv3d(dims[-1], 2 * c.z_dim, device=device)

    def forward(self, x, cache=None):
        cache = cache or {}
        out = {}
        x, out["conv_in"] = self.conv_in(x, cache.get("conv_in"))
        for i, blk in enumerate(self.down_blocks):
            x, out[f"down_blocks_{i}"] = blk(x, cache.get(f"down_blocks_{i}"))
        x, out["mid_block"] = self.mid_block(x, cache.get("mid_block"))
        x, out["conv_out"] = self.conv_out(F.silu(self.norm_out(x)), cache.get("conv_out"))
        return x, out


class WanUpBlock(nn.Module):
    def __init__(self, in_dim, out_dim, num_res, upsample_mode, device=None):
        super().__init__()
        dims = [in_dim] + [out_dim] * num_res
        self.resnets = nn.ModuleList([WanResidualBlock(dims[j], out_dim, device)
                                      for j in range(num_res)])
        self.upsamplers = (nn.ModuleList([WanResample(out_dim, upsample_mode, device)])
                           if upsample_mode is not None else None)

    def forward(self, x, cache=None):
        cache = cache or {}
        out = {}
        for j, res in enumerate(self.resnets):
            x, out[f"resnets_{j}"] = res(x, cache.get(f"resnets_{j}"))
        if self.upsamplers is not None:
            x, out["upsamplers_0"] = self.upsamplers[0](x, cache.get("upsamplers_0"))
        return x, out


class WanDecoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None):
        super().__init__()
        c = cfg
        dims = c.decoder_dims
        temporal_up = c.temporal_downsample[::-1]
        self.conv_in = WanCausalConv3d(c.z_dim, dims[0], device=device)
        self.mid_block = WanMidBlock(dims[0], device)
        ups = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            if i > 0:
                in_dim = in_dim // 2  # the preceding upsample halved C
            mode = None
            if i != len(c.dim_mult) - 1:
                mode = "upsample3d" if temporal_up[i] else "upsample2d"
            ups.append(WanUpBlock(in_dim, out_dim, c.num_res_blocks + 1, mode, device))
        self.up_blocks = nn.ModuleList(ups)
        self.norm_out = WanRMSNorm(dims[-1], device=device)
        self.conv_out = WanCausalConv3d(dims[-1], c.in_channels, device=device)

    def forward(self, z, cache=None):
        cache = cache or {}
        out = {}
        x, out["conv_in"] = self.conv_in(z, cache.get("conv_in"))
        x, out["mid_block"] = self.mid_block(x, cache.get("mid_block"))
        for i, up in enumerate(self.up_blocks):
            x, out[f"up_blocks_{i}"] = up(x, cache.get(f"up_blocks_{i}"))
        x, out["conv_out"] = self.conv_out(F.silu(self.norm_out(x)),
                                           cache.get("conv_out"))
        return x, out


class WanVAE(nn.Module):
    """AutoencoderKLWan decode path: ``post_quant_conv`` + ``decoder``; with
    ``encoder=True`` also its encode path, ``encoder`` + ``quant_conv``
    (registered after the decode path, so the decoder's random draws are
    the same either way)."""

    def __init__(self, cfg: WanVAEConfig = WAN21_VAE, *, encoder: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = WanDecoder3d(cfg, device)
        self.post_quant_conv = WanCausalConv3d(cfg.z_dim, cfg.z_dim, (1, 1, 1),
                                               device=device)
        if encoder:
            self.encoder = WanEncoder3d(cfg, device)
            self.quant_conv = WanCausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1),
                                              device=device)

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "WanVAE":
        """flax-default random weights: lecun-normal convs, zero biases."""
        init_lecun_(self, generator)
        return self

    def decode_with_cache(self, z, cache=None):
        """Latent chunk ``[B, C, T, H, W]`` + carried conv caches -> frames
        ``[B, 3, T', H', W']`` (raw; the caller clips) and the new caches.
        Frame 0 must be in the first chunk (``cache=None`` there)."""
        cache = cache or {}
        z, _ = self.post_quant_conv(z.float())
        x, dec = self.decoder(z, cache.get("decoder"))
        return x, {"decoder": dec}

    def decode(self, z):
        """Whole clip ``[B, T, H, W, C]`` -> ``[B, T', H', W', 3]`` (raw)."""
        x, _ = self.decode_with_cache(z.permute(0, 4, 1, 2, 3))
        return x.permute(0, 2, 3, 4, 1)

    def encode_with_cache(self, video, cache=None):
        """Frame chunk ``[B, 3, T, H, W]`` + carried conv caches -> the
        posterior mean ``[B, z, T', H', W']`` (raw, f32) and the new caches.
        Frame 0 must be in the first chunk (``cache=None`` there)."""
        cache = cache or {}
        h, enc = self.encoder(video.float(), cache.get("encoder"))
        moments, _ = self.quant_conv(h)
        return moments[:, :self.cfg.z_dim], {"encoder": enc}

    def encode(self, video):
        """Whole clip ``[B, T, H, W, 3]`` -> the posterior mean ``[B, T', H',
        W', z]`` (raw: the JAX package's ``WanVAE.encode`` with no rng)."""
        mu, _ = self.encode_with_cache(video.permute(0, 4, 1, 2, 3))
        return mu.permute(0, 2, 3, 4, 1)

    def normalize(self, mu):
        """``(mu - latents_mean) / latents_std`` over the last (channel)
        axis, where the configuration has the statistics; else ``mu``."""
        c = self.cfg
        if c.latents_mean is None:
            return mu
        mean = torch.tensor(c.latents_mean, device=mu.device, dtype=mu.dtype)
        std = torch.tensor(c.latents_std, device=mu.device, dtype=mu.dtype)
        return (mu - mean) / std


def streaming_decode(vae: WanVAE, z: torch.Tensor):
    """Memory-bounded decode of ``z [B, T, H, W, C]`` -> ``[B, T', H', W', 3]``:
    a loop over latent frames with exact conv-state carry."""
    zc = z.permute(0, 4, 1, 2, 3)
    cache = None
    pieces = []
    for start in range(zc.shape[2]):
        with tracing.span("decode.chunk"):
            piece, cache = vae.decode_with_cache(zc[:, :, start:start + 1], cache)
            pieces.append(piece.permute(0, 2, 3, 4, 1))
    return torch.cat(pieces, dim=1)


def streaming_encode(vae: WanVAE, video: torch.Tensor):
    """Memory-bounded encode of ``video [B, T, H, W, 3]`` (``T = 1 + k
    temporal_factor``) -> the posterior mean ``[B, T', H', W', z]`` (raw):
    frame 0, then chunks of ``temporal_factor`` frames, with exact
    conv-state carry (the published encode loop)."""
    step = vae.cfg.temporal_factor
    t = video.shape[1]
    if (t - 1) % step:
        raise ValueError(f"streaming_encode: {t} frames is not 1 + a multiple of {step}")
    xc = video.permute(0, 4, 1, 2, 3)
    cache = None
    pieces = []
    for start, end in [(0, 1)] + [(s, s + step) for s in range(1, t, step)]:
        with tracing.span("encode.chunk"):
            piece, cache = vae.encode_with_cache(xc[:, :, start:end], cache)
            pieces.append(piece.permute(0, 2, 3, 4, 1))
    return torch.cat(pieces, dim=1)
