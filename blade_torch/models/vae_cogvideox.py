"""CogVideoX causal video VAE, decoder half, with chunked decode (PyTorch).

Counterpart of ``blade/models/vae_cogvideox.py`` (``AutoencoderKLCogVideoX``
parity): causal temporal convs that pad a fresh stream by repeating frame
0, GroupNorm over (C/g, T, H, W) of the chunk, decoder resnets normalised by
``SpatialNorm3D`` (GroupNorm modulated by 1x1x1 convs of the latent ``zq``
resized to the feature map, the first frame resized apart when the length
is odd), nearest 2x upsampling in space and, in the first
``temporal_compress_level`` up blocks, in time (an odd chunk's first frame
upsampled in space only), and a plain 1x1x1 shortcut conv.  Parameter
names follow the diffusers state dict (``decoder.*``).  The encoder is not
ported yet.

Public functions keep the JAX package's ``[B, T, H, W, C]`` layout; inside,
tensors are ``[B, C, T, H, W]``.  The decode runs in f32.

:func:`chunked_decode` decodes ``frame_batch`` latent frames at a time with
the conv caches carried (the first chunk takes the remainder, so it is odd
and holds the image-coded first frame), exactly diffusers'
``num_latent_frames_batch_size=2`` decode: GroupNorm statistics are per
chunk, which is part of the reference numerics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from blade_torch.models.layers import init_lecun_
from blade_torch.utils import tracing

__all__ = ["CogVideoXVAEConfig", "CogVideoXVAE", "COGVIDEOX_VAE_FULL", "COGVIDEOX_VAE_TINY",
           "chunked_decode"]


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    latent_channels: int = 16
    norm_groups: int = 32
    temporal_compress_level: int = 2  # log2(temporal_compression_ratio)
    in_channels: int = 3
    scaling_factor: float = 1.15258426
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @property
    def temporal_factor(self) -> int:
        return 2 ** self.temporal_compress_level


COGVIDEOX_VAE_FULL = CogVideoXVAEConfig()
COGVIDEOX_VAE_TINY = CogVideoXVAEConfig(
    block_out_channels=(8, 16), layers_per_block=1, norm_groups=4,
    temporal_compress_level=1,
)


class CogCausalConv3d(nn.Module):
    """Causal 3-D conv (diffusers ``CogVideoXCausalConv3d``: the weights sit
    in an inner ``conv``).  A fresh stream pads time by repeating frame 0;
    ``forward`` returns ``(y, cache)``, the cache being the last ``k_t - 1``
    frames of the time-padded input."""

    def __init__(self, in_dim, out_dim, kernel=(3, 3, 3), device=None):
        super().__init__()
        self.conv = nn.Conv3d(in_dim, out_dim, kernel, device=device)
        self.pad_time = kernel[0] - 1
        self.pad_hw = ((kernel[1] - 1) // 2, (kernel[2] - 1) // 2)

    def forward(self, x, cache=None):
        pt = self.pad_time
        if pt:
            front = cache.to(x.dtype) if cache is not None else x[:, :, :1].expand(
                -1, -1, pt, -1, -1)
            x = torch.cat([front, x], dim=2)
        # clone: a view would keep the whole padded input alive.
        new_cache = x[:, :, x.shape[2] - pt:].clone() if pt else None
        y = F.conv3d(x, self.conv.weight, self.conv.bias, 1, (0,) + self.pad_hw)
        return y, new_cache


def _resize_nearest(x, t, h, w):
    """Nearest resize of ``[B, C, T', H', W']`` by integer factors."""
    for dim, target in zip((2, 3, 4), (t, h, w)):
        if target != x.shape[dim]:
            if target % x.shape[dim]:
                raise ValueError(f"non-integer resize {tuple(x.shape)} -> {(t, h, w)}")
            x = x.repeat_interleave(target // x.shape[dim], dim=dim)
    return x


class CogSpatialNorm3D(nn.Module):
    """``GroupNorm(f) * conv_y(zq) + conv_b(zq)``, ``zq`` nearest-resized to
    ``f`` (its first frame apart when ``f``'s length is odd and above 1)."""

    def __init__(self, f_channels, zq_channels, groups, device=None):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, f_channels, eps=1e-6, device=device)
        self.conv_y = CogCausalConv3d(zq_channels, f_channels, (1, 1, 1), device)
        self.conv_b = CogCausalConv3d(zq_channels, f_channels, (1, 1, 1), device)

    def forward(self, f, zq):
        t, h, w = f.shape[2:]
        if t > 1 and t % 2 == 1:
            zq = torch.cat([_resize_nearest(zq[:, :, :1], 1, h, w),
                            _resize_nearest(zq[:, :, 1:], t - 1, h, w)], dim=2)
        else:
            zq = _resize_nearest(zq, t, h, w)
        y, _ = self.conv_y(zq)
        b, _ = self.conv_b(zq)
        n = self.norm_layer
        return F.group_norm(f.float(), n.num_groups, n.weight, n.bias, n.eps) * y + b


class CogResnetBlock3D(nn.Module):
    def __init__(self, in_dim, out_dim, groups, zq_channels, device=None):
        super().__init__()
        self.norm1 = CogSpatialNorm3D(in_dim, zq_channels, groups, device)
        self.conv1 = CogCausalConv3d(in_dim, out_dim, device=device)
        self.norm2 = CogSpatialNorm3D(out_dim, zq_channels, groups, device)
        self.conv2 = CogCausalConv3d(out_dim, out_dim, device=device)
        # plain (non-causal) 1x1x1 conv in diffusers
        self.conv_shortcut = (nn.Conv3d(in_dim, out_dim, 1, device=device)
                              if in_dim != out_dim else None)

    def forward(self, x, zq, cache=None):
        cache = cache or {}
        out = {}
        h, out["conv1"] = self.conv1(F.silu(self.norm1(x, zq)), cache.get("conv1"))
        h, out["conv2"] = self.conv2(F.silu(self.norm2(h, zq)), cache.get("conv2"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h, out


class CogUpsample3D(nn.Module):
    """Nearest 2x upsample (also in time when ``compress_time``; an odd
    chunk's first frame in space only), then a 3x3 conv per frame."""

    def __init__(self, dim, compress_time, device=None):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(dim, dim, 3, padding=1, device=device)

    def forward(self, x):
        t = x.shape[2]
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        if self.compress_time and t > 1:
            if t % 2 == 1:
                x = torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)
            else:
                x = x.repeat_interleave(2, dim=2)
        b, c, tt, h, w = x.shape
        y = self.conv(x.transpose(1, 2).reshape(b * tt, c, h, w))
        return y.reshape(b, tt, c, h, w).transpose(1, 2)


class CogUpBlock3D(nn.Module):
    def __init__(self, in_dim, out_dim, num_layers, groups, zq_channels, add_upsample,
                 compress_time, device=None):
        super().__init__()
        dims = [in_dim] + [out_dim] * num_layers
        self.resnets = nn.ModuleList([
            CogResnetBlock3D(dims[j], out_dim, groups, zq_channels, device)
            for j in range(num_layers)])
        self.upsamplers = (nn.ModuleList([CogUpsample3D(out_dim, compress_time, device)])
                           if add_upsample else None)

    def forward(self, x, zq, cache=None):
        cache = cache or {}
        out = {}
        for j, res in enumerate(self.resnets):
            x, out[f"resnets_{j}"] = res(x, zq, cache.get(f"resnets_{j}"))
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x, out


class CogMidBlock3D(nn.Module):
    def __init__(self, dim, groups, zq_channels, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([CogResnetBlock3D(dim, dim, groups, zq_channels, device)
                                      for _ in range(2)])

    def forward(self, x, zq, cache=None):
        cache = cache or {}
        out = {}
        for j, res in enumerate(self.resnets):
            x, out[f"resnets_{j}"] = res(x, zq, cache.get(f"resnets_{j}"))
        return x, out


class CogDecoder3D(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, device=None):
        super().__init__()
        c = cfg
        rev = tuple(reversed(c.block_out_channels))
        self.conv_in = CogCausalConv3d(c.latent_channels, rev[0], device=device)
        self.mid_block = CogMidBlock3D(rev[0], c.norm_groups, c.latent_channels, device)
        ups, d = [], rev[0]
        for i, ch in enumerate(rev):
            ups.append(CogUpBlock3D(d, ch, c.layers_per_block + 1, c.norm_groups,
                                    c.latent_channels, add_upsample=i < len(rev) - 1,
                                    compress_time=i < c.temporal_compress_level,
                                    device=device))
            d = ch
        self.up_blocks = nn.ModuleList(ups)
        self.norm_out = CogSpatialNorm3D(rev[-1], c.latent_channels, c.norm_groups, device)
        self.conv_out = CogCausalConv3d(rev[-1], c.in_channels, device=device)

    def forward(self, z, cache=None):
        cache = cache or {}
        out = {}
        x, out["conv_in"] = self.conv_in(z, cache.get("conv_in"))
        x, out["mid_block"] = self.mid_block(x, z, cache.get("mid_block"))
        for i, up in enumerate(self.up_blocks):
            x, out[f"up_blocks_{i}"] = up(x, z, cache.get(f"up_blocks_{i}"))
        x, out["conv_out"] = self.conv_out(F.silu(self.norm_out(x, z)), cache.get("conv_out"))
        return x, out


class CogVideoXVAE(nn.Module):
    """``AutoencoderKLCogVideoX`` decode path (this family has no quant
    convs)."""

    def __init__(self, cfg: CogVideoXVAEConfig = COGVIDEOX_VAE_FULL, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = CogDecoder3D(cfg, device)

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "CogVideoXVAE":
        """flax-default random weights: lecun-normal convs, zero biases."""
        init_lecun_(self, generator)
        return self

    def decode_with_cache(self, z, cache=None):
        """Latent chunk ``[B, C, T, H, W]`` + carried conv caches -> frames
        ``[B, 3, T', H', W']`` (raw; the caller clips) and the new caches."""
        cache = cache or {}
        x, dec = self.decoder(z.float(), cache.get("decoder"))
        return x, {"decoder": dec}

    def decode(self, z):
        """Whole clip ``[B, T, H, W, C]`` -> ``[B, T', H', W', 3]`` (raw)."""
        x, _ = self.decode_with_cache(z.permute(0, 4, 1, 2, 3))
        return x.permute(0, 2, 3, 4, 1)


def chunked_decode(vae: CogVideoXVAE, z: torch.Tensor, *, frame_batch: int = 2):
    """``z [B, T, H, W, C]`` -> ``[B, T', H', W', 3]`` in latent-frame chunks
    of ``frame_batch`` (the first chunk takes the remainder) with the conv
    caches carried."""
    t = z.shape[1]
    rem = t % frame_batch
    bounds = [0, frame_batch + rem] if t > frame_batch else [0, t]
    while bounds[-1] < t:
        bounds.append(min(bounds[-1] + frame_batch, t))
    zc = z.permute(0, 4, 1, 2, 3)
    cache, pieces = None, []
    for s, e in zip(bounds[:-1], bounds[1:]):
        with tracing.span("decode.chunk"):
            piece, cache = vae.decode_with_cache(zc[:, :, s:e], cache)
            pieces.append(piece.permute(0, 2, 3, 4, 1))
    return torch.cat(pieces, dim=1)
