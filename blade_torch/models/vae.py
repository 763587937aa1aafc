"""Spatially tiled VAE decode (diffusers ``enable_tiling`` semantics).

Counterpart of ``blade/models/vae.py::uniform_tiling`` and
``tiled_decode``; the generic tiny VAE of that module is not ported (the
port's tiny presets use the family VAEs).  Tiling is part of the reference
numerics of the CogVideoX decode (each tile is decoded on its own, with its
own GroupNorm statistics, and the overlaps are crossfaded), so the port
keeps it although one card would hold the untiled decode.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from blade_torch.utils import tracing

__all__ = ["uniform_tiling", "tiled_decode"]


def uniform_tiling(dim: int, max_tile: int) -> Tuple[int, int]:
    """``(tile, overlap)`` splitting ``dim`` into EQUAL tiles of at most
    ``max_tile`` with a 4-12 latent-pixel overlap; ``(dim, 0)`` when no
    tiling is needed."""
    if dim <= max_tile:
        return dim, 0
    for n in range(2, dim):
        for ov in (6, 8, 4, 9, 12, 10, 5, 7, 11):
            if (dim + ov * (n - 1)) % n == 0:
                tile = (dim + ov * (n - 1)) // n
                if ov < tile <= max_tile:
                    return tile, ov
    return max_tile, 4


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def tiled_decode(
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    *,
    tile_latent: Union[int, Tuple[int, int]] = 32,
    overlap: Union[int, Tuple[int, int]] = 4,
    spatial_factor: int = 8,
) -> torch.Tensor:
    """Decode ``z [B, T, H, W, C]`` in spatial tiles of ``tile_latent``
    latent pixels (per axis ``(h, w)`` or one int) overlapping by
    ``overlap``; the decoded tiles are joined with a linear crossfade over
    the ``overlap * spatial_factor`` overlapping pixels (rows of a tile row
    first, then the rows)."""
    _, _, h, w, _ = z.shape
    tile_h, tile_w = _pair(tile_latent)
    ov_h, ov_w = _pair(overlap)
    def tile(i0, j0):
        with tracing.span("decode.tile"):
            return decode_fn(z[:, :, i0:i0 + tile_h, j0:j0 + tile_w])

    rows = [[tile(i0, j0) for j0 in range(0, max(w - ov_w, 1), tile_w - ov_w)]
            for i0 in range(0, max(h - ov_h, 1), tile_h - ov_h)]

    def blend(a, b, dim, ov):
        ov *= spatial_factor
        shape = [1] * a.dim()
        shape[dim] = ov
        ramp = torch.linspace(0, 1, ov, device=a.device, dtype=a.dtype).reshape(shape)
        n = a.shape[dim]
        mixed = a.narrow(dim, n - ov, ov) * (1 - ramp) + b.narrow(dim, 0, ov) * ramp
        return torch.cat([a.narrow(dim, 0, n - ov), mixed,
                          b.narrow(dim, ov, b.shape[dim] - ov)], dim=dim)

    joined = []
    for cols in rows:
        acc = cols[0]
        for nxt in cols[1:]:
            acc = blend(acc, nxt, 3, ov_w)
        joined.append(acc)
    out = joined[0]
    for nxt in joined[1:]:
        out = blend(out, nxt, 2, ov_h)
    return out
