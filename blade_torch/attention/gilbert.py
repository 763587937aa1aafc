"""Generalized-Hilbert ("gilbert") 3-D space-filling curve and token reordering.

Counterpart of ``blade/attention/gilbert.py``.  ASA reorders video latent
tokens along a 3-D space-filling curve before block-sparse attention so that
spatio-temporally adjacent tokens land in the same 128-token block.  The
curve is an iterative (explicit-stack) generalized Hilbert curve for
arbitrary cuboids (J. Cerveny's "gilbert" algorithm, BSD-2), computed once
per geometry on the host in numpy; on the device the reorder is one
``index_select``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "gilbert3d_coords",
    "gilbert_permutations",
    "rearrange_tokens",
    "unrearrange_tokens",
]


def _sgn(v: int) -> int:
    return (v > 0) - (v < 0)


def gilbert3d_coords(width: int, height: int, depth: int) -> np.ndarray:
    """Return the (N, 3) array of (x, y, z) coordinates visited by the curve.

    Visits every cell of a ``width x height x depth`` cuboid exactly once;
    consecutive cells are (almost always) face-adjacent, which is the locality
    property ASA relies on.
    """
    # Initial major axis = the longest extent, mirroring the reference's
    # dispatch (gilbert3d.py:13-29).
    if width >= height and width >= depth:
        job = ((0, 0, 0), (width, 0, 0), (0, height, 0), (0, 0, depth))
    elif height >= width and height >= depth:
        job = ((0, 0, 0), (0, height, 0), (width, 0, 0), (0, 0, depth))
    else:
        job = ((0, 0, 0), (0, 0, depth), (width, 0, 0), (0, height, 0))

    out = np.empty((width * height * depth, 3), dtype=np.int64)
    n = 0
    # Explicit stack of (origin, axis_a, axis_b, axis_c); children pushed in
    # reverse so they pop in curve order.
    stack = [job]
    while stack:
        (p, a, b, c) = stack.pop()
        x, y, z = p
        ax, ay, az = a
        bx, by, bz = b
        cx, cy, cz = c
        w = abs(ax + ay + az)
        h = abs(bx + by + bz)
        d = abs(cx + cy + cz)
        da = (_sgn(ax), _sgn(ay), _sgn(az))
        db = (_sgn(bx), _sgn(by), _sgn(bz))
        dc = (_sgn(cx), _sgn(cy), _sgn(cz))

        # Degenerate cuboids reduce to straight line fills.
        if h == 1 and d == 1:
            for _ in range(w):
                out[n] = (x, y, z)
                n += 1
                x, y, z = x + da[0], y + da[1], z + da[2]
            continue
        if w == 1 and d == 1:
            for _ in range(h):
                out[n] = (x, y, z)
                n += 1
                x, y, z = x + db[0], y + db[1], z + db[2]
            continue
        if w == 1 and h == 1:
            for _ in range(d):
                out[n] = (x, y, z)
                n += 1
                x, y, z = x + dc[0], y + dc[1], z + dc[2]
            continue

        a2 = [ax // 2, ay // 2, az // 2]
        b2 = [bx // 2, by // 2, bz // 2]
        c2 = [cx // 2, cy // 2, cz // 2]
        w2 = abs(a2[0] + a2[1] + a2[2])
        h2 = abs(b2[0] + b2[1] + b2[2])
        d2 = abs(c2[0] + c2[1] + c2[2])
        if (w2 % 2) and (w > 2):
            a2 = [a2[0] + da[0], a2[1] + da[1], a2[2] + da[2]]
        if (h2 % 2) and (h > 2):
            b2 = [b2[0] + db[0], b2[1] + db[1], b2[2] + db[2]]
        if (d2 % 2) and (d > 2):
            c2 = [c2[0] + dc[0], c2[1] + dc[1], c2[2] + dc[2]]
        a2 = tuple(a2)
        b2 = tuple(b2)
        c2 = tuple(c2)

        def vsub(u, v):
            return (u[0] - v[0], u[1] - v[1], u[2] - v[2])

        def vneg(u):
            return (-u[0], -u[1], -u[2])

        def vadd(*us):
            return tuple(sum(t) for t in zip(*us))

        ra = vsub(a, a2)  # remainder halves
        rb = vsub(b, b2)
        rc = vsub(c, c2)

        if (2 * w > 3 * h) and (2 * w > 3 * d):
            # Wide: split along the major axis only.
            parts = [
                (p, a2, b, c),
                (vadd(p, a2), ra, b, c),
            ]
        elif 3 * h > 4 * d:
            # Tall: split along a and b, not c.
            parts = [
                (p, b2, c, a2),
                (vadd(p, b2), a, rb, c),
                (
                    vadd(p, vsub(a, da), vsub(b2, db)),
                    vneg(b2),
                    c,
                    vneg(ra),
                ),
            ]
        elif 3 * d > 4 * h:
            # Deep: split along a and c, not b.
            parts = [
                (p, c2, a2, b),
                (vadd(p, c2), a, b, rc),
                (
                    vadd(p, vsub(a, da), vsub(c2, dc)),
                    vneg(c2),
                    vneg(ra),
                    b,
                ),
            ]
        else:
            # Regular: full octant-style split into five sub-cuboids.
            parts = [
                (p, b2, c2, a2),
                (vadd(p, b2), c, a2, rb),
                (vadd(p, vsub(b2, db), vsub(c, dc)), a, vneg(b2), vneg(rc)),
                (vadd(p, vsub(a, da), b2, vsub(c, dc)), vneg(c), vneg(ra), rb),
                (vadd(p, vsub(a, da), vsub(b2, db)), vneg(b2), c2, vneg(ra)),
            ]
        stack.extend(reversed(parts))

    assert n == width * height * depth
    return out


@functools.lru_cache(maxsize=32)
def gilbert_permutations(width: int, height: int, depth: int):
    """Static permutation pair for a (W, H, T) latent token grid.

    Token flat index is ``x + width * (y + height * z)`` (x fastest), the
    row-major order of a ``[T, H, W]`` latent.  Returns int32 numpy arrays
    ``(perm, inv_perm)`` of shape ``[W*H*T]``: ``x[perm]`` lists tokens in
    curve order and ``y[inv_perm]`` undoes it.  The arrays are cached and
    shared; callers must not write to them.
    """
    coords = gilbert3d_coords(width, height, depth)
    perm = (coords[:, 0] + width * (coords[:, 1] + height * coords[:, 2])
            ).astype(np.int32)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.size, dtype=np.int32)
    perm.setflags(write=False)
    inv_perm.setflags(write=False)
    return perm, inv_perm


def _take(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    index = torch.from_numpy(idx.astype(np.int64)).to(x.device)
    return torch.index_select(x, x.dim() - 2, index)


def rearrange_tokens(x: torch.Tensor, perm: np.ndarray, text_length: int = 0):
    """Permute the video segment of ``x [..., text_length + W*H*T, D]`` into
    curve order.  The text segment (first) moves to the end so the video
    grid stays 128-block aligned; with ``text_length == 0`` (Wan) this is a
    pure permutation."""
    if text_length:
        text, video = x[..., :text_length, :], x[..., text_length:, :]
        return torch.cat([_take(video, perm), text], dim=-2)
    return _take(x, perm)


def unrearrange_tokens(x: torch.Tensor, inv_perm: np.ndarray, text_length: int = 0):
    """Inverse of :func:`rearrange_tokens`; restores the [text, video] layout."""
    if text_length:
        video, text = x[..., :-text_length, :], x[..., -text_length:, :]
        return torch.cat([text, _take(video, inv_perm)], dim=-2)
    return _take(x, inv_perm)
