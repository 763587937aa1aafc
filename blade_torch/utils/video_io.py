"""Video export (counterpart of ``blade/utils/video_io.py``) and the
first-frame image an image-to-video run reads."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["to_uint8_frames", "export_video", "read_image"]


def to_uint8_frames(video: np.ndarray) -> np.ndarray:
    """[-1, 1] float [T, H, W, C] -> uint8 frames."""
    video = np.clip((np.asarray(video, np.float32) + 1.0) * 127.5, 0, 255)
    return video.astype(np.uint8)


def export_video(video: np.ndarray, path: str, fps: int = 8) -> str:
    """Write a [T, H, W, C] video (float in [-1, 1], or uint8).

    mp4 through imageio's ffmpeg backend where it exists; a GIF (pillow)
    with the extension swapped where it does not; a ``.npy`` array where
    imageio itself is not installed.  Returns the path actually written.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames = video if video.dtype == np.uint8 else to_uint8_frames(video)
    try:
        import imageio.v3 as iio
    except ImportError:
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, frames)
        return alt
    try:
        iio.imwrite(path, frames, fps=fps)
        return path
    except (OSError, ValueError, RuntimeError):
        alt = os.path.splitext(path)[0] + ".gif"
        iio.imwrite(alt, frames, duration=int(1000 / fps), loop=0)
        return alt


def _png_rows(data: bytes, height: int, width: int, channels: int) -> np.ndarray:
    """Undo PNG's per-row filters (8-bit samples) -> ``[H, W, channels]``."""
    stride = width * channels
    raw = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        kind, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind in (0, 2):  # none, up
            cur = (row + (prev if kind == 2 else 0)) & 255
        else:  # sub, average, paeth: left-dependent, a pixel at a time
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b, c = prev[x], prev[x - channels] if x >= channels else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (row[x] + pred) & 255
        out[y] = prev = cur
    return out.astype(np.uint8).reshape(height, width, channels)


def read_image(path: str) -> np.ndarray:
    """An RGB image ``[H, W, 3]`` uint8 from an 8-bit non-interlaced PNG at
    ``path`` (gray, gray + alpha, RGB or RGBA; alpha dropped)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    width, height, depth, color, _, _, interlace = head
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNG is read")
    img = _png_rows(zlib.decompress(b"".join(idat)), height, width, channels)
    return np.ascontiguousarray(img[..., :3] if channels >= 3 else np.repeat(img[..., :1], 3, -1))
