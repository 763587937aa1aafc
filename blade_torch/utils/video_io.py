"""Video export (counterpart of ``blade/utils/video_io.py``)."""

from __future__ import annotations

import os

import numpy as np

__all__ = ["to_uint8_frames", "export_video"]


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
