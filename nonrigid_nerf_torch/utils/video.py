"""mp4 writing (counterpart of nonrigid_nerf_tpu/utils/video.py).

The JAX package tries imageio's ffmpeg writer, then OpenCV's, and prints
the failure. Neither the GPU machine nor the test machine has imageio's
ffmpeg plugin, so the port writes with OpenCV alone and reports, where
OpenCV does not import, that there is no writer.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def _opencv_writer(path: str, frames_u8, fps: int = 30) -> None:
    import cv2
    frames_u8 = np.asarray(frames_u8)
    if frames_u8.ndim == 3:     # grayscale -> rgb
        frames_u8 = np.stack([frames_u8] * 3, -1)
    h, w = frames_u8.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"OpenCV's VideoWriter did not open {path}")
    try:
        for frame in frames_u8:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))  # RGB -> BGR
    finally:
        writer.release()


def mp4_writer() -> Optional[Callable]:
    """fn(path, frames_u8 (F, H, W[, 3]) uint8, fps=30) writing an mp4 with
    OpenCV, or None where OpenCV does not import."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return None
    return _opencv_writer


def write_video(path: str, frames_u8, fps: int = 30) -> bool:
    """frames_u8: (F, H, W[, 3]) uint8. Writes an mp4 with OpenCV; prints
    why and returns False where it cannot (reference: train.py:1736-1781
    swallows the failure with a hint)."""
    writer = mp4_writer()
    if writer is None:
        print(f"video write failed for {path}: no mp4 writer imports "
              "(OpenCV)", flush=True)
        return False
    try:
        writer(path, frames_u8, fps=fps)
        return True
    except (OSError, RuntimeError, ValueError) as e:
        print(f"video write failed for {path}: {e}", flush=True)
        return False
