"""Frames to video.

Port of ``scnerf_tpu/tools/video.py``: with ``imageio`` and an ffmpeg
backend the frames become an mp4, as in the JAX package; otherwise (no
``imageio``, or no backend that encodes the file) the same ``uint8`` frames
go into ``<out_path>.npz`` under ``frames``, the file the JAX module writes
when its encoding fails. Both functions say which file they wrote.
"""
from __future__ import annotations

import os

import numpy as np

from scnerf_tpu_torch.core.imaging import read_png


def _write(frames8: np.ndarray, out_path: str, fps: int) -> str:
    """``(T, H, W, 3)`` uint8 frames to ``out_path`` or its ``.npz``; the
    path written."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        try:
            imageio.mimwrite(out_path, list(frames8), fps=fps, quality=8)
            return out_path
        except (ValueError, RuntimeError, OSError):  # no backend for the format
            pass
    np.savez_compressed(out_path + ".npz", frames=frames8)
    return out_path + ".npz"


def frames_to_video(frame_dir: str, out_path: str, fps: int = 30) -> int:
    """Encode every PNG in ``frame_dir`` (sorted) into a video; returns the
    frame count and prints the file written."""
    files = [os.path.join(frame_dir, f) for f in sorted(os.listdir(frame_dir))
             if f.endswith(".png")]
    if not files:
        return 0
    path = _write(np.stack([read_png(f) for f in files]), out_path, fps)
    print(f"[video] wrote {path}")
    return len(files)


def array_to_video(frames: np.ndarray, out_path: str, fps: int = 30) -> str:
    """``(T, H, W, 3)`` float [0, 1] frames to a video file; returns the
    path written (``out_path``, or ``out_path + ".npz"``)."""
    frames8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    return _write(frames8, out_path, fps)
