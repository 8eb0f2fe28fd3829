"""Synthetic camera-noise injection for self-calibration experiments.

Port of ``scnerf_tpu/data/noise.py``, a copy of that numpy module: perturb
the *train-split* poses with an intrinsic focal scale, a random axis-angle
rotation and a uniform translation offset; optionally erase the COLMAP
initialization (``run_without_colmap``: identity rotations and/or zero
translations). Val/test poses stay untouched. The same seed gives the same
draws as the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NoiseConfig:
    intrinsic_scale: float = 0.0  # initial_noise_size_intrinsic
    rotation_deg: float = 0.0  # initial_noise_size_rotation (degrees)
    translation: float = 0.0  # initial_noise_size_translation
    run_without_colmap: str = "none"  # none | both | rot | trans


def random_axes(rng: np.random.RandomState, n: int) -> np.ndarray:
    v = rng.rand(n, 3) - 0.5
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def axis_angle_matrices(axes: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Batched numpy Rodrigues (host-side twin of geometry.so3)."""
    angles = angles.reshape(-1)
    ca, sa = np.cos(angles), np.sin(angles)
    C = 1 - ca
    x, y, z = axes[:, 0], axes[:, 1], axes[:, 2]
    R = np.empty((len(angles), 3, 3))
    R[:, 0, 0] = x * x * C + ca
    R[:, 0, 1] = x * y * C - z * sa
    R[:, 0, 2] = z * x * C + y * sa
    R[:, 1, 0] = x * y * C + z * sa
    R[:, 1, 1] = y * y * C + ca
    R[:, 1, 2] = y * z * C - x * sa
    R[:, 2, 0] = z * x * C - y * sa
    R[:, 2, 1] = y * z * C + x * sa
    R[:, 2, 2] = z * z * C + ca
    return R


def inject_pose_noise(
    poses: np.ndarray,
    focal: float,
    i_train: np.ndarray,
    cfg: NoiseConfig,
    rng: np.random.RandomState | None = None,
):
    """Perturb train poses; returns (noisy_poses (N,4,4), noisy_focal).

    Args:
      poses: ``(N, 4, 4)`` or ``(N, 3, 4)`` GT c2w poses.
      focal: GT focal length.
      i_train: indices receiving noise.
    """
    rng = rng or np.random.RandomState(777)
    n = poses.shape[0]
    out = np.eye(4)[None].repeat(n, axis=0)
    out[:, : poses.shape[1], :4] = poses[:, :, :4]
    noisy_focal = focal

    if cfg.intrinsic_scale != 0.0:
        noisy_focal = focal * (1.0 + cfg.intrinsic_scale)

    if cfg.rotation_deg != 0.0:
        ang = (rng.rand(n, 1) - 0.5) * 2 * cfg.rotation_deg * np.pi / 180
        R = axis_angle_matrices(random_axes(rng, n), ang)
        out[i_train, :3, :3] = R[i_train] @ out[i_train, :3, :3]

    if cfg.translation != 0.0:
        t = (rng.rand(n, 3) - 0.5) * 2 * cfg.translation
        out[i_train, :3, 3] += t[i_train]

    if cfg.run_without_colmap in ("both", "rot"):
        out[i_train, :3, :3] = np.eye(3)
    if cfg.run_without_colmap in ("both", "trans"):
        out[i_train, :3, 3] = 0.0
    return out, noisy_focal
