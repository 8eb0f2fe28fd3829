"""Blender synthetic dataset loader (NeRF's lego, chair, ... scenes).

Port of ``scnerf_tpu/data/blender.py``, a copy of that numpy module:
``transforms_*.json`` parsing, the focal from ``camera_angle_x``, the
spherical render path, the ``half_res`` option and the train-split noise
injection (``data/noise.py``). RGBA is kept; the NeRF driver composites onto
white under ``white_bkgd``.

Frames go through ``core/imaging.imread`` (PNG on the standard library).
``half_res`` is the mean of each 2x2 block, which is what cv2's
``INTER_AREA`` resize (the JAX package's) computes at an exact factor of 2;
a ``half_res`` load of an odd height or width raises.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from scnerf_tpu_torch.core.imaging import imread
from scnerf_tpu_torch.data.noise import NoiseConfig, inject_pose_noise


def _rot_phi(phi):
    return np.array(
        [[1, 0, 0, 0], [0, np.cos(phi), -np.sin(phi), 0],
         [0, np.sin(phi), np.cos(phi), 0], [0, 0, 0, 1]], dtype=np.float64)


def _rot_theta(th):
    return np.array(
        [[np.cos(th), 0, -np.sin(th), 0], [0, 1, 0, 0],
         [np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]], dtype=np.float64)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    c2w = np.eye(4)
    c2w[2, 3] = radius
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)
    return flip @ c2w


def spherical_render_poses() -> np.ndarray:
    """The 40-frame spherical render path, ``(40, 4, 4)`` float32."""
    return np.stack([pose_spherical(a, -30.0, 4.0)
                     for a in np.linspace(-180, 180, 41)[:-1]], 0).astype(np.float32)


def half_resolution(imgs: np.ndarray) -> np.ndarray:
    """``(N, H, W, C)`` images at half size: the mean of each 2x2 block."""
    n, h, w, c = imgs.shape
    if h % 2 or w % 2:
        raise ValueError(f"half_res needs an even height and width, got {h}x{w}")
    blocks = imgs.reshape(n, h // 2, 2, w // 2, 2, c)
    return ((blocks[:, :, 0, :, 0] + blocks[:, :, 0, :, 1])
            + (blocks[:, :, 1, :, 0] + blocks[:, :, 1, :, 1])) * imgs.dtype.type(0.25)


@dataclass
class BlenderData:
    images: np.ndarray  # (N, H, W, 4) RGBA float
    noisy_poses: np.ndarray  # (N, 4, 4)
    gt_poses: np.ndarray  # (N, 4, 4)
    render_poses: np.ndarray  # (40, 4, 4)
    i_split: tuple  # (i_train, i_val, i_test)
    gt_intrinsic: np.ndarray  # (4, 4)
    noisy_focal: float
    H: int = 0
    W: int = 0


def load_blender(
    basedir: str,
    half_res: bool = False,
    testskip: int = 1,
    noise: NoiseConfig | None = None,
    rng: np.random.RandomState | None = None,
) -> BlenderData:
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as f:
            metas[s] = json.load(f)
    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            imgs.append(imread(os.path.join(basedir, frame["file_path"] + ".png")))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)  # keep RGBA
        all_imgs.append(imgs)
        all_poses.append(np.array(poses).astype(np.float32))
        counts.append(counts[-1] + imgs.shape[0])
    i_split = tuple(np.arange(counts[i], counts[i + 1]) for i in range(3))
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    if half_res:
        imgs = half_resolution(imgs)
        H, W = H // 2, W // 2
        focal = focal / 2.0

    noise = noise or NoiseConfig()
    noisy_poses, noisy_focal = inject_pose_noise(poses[:, :3, :4], focal, i_split[0], noise, rng)

    gt_K = np.array(
        [[focal, 0, W / 2, 0], [0, focal, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32,
    )
    gt_poses = np.eye(4)[None].repeat(len(poses), 0).astype(np.float32)
    gt_poses[:, :3, :4] = poses[:, :3, :4]
    return BlenderData(
        images=imgs,
        noisy_poses=noisy_poses.astype(np.float32),
        gt_poses=gt_poses,
        render_poses=spherical_render_poses(),
        i_split=i_split,
        gt_intrinsic=gt_K,
        noisy_focal=float(noisy_focal),
        H=H,
        W=W,
    )
