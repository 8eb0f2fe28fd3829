"""NeRF++ split-directory dataset loader.

Port of ``scnerf_tpu/data/nerfpp_split.py``, a copy of that numpy module:
per-split directories ``rgb/ intrinsics/ pose/ [mask/ min_depth/]`` with one
text file per image holding 16 floats (4x4, row-major), or 18 when trailing
radial ``k1 k2`` are present. Pose translations are divided by
``normalize_factor`` so that the cameras land inside the unit sphere.

Images go through ``core/imaging.imread``: PNGs need nothing beyond the
standard library, any other format needs ``imageio``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from scnerf_tpu_torch.core.imaging import imread


def _parse_txt(path: str) -> np.ndarray:
    with open(path) as f:
        nums = [float(x) for x in f.read().split()]
    return np.asarray(nums, dtype=np.float64)


def _find(dirpath: str, exts=(".txt",)):
    if not os.path.isdir(dirpath):
        return []
    return [os.path.join(dirpath, f) for f in sorted(os.listdir(dirpath)) if f.endswith(exts)]


@dataclass
class NerfPPSplit:
    images: np.ndarray | None  # (N, H, W, 3) or None (test splits may lack rgb)
    intrinsics: np.ndarray  # (N, 4, 4)
    poses: np.ndarray  # (N, 4, 4) c2w
    k: np.ndarray | None  # (N, 2) radial coeffs or None
    masks: np.ndarray | None  # (N, H, W) or None
    min_depths: np.ndarray | None
    img_names: list = field(default_factory=list)
    H: int = 0
    W: int = 0


def _gray_stack(files: list) -> np.ndarray:
    """Single-channel float32 maps in [0, 1] (the first channel of a colour
    file)."""
    maps = np.stack([imread(f).astype(np.float32) / 255.0 for f in files], 0)
    return maps[..., 0] if maps.ndim == 4 else maps


def load_nerfpp_split(
    basedir: str,
    split: str,
    normalize_factor: float = 1.0,
    testskip: int = 1,
) -> NerfPPSplit:
    d = os.path.join(basedir, split)
    intr_files = _find(os.path.join(d, "intrinsics"))
    pose_files = _find(os.path.join(d, "pose"))
    img_files = _find(
        os.path.join(d, "rgb"), exts=(".png", ".jpg", ".jpeg", ".JPG", ".PNG")
    )
    if len(intr_files) != len(pose_files):
        raise ValueError(f"{d}: {len(intr_files)} intrinsics files but {len(pose_files)} poses")
    skip = 1 if split == "train" or testskip == 0 else testskip
    intr_files = intr_files[::skip]
    pose_files = pose_files[::skip]
    img_files = img_files[::skip] if img_files else []

    intrinsics, ks = [], []
    for f in intr_files:
        vals = _parse_txt(f)
        intrinsics.append(vals[:16].reshape(4, 4))
        if len(vals) >= 18:
            ks.append(vals[16:18])
    poses = np.stack([_parse_txt(f)[:16].reshape(4, 4) for f in pose_files], 0)
    poses[:, :3, 3] /= normalize_factor
    intrinsics = np.stack(intrinsics, 0)
    k = np.stack(ks, 0) if ks else None

    images = None
    H = W = 0
    if img_files:
        images = np.stack([imread(f)[..., :3] / 255.0 for f in img_files], 0).astype(np.float32)
        H, W = images.shape[1:3]

    mask_files = _find(os.path.join(d, "mask"), exts=(".png", ".jpg"))
    masks = _gray_stack(mask_files[::skip]) if mask_files else None

    # Per-pixel minimum sample depths: ``min_depth/*.png`` scaled by the
    # split's ``max_depth.txt`` (img/255 * max_depth + 1e-4), the fg near
    # bound of each ray.
    min_depths = None
    md_files = _find(os.path.join(d, "min_depth"), exts=(".png", ".jpg"))
    max_depth_path = os.path.join(d, "max_depth.txt")
    if md_files and os.path.exists(max_depth_path):
        with open(max_depth_path) as f:
            max_depth = float(f.readline().strip())
        min_depths = _gray_stack(md_files[::skip]) * max_depth + 1e-4

    return NerfPPSplit(
        images=images,
        intrinsics=intrinsics.astype(np.float32),
        poses=poses.astype(np.float32),
        k=None if k is None else k.astype(np.float32),
        masks=masks,
        min_depths=None if min_depths is None else min_depths.astype(np.float32),
        img_names=[os.path.basename(f) for f in (img_files or pose_files)],
        H=H,
        W=W,
    )


def check_cameras_in_unit_sphere(poses: np.ndarray) -> None:
    """The NeRF++ normalization contract: every camera centre must lie
    inside the unit sphere. Raises otherwise, at load time."""
    norms = np.linalg.norm(poses[:, :3, 3], axis=-1)
    if (norms >= 1.0).any():
        raise ValueError(
            f"cameras outside unit sphere (max |t| = {norms.max():.3f}); "
            "normalize the dataset (normalize_factor) first"
        )
