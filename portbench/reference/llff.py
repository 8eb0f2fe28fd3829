"""Frozen copy of the pose pipeline of ``scnerf_tpu_torch/data/llff.py``
(``_unit``, ``camera_frame``, ``average_pose``, ``_to_homogeneous``,
``recenter_poses``, ``render_path_spiral`` and the pose part of
``load_llff``) for the benchmark's plain reference: the c2w poses, focal,
split and spiral render path that the LLFF loader makes of a
``poses_bounds.npy`` array, without reading any image."""
from __future__ import annotations

import numpy as np


def _unit(v, axis=-1):
    v = np.asarray(v, float)
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def camera_frame(forward, up_hint, origin):
    fwd = _unit(np.asarray(forward, float))
    right = _unit(np.cross(up_hint, fwd))
    up = _unit(np.cross(fwd, right))
    origin = np.broadcast_to(np.asarray(origin, float), fwd.shape)
    return np.stack([right, up, fwd, origin], axis=-1)


def average_pose(poses):
    frame = camera_frame(
        poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0), poses[:, :3, 3].mean(0)
    )
    return np.concatenate([frame, poses[0, :3, 4:]], axis=1)


def _to_homogeneous(p34):
    bottom = np.broadcast_to(
        np.array([0.0, 0.0, 0.0, 1.0]), p34.shape[:-2] + (1, 4)
    )
    return np.concatenate([p34, bottom], axis=-2)


def recenter_poses(poses):
    avg = _to_homogeneous(average_pose(poses)[:3, :4])
    out = poses.copy()
    out[:, :3, :4] = (np.linalg.inv(avg) @ _to_homogeneous(poses[:, :3, :4]))[:, :3, :4]
    return out


def render_path_spiral(c2w, up, rads, focal, zrate, rots, N):
    """N c2w poses (3x5) on a spiral around the average pose ``c2w``, each
    looking at the point ``focal`` units in front of it."""
    theta = np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]
    radii = np.append(np.asarray(rads, float), 1.0)
    local = radii * np.stack(
        [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), np.ones_like(theta)], -1
    )
    centers = local @ c2w[:3, :4].T
    lookat = c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0])
    frames = camera_frame(centers - lookat, up, centers)
    hwf = np.broadcast_to(c2w[:3, 4:5], frames[:, :3, :1].shape)
    return np.concatenate([frames, hwf], axis=-1)


def llff_poses(poses_arr: np.ndarray, H: int, W: int, factor: int, llffhold: int,
               bd_factor: float = 0.75) -> dict:
    """What ``load_llff`` makes of ``poses_bounds.npy`` for images of ``H x
    W`` at ``factor``, recentred, not spherified: ``poses`` ``(N, 4, 4)``
    float32 c2w, ``focal``, ``K`` (4x4), ``i_train``, ``i_test``, and the
    spiral render path ``render_poses`` ``(120, 4, 4)`` (two turns), as
    ``render_only`` and the video render it."""
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])
    poses[:2, 4, :] = np.array((H, W)).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)
    sc = 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc
    poses = recenter_poses(poses)
    c2w = average_pose(poses)
    up = _unit(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal_path = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
    path = render_path_spiral(c2w, up, rads, focal_path, zrate=0.5, rots=2, N=120)
    n = len(poses)
    i_test = np.arange(n)[::llffhold]
    i_train = np.array([i for i in range(n) if i not in i_test])
    focal = float(poses[0, -1, -1])
    out = np.eye(4)[None].repeat(n, 0)
    out[:, :3, :4] = poses[:, :3, :4]
    K = np.array([[focal, 0, W // 2, 0], [0, focal, H // 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    render = np.eye(4)[None].repeat(len(path), 0)
    render[:, :3, :4] = path[:, :3, :4]
    return {"poses": out.astype(np.float32), "focal": focal, "K": K,
            "i_train": i_train, "i_test": i_test,
            "render_poses": render.astype(np.float32)}
