"""Seeded scenes for the benchmark's cells, written where the port's loaders
read them.

Frozen copies of ``chip_smoke.py``'s ``smooth_texture``,
``write_fern_scene``, ``projected_matches`` and ``write_truck_scene`` (with
``rodrigues`` and ``nerfpp_poses``), drawing from a seed the cell's run is
given and sized by the configuration's ``scene`` block. The PNGs are written
here by :func:`write_png` (filter 0, zlib), not by the port, and
``matches.npz`` in the format of the port's ``PrecomputedMatches``.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from portbench.reference.llff import llff_poses

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An ``(H, W, 3)`` uint8 image as an 8-bit RGB PNG."""
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def smooth_texture(rng, h: int, w: int) -> np.ndarray:
    """An ``(h, w, 3)`` image in [0.05, 0.95]: four seeded sinusoids a
    channel."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3.0, 2) * 2 * np.pi / np.array([w, h])
            img[..., c] += np.sin(fx * xx + fy * yy + rng.uniform(0, 2 * np.pi))
    return 0.5 + 0.45 * img / 4


def rodrigues(axis: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotation matrices ``(n, 3, 3)`` from unit axes and angles."""
    K = np.zeros((len(axis), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K = K - K.transpose(0, 2, 1)
    a = angle[:, None, None]
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def fern_poses_bounds(rng, scene: dict) -> np.ndarray:
    """``poses_bounds.npy`` rows of a forward-facing capture: cameras within
    ``max_tilt_deg`` of looking down -z, seeded offsets, the configuration's
    hwf column and bounds."""
    n = scene["views"]
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    R = rodrigues(axis, np.deg2rad(rng.uniform(0.0, scene["max_tilt_deg"], n)))
    t = rng.uniform([-0.5, -0.4, -0.1], [0.5, 0.4, 0.1], (n, 3))
    rows = []
    for i in range(n):
        # LLFF stores [down, right, back, t, hwf]; the loader turns it into
        # OpenGL's [right, up, back].
        stored = np.stack([-R[i][:, 1], R[i][:, 0], R[i][:, 2], t[i], scene["hwf"]], axis=1)
        rows.append(np.concatenate([stored.reshape(-1), scene["bounds"]]))
    return np.asarray(rows)


def write_fern_scene(root: str, seed: int, scene: dict, factor: int, llffhold: int) -> dict:
    """A seeded LLFF scene under ``root``: ``poses_bounds.npy`` and
    ``images_{factor}/`` PNGs of smooth textures. Returns the images (uint8,
    ``(N, H, W, 3)``), the raw pose rows and the loader's poses
    (:func:`portbench.reference.llff.llff_poses`)."""
    rng = np.random.RandomState(seed)
    rows = fern_poses_bounds(rng, scene)
    H, W = scene["H"], scene["W"]
    images = np.stack([to8b(smooth_texture(rng, H, W)) for _ in range(scene["views"])])
    os.makedirs(os.path.join(root, f"images_{factor}"), exist_ok=True)
    np.save(os.path.join(root, "poses_bounds.npy"), rows)
    # The loader also lists images/ for the count of views it minified.
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i, img in enumerate(images):
        write_png(os.path.join(root, f"images_{factor}", f"IMG_{i:04d}.png"), img)
        write_png(os.path.join(root, "images", f"IMG_{i:04d}.png"), img[:1, :1])
    return {"images": images, "rows": rows,
            **llff_poses(rows.copy(), H, W, factor, llffhold)}


def projected_matches(poses: np.ndarray, K: np.ndarray, H: int, W: int, n_points: int,
                      seed: int) -> dict:
    """Matches between every pair of ``poses`` (c2w, OpenGL): seeded points
    in front of the cameras projected into both images, those inside both
    kept. ``{(i, j): (kps0, kps1)}`` for ``i < j``."""
    pts = np.random.RandomState(seed).uniform([-1.0, -0.75, -5.0], [1.0, 0.75, -2.0],
                                              (n_points, 3))
    kps, inside = [], []
    for c2w in poses:
        cam = (pts - c2w[:3, 3]) @ c2w[:3, :3]
        k = np.stack([K[0, 2] + K[0, 0] * cam[:, 0] / -cam[:, 2],
                      K[1, 2] - K[1, 1] * cam[:, 1] / -cam[:, 2]], -1).astype(np.float32)
        kps.append(k)
        inside.append((k[:, 0] >= 0) & (k[:, 0] < W) & (k[:, 1] >= 0) & (k[:, 1] < H))
    out = {}
    for i in range(len(poses)):
        for j in range(i + 1, len(poses)):
            keep = inside[i] & inside[j]
            out[(i, j)] = (kps[i][keep], kps[j][keep])
    return out


def save_matches(path: str, matches: dict) -> None:
    """``matches`` as the port's ``PrecomputedMatches`` file:
    ``kps0_{i}_{j}`` and ``kps1_{i}_{j}`` arrays."""
    arrays = {}
    for (i, j), (k0, k1) in matches.items():
        arrays[f"kps0_{i}_{j}"] = k0
        arrays[f"kps1_{i}_{j}"] = k1
    np.savez_compressed(path, **arrays)


def nerfpp_poses(rng, n: int, scene: dict):
    """The configuration's pinhole K and ``n`` seeded OpenCV c2w poses near
    the origin (inside the unit sphere), each within ``max_tilt_rad`` of
    looking down +z."""
    H, W, f = scene["H"], scene["W"], scene["focal"]
    K = np.array([[f, 0, W / 2, 0], [0, f, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    E = np.tile(np.eye(4), (n, 1, 1))
    E[:, :3, :3] = rodrigues(axis, rng.rand(n) * scene["max_tilt_rad"])
    E[:, :3, 3] = rng.randn(n, 3) * scene["centre_std"]
    return K, E


def write_truck_scene(root: str, seed: int, scene: dict) -> dict:
    """A seeded NeRF++ scene at ``root``: a ``train/`` split of
    ``train_views`` views with smooth textures in ``rgb/`` and
    ``intrinsics/`` and ``pose/`` text files. Returns the images (uint8),
    K and the poses."""
    rng = np.random.RandomState(seed)
    K, poses = nerfpp_poses(rng, scene["train_views"], scene)
    for sub in ("rgb", "intrinsics", "pose"):
        os.makedirs(os.path.join(root, "train", sub), exist_ok=True)
    images = []
    for i, c2w in enumerate(poses):
        img = to8b(smooth_texture(rng, scene["H"], scene["W"]))
        images.append(img)
        write_png(os.path.join(root, "train", "rgb", f"{i:05d}.png"), img)
        for sub, m in (("intrinsics", K), ("pose", c2w)):
            with open(os.path.join(root, "train", sub, f"{i:05d}.txt"), "w") as f:
                f.write(" ".join(repr(float(v)) for v in m.reshape(-1)))
    return {"images": np.stack(images), "K": K, "poses": poses}
