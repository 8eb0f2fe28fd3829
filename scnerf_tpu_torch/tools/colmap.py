"""COLMAP sparse-model tooling.

Port of ``scnerf_tpu/tools/colmap.py`` (numpy and the standard library, as
there), the rebuild of the reference's pose-generation pipeline
readers/writers (``colmap_utils/read_sparse_model.py`` (binary readers),
``colmap_utils/post_colmap.py`` (c2w conversion + ``poses_bounds.npy``),
``nerfplusplus/colmap_runner/normalize_cam_dict.py`` (unit-sphere
normalization)). Implemented from the public COLMAP binary format spec.
Running COLMAP itself stays external (the reference shells out to the
``colmap`` binary, ``colmap_utils/colmap.sh:5``); these functions consume its
output.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w x y z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (M, 2)
    point3D_ids: np.ndarray  # (M,)


_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cam_id] = ColmapCamera(cam_id, name, w, h, params)
    return out


def read_images_bin(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (img_id,) = _read(f, "<i")
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (cam_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64).reshape(n_pts, 3)
            xys = data[:, :2].copy()
            ids = np.frombuffer(
                np.ascontiguousarray(data[:, 2]).tobytes(), dtype=np.int64
            )
            out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode(), xys, ids)
    return out


def read_points3d_bin(path: str) -> dict[int, np.ndarray]:
    """point3D_id -> xyz (errors/tracks skipped)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (pid,) = _read(f, "<Q")
            xyz = np.array(_read(f, "<3d"))
            f.read(3)  # rgb
            f.read(8)  # error
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
            out[pid] = xyz
    return out


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def colmap_to_c2w(img: ColmapImage) -> np.ndarray:
    """World-to-camera (R, t) -> 4x4 camera-to-world."""
    R = qvec2rotmat(img.qvec)
    t = img.tvec
    c2w = np.eye(4)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = -R.T @ t
    return c2w


def sparse_to_poses_bounds(sparse_dir: str) -> np.ndarray:
    """Build the LLFF ``poses_bounds.npy`` array (N, 17) from a COLMAP sparse
    model directory (the reference's ``post_colmap.py`` role): per image a
    3x5 [R | t | hwf] block in the LLFF [down, right, back] convention plus
    (near, far) depth bounds from the visible 3D points."""
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    pts = read_points3d_bin(os.path.join(sparse_dir, "points3D.bin"))

    rows = []
    for img_id in sorted(images.keys(), key=lambda i: images[i].name):
        img = images[img_id]
        cam = cams[img.camera_id]
        f = cam.params[0]
        c2w = colmap_to_c2w(img)
        # LLFF convention: columns [-y, x, z] of the c2w rotation ("down,
        # right, back"), matching what load_llff un-permutes.
        R = c2w[:3, :3]
        m = np.stack([-R[:, 1], R[:, 0], R[:, 2], c2w[:3, 3]], axis=1)  # (3, 4)
        hwf = np.array([cam.height, cam.width, f]).reshape(3, 1)
        block = np.concatenate([m, hwf], axis=1)  # (3, 5)

        # depth bounds from points observed by this image
        w2c_R = c2w[:3, :3].T
        w2c_t = -w2c_R @ c2w[:3, 3]
        zs = []
        for pid in img.point3D_ids:
            if pid != -1 and pid in pts:
                zs.append((w2c_R @ pts[pid] + w2c_t)[2])
        if zs:
            near, far = np.percentile(zs, 0.5), np.percentile(zs, 99.5)
        else:
            near, far = 0.1, 100.0
        rows.append(np.concatenate([block.reshape(-1), [near, far]]))
    return np.stack(rows, 0)


def write_poses_bounds(sparse_dir: str, out_path: str) -> np.ndarray:
    arr = sparse_to_poses_bounds(sparse_dir)
    np.save(out_path, arr)
    return arr


def normalize_cameras_to_unit_sphere(
    poses: np.ndarray, target_radius: float = 1.0
) -> tuple[np.ndarray, float, np.ndarray]:
    """Translate + scale all c2w poses so camera centers fit in the unit
    sphere (``normalize_cam_dict.py:7-29``). Returns (new_poses, scale,
    translation)."""
    centers = poses[:, :3, 3]
    translate = -centers.mean(axis=0)
    scale = target_radius / (np.linalg.norm(centers + translate, axis=1).max() + 1e-10)
    out = poses.copy()
    out[:, :3, 3] = (centers + translate) * scale
    return out, scale, translate


def _camera_K(cam: ColmapCamera) -> np.ndarray:
    """4x4 K from a COLMAP camera of any pinhole-family model."""
    p = np.asarray(cam.params, float)
    if cam.model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE"):
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    elif cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                       "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model}")
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def extract_cam_dict(sparse_dir: str) -> dict:
    """COLMAP sparse model -> NeRF++ cam_dict (the ``kai_cameras.json``
    schema of ``colmap_runner/extract_sfm.py:48-84``): per image name,
    ``{"K": 16 floats, "W2C": 16 floats, "img_size": [w, h]}``."""
    cams, imgs = read_sparse_model(sparse_dir)
    out = {}
    for img in imgs.values():
        K = _camera_K(cams[img.camera_id])
        W2C = np.eye(4)
        W2C[:3, :3] = qvec2rotmat(img.qvec)
        W2C[:3, 3] = img.tvec
        out[img.name] = {
            "K": K.reshape(-1).tolist(),
            "W2C": W2C.reshape(-1).tolist(),
            "img_size": [cams[img.camera_id].width, cams[img.camera_id].height],
        }
    return out


def normalize_cam_dict(cam_dict: dict, target_radius: float = 1.0) -> dict:
    """Translate+scale all cameras into the target sphere — the NeRF++
    dataset-prep normalisation (``normalize_cam_dict.py:7-53``, including
    its 1.1 diagonal margin). Operates on the cam_dict W2C entries."""
    centers = []
    for v in cam_dict.values():
        W2C = np.asarray(v["W2C"], float).reshape(4, 4)
        centers.append(np.linalg.inv(W2C)[:3, 3])
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    radius = np.linalg.norm(centers - center, axis=1).max() * 1.1
    translate = -center
    scale = target_radius / radius

    out = {}
    for name, v in cam_dict.items():
        W2C = np.asarray(v["W2C"], float).reshape(4, 4)
        C2W = np.linalg.inv(W2C)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        out[name] = dict(v, W2C=np.linalg.inv(C2W).reshape(-1).tolist())
    return out


def write_nerfpp_split(cam_dict: dict, out_dir: str, split: str = "train",
                       image_src_dir: str | None = None) -> str:
    """cam_dict -> the NeRF++ on-disk split layout our loader (and the
    reference's ``data_loader_split.py``) reads: per image
    ``{split}/intrinsics/<name>.txt`` (16 K floats, or 18 with trailing
    radial ``k1 k2`` when the entry carries ``"k"`` — fisheye datasets,
    ``data_loader_split.py:34``) and ``{split}/pose/<name>.txt`` (16 c2w
    floats), plus ``rgb/`` copies when ``image_src_dir`` is given. Completes
    the images -> COLMAP -> extract -> normalize -> dataset pipeline."""
    import shutil

    base = os.path.join(out_dir, split)
    for sub in ("intrinsics", "pose") + (("rgb",) if image_src_dir else ()):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for name in sorted(cam_dict):
        v = cam_dict[name]
        stem = os.path.splitext(name)[0]
        K = np.asarray(v["K"], float)
        vals = list(K.reshape(-1))
        if v.get("k") is not None:
            vals += [float(x) for x in np.asarray(v["k"]).reshape(-1)[:2]]
        c2w = np.linalg.inv(np.asarray(v["W2C"], float).reshape(4, 4))
        with open(os.path.join(base, "intrinsics", stem + ".txt"), "w") as f:
            f.write(" ".join(repr(float(x)) for x in vals))
        with open(os.path.join(base, "pose", stem + ".txt"), "w") as f:
            f.write(" ".join(repr(float(x)) for x in c2w.reshape(-1)))
        if image_src_dir:
            shutil.copyfile(os.path.join(image_src_dir, name),
                            os.path.join(base, "rgb", name))
    return base


def read_cameras_txt(path: str) -> dict[int, ColmapCamera]:
    """COLMAP text-model cameras.txt (``read_write_model.py`` role; some
    distributed datasets ship text models only)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(x) for x in parts[4:]])
            out[cam_id] = ColmapCamera(cam_id, model, w, h, params)
    return out


def read_images_txt(path: str) -> dict[int, ColmapImage]:
    """COLMAP text-model images.txt: two lines per image (header + 2D
    points; points may be empty)."""
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        xys = np.zeros((0, 2))
        ids = np.zeros((0,), np.int64)
        if i + 1 < len(lines):
            pts = lines[i + 1].split()
            if len(pts) >= 3:
                arr = np.array([float(x) for x in pts]).reshape(-1, 3)
                xys = arr[:, :2]
                ids = arr[:, 2].astype(np.int64)
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys, ids)
    return out


def read_sparse_model(sparse_dir: str):
    """(cameras, images) from a sparse model dir, binary or text."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        return (read_cameras_bin(os.path.join(sparse_dir, "cameras.bin")),
                read_images_bin(os.path.join(sparse_dir, "images.bin")))
    return (read_cameras_txt(os.path.join(sparse_dir, "cameras.txt")),
            read_images_txt(os.path.join(sparse_dir, "images.txt")))
