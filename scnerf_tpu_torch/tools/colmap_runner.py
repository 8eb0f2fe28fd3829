"""COLMAP pipeline wrapper (pose generation for raw image sets).

Port of ``scnerf_tpu/tools/colmap_runner.py``, the rebuild of the
reference's ``colmap_utils/colmap.sh`` and
``nerfplusplus/colmap_runner/run_colmap.py``: shells out to
an installed ``colmap`` binary (feature extraction -> exhaustive matching ->
mapper), then converts the sparse model with ``tools/colmap.py``. Gated on
binary availability — importable and testable without COLMAP installed.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess

import numpy as np

from scnerf_tpu_torch.core.imaging import imread
from scnerf_tpu_torch.tools.colmap import write_poses_bounds


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def run_colmap(
    image_dir: str,
    workspace: str,
    camera_model: str = "SIMPLE_RADIAL",
    single_camera: bool = True,
    quiet: bool = True,
) -> str:
    """Run the standard COLMAP SfM pipeline; returns the sparse model dir.

    ``camera_model``: COLMAP model name — the NeRF++ fisheye pipeline uses
    ``RADIAL_FISHEYE`` (``run_colmap.py:11``), the NeRF one pinhole/radial.
    """
    if not colmap_available():
        raise RuntimeError("colmap binary not found on PATH")
    os.makedirs(workspace, exist_ok=True)
    db = os.path.join(workspace, "database.db")
    sparse = os.path.join(workspace, "sparse")
    os.makedirs(sparse, exist_ok=True)
    out = subprocess.DEVNULL if quiet else None

    subprocess.check_call(
        [
            "colmap", "feature_extractor",
            "--database_path", db,
            "--image_path", image_dir,
            "--ImageReader.camera_model", camera_model,
            "--ImageReader.single_camera", "1" if single_camera else "0",
        ],
        stdout=out, stderr=out,
    )
    subprocess.check_call(
        ["colmap", "exhaustive_matcher", "--database_path", db],
        stdout=out, stderr=out,
    )
    subprocess.check_call(
        [
            "colmap", "mapper",
            "--database_path", db,
            "--image_path", image_dir,
            "--output_path", sparse,
        ],
        stdout=out, stderr=out,
    )
    model0 = os.path.join(sparse, "0")
    return model0 if os.path.isdir(model0) else sparse


def images_to_poses_bounds(image_dir: str, workspace: str, out_path: str | None = None):
    """images -> COLMAP -> LLFF poses_bounds.npy (the colmap_utils pipeline)."""
    sparse = run_colmap(image_dir, workspace)
    out_path = out_path or os.path.join(os.path.dirname(image_dir), "poses_bounds.npy")
    return write_poses_bounds(sparse, out_path)


# ---------------------------------------------------------------------------
# Posed pipeline: known cameras -> SIFT -> triangulation [-> BA -> MVS].
# Covers the reference's nerfplusplus/colmap_runner/run_colmap_posed.py:1-295
# (the NeRF++ dataset-prep path where poses come from an external source and
# COLMAP only triangulates/adjusts), re-expressed over our colmap_db module
# and without the pyquaternion dependency.
# ---------------------------------------------------------------------------


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) unit quaternion for a 3x3 rotation (Shepperd's method:
    branch on the largest diagonal combination for numerical robustness)."""
    R = np.asarray(R, float)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def cam_dict_to_pinhole(cam_dict: dict, img_dir: str | None = None) -> dict:
    """NeRF++ cam_dict (per-image K 4x4 + W2C 4x4 [+ img_size]) -> the
    pinhole-dict layout ``[w, h, fx, fy, cx, cy, qw, qx, qy, qz, tx, ty, tz]``
    (file-compatible with the reference's pinhole_dict.json). Rotations are
    re-orthonormalised through SVD before quaternion extraction, as the
    reference does."""
    out = {}
    for name, item in cam_dict.items():
        if "img_size" in item:
            w, h = item["img_size"]
        else:  # the PNG reader of core/imaging.py, imageio for other files
            hh, ww = imread(os.path.join(img_dir, name)).shape[:2]
            w, h = ww, hh
        K = np.asarray(item["K"], float).reshape(4, 4)
        W2C = np.asarray(item["W2C"], float).reshape(4, 4)
        u, s, vh = np.linalg.svd(W2C[:3, :3], full_matrices=False)
        Rm = (u * np.round(s)) @ vh
        q = rotation_to_quaternion(Rm)
        t = W2C[:3, 3]
        out[name] = [int(w), int(h), float(K[0, 0]), float(K[1, 1]),
                     float(K[0, 2]), float(K[1, 2]), *map(float, q), *map(float, t)]
    return out


def write_posed_init_model(pinhole_dict: dict, name_to_id: dict, out_dir: str) -> None:
    """COLMAP text model (cameras/images/points3D.txt) seeding triangulation
    with the known poses. One PINHOLE camera per image, camera_id = image_id
    (the reference's layout); empty points3D for the triangulator to fill."""
    os.makedirs(out_dir, exist_ok=True)
    cam_lines, img_lines = [], []
    for name, img_id in name_to_id.items():
        w, h, fx, fy, cx, cy, qw, qx, qy, qz, tx, ty, tz = pinhole_dict[name]
        cam_lines.append(f"{img_id} PINHOLE {w} {h} {fx} {fy} {cx} {cy}\n")
        img_lines.append(
            f"{img_id} {qw} {qx} {qy} {qz} {tx} {ty} {tz} {img_id} {name}\n\n"
        )
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.writelines(cam_lines)
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.writelines(img_lines)
        f.write("\n")
    open(os.path.join(out_dir, "points3D.txt"), "w").close()


def run_colmap_posed(
    image_dir: str,
    cam_dict: dict | str,
    out_dir: str,
    global_ba: bool = True,
    mvs: bool = False,
    quiet: bool = True,
) -> str:
    """Posed-COLMAP pipeline: SIFT+matching, triangulation against the given
    poses, optional global BA and MVS/fusion. Returns the sparse model dir.
    Requires the ``colmap`` binary (see :func:`colmap_available`)."""
    if not colmap_available():
        raise RuntimeError("colmap binary not found on PATH")
    if isinstance(cam_dict, str):
        cam_dict = json.load(open(cam_dict))
    os.makedirs(out_dir, exist_ok=True)
    pinhole = cam_dict_to_pinhole(cam_dict, image_dir)
    json.dump(pinhole, open(os.path.join(out_dir, "pinhole_dict.json"), "w"),
              indent=2, sort_keys=True)
    db = os.path.join(out_dir, "database.db")
    outp = subprocess.DEVNULL if quiet else None

    subprocess.check_call(
        ["colmap", "feature_extractor", "--database_path", db,
         "--image_path", image_dir,
         "--ImageReader.camera_model", "PINHOLE",
         "--SiftExtraction.use_gpu", "0"],
        stdout=outp, stderr=outp)
    subprocess.check_call(
        ["colmap", "exhaustive_matcher", "--database_path", db,
         "--SiftMatching.guided_matching", "1",
         "--SiftMatching.use_gpu", "0"],
        stdout=outp, stderr=outp)

    from scnerf_tpu_torch.tools.colmap_db import open_database, read_images

    with open_database(db) as conn:
        name_to_id = read_images(conn)
    init_dir = os.path.join(out_dir, "init")
    write_posed_init_model(pinhole, name_to_id, init_dir)

    sparse = os.path.join(out_dir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    subprocess.check_call(
        ["colmap", "point_triangulator", "--database_path", db,
         "--image_path", image_dir, "--input_path", init_dir,
         "--output_path", sparse,
         "--Mapper.tri_ignore_two_view_tracks", "1"],
        stdout=outp, stderr=outp)
    if global_ba:
        ba_dir = os.path.join(out_dir, "sparse_ba")
        os.makedirs(ba_dir, exist_ok=True)
        subprocess.check_call(
            ["colmap", "bundle_adjuster", "--input_path", sparse,
             "--output_path", ba_dir],
            stdout=outp, stderr=outp)
        sparse = ba_dir
    if mvs:
        mvs_dir = os.path.join(out_dir, "mvs")
        subprocess.check_call(
            ["colmap", "image_undistorter", "--image_path", image_dir,
             "--input_path", sparse, "--output_path", mvs_dir],
            stdout=outp, stderr=outp)
        subprocess.check_call(
            ["colmap", "patch_match_stereo", "--workspace_path", mvs_dir],
            stdout=outp, stderr=outp)
        subprocess.check_call(
            ["colmap", "stereo_fusion", "--workspace_path", mvs_dir,
             "--output_path", os.path.join(mvs_dir, "fused.ply")],
            stdout=outp, stderr=outp)
    return sparse
