"""COLMAP sqlite database reader/writer.

Port of ``scnerf_tpu/tools/colmap_db.py``. Covers the role of the
reference's vendored ``colmap_runner/database.py``
(``nerfplusplus/colmap_runner/database.py:1-352``) with a
functional module written against COLMAP's PUBLIC database format
(https://colmap.github.io/database.html) rather than a transcription:

- Writes the REAL COLMAP schema (``data`` blob columns), so produced
  databases feed an actual ``colmap`` binary. The reference's vendored copy
  renamed the blob columns to ``data_500``; :func:`read_keypoints` /
  :func:`read_matches` accept either name so databases produced by the
  reference tooling remain readable.
- Keypoints are float32 (N, 2|4|6), descriptors uint8, matches uint32
  (M, 2) keyed by ``pair_id = id1 * 2147483647 + id2`` with id1 < id2 and
  column swap on inverted pairs — COLMAP's documented conventions.

Camera model ids (COLMAP ``src/base/camera_models.h``): SIMPLE_PINHOLE=0,
PINHOLE=1, SIMPLE_RADIAL=2, RADIAL=3, OPENCV=4, RADIAL_FISHEYE=9.
"""
from __future__ import annotations

import sqlite3
from contextlib import contextmanager

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

CAMERA_MODEL_IDS = {
    "SIMPLE_PINHOLE": 0,
    "PINHOLE": 1,
    "SIMPLE_RADIAL": 2,
    "RADIAL": 3,
    "OPENCV": 4,
    "OPENCV_FISHEYE": 5,
    "FULL_OPENCV": 6,
    "FOV": 7,
    "SIMPLE_RADIAL_FISHEYE": 8,
    "RADIAL_FISHEYE": 9,
    "THIN_PRISM_FISHEYE": 10,
}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB);
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
"""


def pair_id_from_images(image_id1: int, image_id2: int) -> int:
    lo, hi = sorted((int(image_id1), int(image_id2)))
    return lo * MAX_IMAGE_ID + hi


def images_from_pair_id(pair_id: int) -> tuple[int, int]:
    return int(pair_id) // MAX_IMAGE_ID, int(pair_id) % MAX_IMAGE_ID


def _ordered(image_id1: int, image_id2: int, matches: np.ndarray) -> np.ndarray:
    """Column order follows ascending image-id order (COLMAP convention)."""
    return matches[:, ::-1] if image_id1 > image_id2 else matches


@contextmanager
def open_database(path: str):
    """Open (creating schema if new) a COLMAP database; commits on exit."""
    conn = sqlite3.connect(path)
    try:
        conn.executescript(_SCHEMA)
        yield conn
        conn.commit()
    finally:
        conn.close()


def add_camera(conn, model: str | int, width: int, height: int, params,
               prior_focal_length: bool = False, camera_id: int | None = None) -> int:
    model_id = CAMERA_MODEL_IDS[model] if isinstance(model, str) else int(model)
    blob = np.asarray(params, np.float64).tobytes()
    cur = conn.execute(
        "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
        (camera_id, model_id, int(width), int(height), blob, int(prior_focal_length)),
    )
    return cur.lastrowid


def add_image(conn, name: str, camera_id: int, prior_q=None, prior_t=None,
              image_id: int | None = None) -> int:
    q = np.full(4, np.nan) if prior_q is None else np.asarray(prior_q, float)
    t = np.full(3, np.nan) if prior_t is None else np.asarray(prior_t, float)
    cur = conn.execute(
        "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
        (image_id, name, int(camera_id), *[float(x) for x in q], *[float(x) for x in t]),
    )
    return cur.lastrowid


def set_keypoints(conn, image_id: int, keypoints: np.ndarray) -> None:
    kps = np.ascontiguousarray(keypoints, np.float32)
    assert kps.ndim == 2 and kps.shape[1] in (2, 4, 6), kps.shape
    conn.execute("INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
                 (int(image_id), *kps.shape, kps.tobytes()))


def set_descriptors(conn, image_id: int, descriptors: np.ndarray) -> None:
    d = np.ascontiguousarray(descriptors, np.uint8)
    conn.execute("INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
                 (int(image_id), *d.shape, d.tobytes()))


def set_matches(conn, image_id1: int, image_id2: int, matches: np.ndarray) -> None:
    m = np.ascontiguousarray(_ordered(image_id1, image_id2,
                                      np.asarray(matches)), np.uint32)
    assert m.ndim == 2 and m.shape[1] == 2, m.shape
    conn.execute("INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
                 (pair_id_from_images(image_id1, image_id2), *m.shape, m.tobytes()))


def set_two_view_geometry(conn, image_id1: int, image_id2: int,
                          matches: np.ndarray, F=None, E=None, H=None,
                          config: int = 2) -> None:
    m = np.ascontiguousarray(_ordered(image_id1, image_id2,
                                      np.asarray(matches)), np.uint32)
    eye = np.eye(3, dtype=np.float64)
    blobs = [np.asarray(x if x is not None else eye, np.float64).tobytes()
             for x in (F, E, H)]
    conn.execute(
        "INSERT OR REPLACE INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
        (pair_id_from_images(image_id1, image_id2), *m.shape, m.tobytes(),
         int(config), *blobs),
    )


def _blob_column(conn, table: str) -> str:
    """'data', or the reference fork's 'data_500' for read compatibility."""
    cols = [r[1] for r in conn.execute(f"PRAGMA table_info({table})")]
    return "data" if "data" in cols else "data_500"


def read_images(conn) -> dict[str, int]:
    """{image_name: image_id}."""
    return {name: iid for iid, name in
            conn.execute("SELECT image_id, name FROM images")}


def read_cameras(conn) -> dict[int, dict]:
    out = {}
    for cid, model, w, h, params, prior in conn.execute("SELECT * FROM cameras"):
        out[cid] = {"model": model, "width": w, "height": h,
                    "params": np.frombuffer(params, np.float64),
                    "prior_focal_length": bool(prior)}
    return out


def read_keypoints(conn, image_id: int) -> np.ndarray | None:
    col = _blob_column(conn, "keypoints")
    row = conn.execute(
        f"SELECT rows, cols, {col} FROM keypoints WHERE image_id=?",
        (int(image_id),)).fetchone()
    if row is None:
        return None
    r, c, blob = row
    return np.frombuffer(blob, np.float32).reshape(r, c)


def read_matches(conn, image_id1: int, image_id2: int) -> np.ndarray | None:
    col = _blob_column(conn, "matches")
    row = conn.execute(
        f"SELECT rows, cols, {col} FROM matches WHERE pair_id=?",
        (pair_id_from_images(image_id1, image_id2),)).fetchone()
    if row is None:
        return None
    r, c, blob = row
    m = np.frombuffer(blob, np.uint32).reshape(r, c)
    return _ordered(image_id1, image_id2, m)


def write_database_from_matches(path: str, images: dict[str, dict],
                                keypoints: dict[str, np.ndarray],
                                matches: dict[tuple[str, str], np.ndarray]) -> dict[str, int]:
    """One-call export: a match-cache worth of data -> a COLMAP database.

    Args:
      images: {name: {"model", "width", "height", "params"}} per image.
      keypoints: {name: (N, 2) float32 pixel coords}.
      matches: {(name0, name1): (M, 2) uint32 keypoint-index pairs}.
    Returns {name: image_id}.
    """
    ids = {}
    with open_database(path) as conn:
        for name, cam in images.items():
            cid = add_camera(conn, cam.get("model", "PINHOLE"), cam["width"],
                             cam["height"], cam["params"],
                             cam.get("prior_focal_length", True))
            ids[name] = add_image(conn, name, cid)
        for name, kps in keypoints.items():
            set_keypoints(conn, ids[name], kps)
        for (n0, n1), m in matches.items():
            set_matches(conn, ids[n0], ids[n1], m)
            set_two_view_geometry(conn, ids[n0], ids[n1], m)
    return ids
