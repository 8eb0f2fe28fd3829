"""Image-pair candidate selection by relative rotation angle.

Port of ``scnerf_tpu/matching/pairs.py``, a copy of that numpy module: all
(i, j) pairs whose relative rotation is under ``angle_threshold`` degrees,
as a symmetric dict plus an optional ``i_map`` remapping into camera-table
indices. Runs once at start-up on the host.
"""
from __future__ import annotations

import numpy as np


def image_pair_candidates(
    extrinsics: np.ndarray,
    angle_threshold_deg: float = 30.0,
    i_map: np.ndarray | None = None,
) -> dict[int, np.ndarray]:
    """Feasible pairs for correspondence matching.

    Args:
      extrinsics: ``(N, 4, 4)`` or ``(N, 3, 4)`` c2w poses.
      angle_threshold_deg: max relative rotation angle.
      i_map: optional ``(N,)`` original image indices of each row (the
        reference's train-split index remap).
    Returns:
      symmetric dict ``{img_i: array of img_j}`` (in ``i_map`` space).
    """
    extrinsics = np.asarray(extrinsics)
    n = extrinsics.shape[0]
    R = extrinsics[:, :3, :3]
    # angle(R_i^T R_j) = arccos((trace - 1) / 2), computed for all pairs.
    rel = np.einsum("nki,mkj->nmij", R, R)  # R_i^T @ R_j
    tr = np.trace(rel, axis1=-2, axis2=-1)
    angle = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))

    pairs: dict[int, list] = {}
    idx_of = (lambda i: int(i_map[i])) if i_map is not None else (lambda i: i)
    for i in range(n):
        for j in range(i + 1, n):
            if angle[i, j] < angle_threshold_deg:
                pairs.setdefault(idx_of(i), []).append(idx_of(j))
                pairs.setdefault(idx_of(j), []).append(idx_of(i))
    return {k: np.asarray(sorted(v)) for k, v in pairs.items()}


def flatten_pairs(pairs: dict[int, np.ndarray]) -> np.ndarray:
    """Unique (i, j) with i < j as an ``(P, 2)`` int array."""
    seen = set()
    for i, js in pairs.items():
        for j in js:
            seen.add((min(i, int(j)), max(i, int(j))))
    return np.asarray(sorted(seen), dtype=np.int64).reshape(-1, 2)
