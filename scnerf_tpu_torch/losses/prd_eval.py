"""Projected-ray-distance evaluation over image pairs.

Port of ``scnerf_tpu/losses/prd_eval.py``: for every feasible pair of the
evaluated split, take the cached correspondences, (val/test) keep only the
matches that the *ground-truth* camera triangulates to < 1 px reprojection
error in both directions with positive ray parameters, then compute the
clamped PRD with the *evaluated* camera; report the NaN-skipped mean over
pairs. A host loop over pairs on ``losses/prd.py``; it reads each pair's
value back from the device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from scnerf_tpu_torch.losses.prd import prd_loss, prd_pointwise
from scnerf_tpu_torch.matching.provider import PrecomputedMatches, pad_matches

GT_FILTER_THRESHOLD = 1.0  # px^2, the reference's prd_evaluation.py:331


def filter_matches_with_gt(
    kps0,
    kps1,
    rays0_gt,
    rays1_gt,
    gt_K,
    gt_E_pair,
    method: str,
) -> torch.Tensor:
    """Boolean keep-mask: GT-camera PRD < 1 px both ways + chirality."""
    loss0, loss1, chirality = prd_pointwise(
        kps0, kps1, rays0_gt, rays1_gt, gt_K, gt_E_pair, method=method
    )
    return (loss0 < GT_FILTER_THRESHOLD) & (loss1 < GT_FILTER_THRESHOLD) & (chirality > 0)


@torch.no_grad()
def prd_evaluation(
    pairs: np.ndarray,
    match_cache: PrecomputedMatches,
    rays_eval: Callable,
    K_eval,
    E_eval,
    mode: str,
    method: str,
    rays_gt: Callable | None = None,
    gt_K=None,
    gt_E=None,
    max_matches: int = 1024,
    threshold: float = 5.0,
    *,
    device: torch.device | str = "cuda",
) -> float:
    """Mean PRD over feasible pairs.

    Args:
      pairs: ``(P, 2)`` image-index pairs (i < j).
      match_cache: correspondence store.
      rays_eval: ``(kps (M, 2) tensor, img_idx) -> (o, d)`` with the
        evaluated camera (noise included).
      K_eval, E_eval: evaluated 4x4 K and per-image (N, 4, 4) extrinsics,
        tensors or arrays (for val/test with a camera model, E_eval are the
        GT extrinsics, the reference's contract).
      mode: "train" | "val" | "test" (val/test filter with GT + clamp).
      rays_gt / gt_K / gt_E: GT-camera ray function + parameters, required
        for the val/test match filter.
      device: where the keypoints and the evaluation go.
    Returns:
      NaN-skipped mean PRD (float); NaN when no pair produced a value.
    """
    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    K_eval, E_eval = tensor(K_eval), tensor(E_eval)
    if mode in ("val", "test"):
        if rays_gt is None or gt_K is None or gt_E is None:
            raise ValueError(f"mode={mode!r} needs rays_gt, gt_K and gt_E")
        gt_K, gt_E = tensor(gt_K), tensor(gt_E)
    vals = []
    for i, j in np.asarray(pairs):
        i, j = int(i), int(j)
        m = match_cache.get(i, j)
        if m is None or m.kps0.shape[0] == 0:
            continue
        kps0, kps1, mask = pad_matches(m, max_matches)
        kps0, kps1 = tensor(kps0), tensor(kps1)
        mask = torch.as_tensor(mask, device=device)

        if mode in ("val", "test"):
            keep = filter_matches_with_gt(
                kps0, kps1, rays_gt(kps0, i), rays_gt(kps1, j), gt_K,
                gt_E[[i, j]], method,
            )
            mask = mask & keep

        loss, n = prd_loss(
            kps0, kps1, rays_eval(kps0, i), rays_eval(kps1, j), K_eval, E_eval[[i, j]],
            mask=mask, threshold=threshold, method=method, mode=mode,
        )
        loss = float(loss)
        if np.isfinite(loss) and float(n) > 0:
            vals.append(loss)
    return float(np.mean(vals)) if vals else float("nan")
