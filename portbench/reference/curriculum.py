"""Frozen copy of ``scnerf_tpu_torch/train/curriculum.py`` (the benchmark's plain reference).

Camera-parameter curriculum as gradient masking.

Port of ``scnerf_tpu/train/curriculum.py``: the curriculum is a pure
function of the step counter. The gradients of the camera groups not yet
unlocked are multiplied by zero before the optimizer (so a locked group
still decays where the optimizer adds weight decay), and the PRD weight and
cadence are read off the step.

Thresholds (the reference's flag names):
- ``add_ie``: intrinsics + extrinsics noise;
- ``add_od``: ray-origin / ray-direction grids;
- ``add_radial``: distortion noise;
- ``add_prd``: PRD loss activation (a loss weight, not a gradient mask).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Curriculum:
    add_ie: int = 0
    add_od: int = 0
    add_radial: int = 0
    add_prd: int = 0
    # PRD cadence and weight.
    i_ray_dist_loss: int = 10
    ray_dist_loss_weight: float = 1e-4
    # Calibration-phase anneal of the PRD protocol: from step
    # prd_anneal_until on, the weight is ray_dist_loss_weight_after and the
    # cadence i_ray_dist_loss_after (0 = no anneal).
    prd_anneal_until: int = 0
    ray_dist_loss_weight_after: float = 1e-4
    i_ray_dist_loss_after: int = 10


# Camera leaf -> the threshold that unlocks its gradient.
_UNLOCKED_BY = {
    "intrinsics_noise": "add_ie",
    "extrinsics_noise": "add_ie",
    "ray_o_grid": "add_od",
    "ray_d_grid": "add_od",
    "distortion_noise": "add_radial",
}


def mask_camera_grads(grads: dict[str, torch.Tensor | None], step: int,
                      cur: Curriculum) -> dict[str, torch.Tensor | None]:
    """Gradients by camera leaf name or by path (``"camera/ray_o_grid"``):
    those of the camera groups not yet unlocked at ``step`` multiplied by
    zero; other entries, and missing (None) gradients, pass through."""
    out = {}
    for key, g in grads.items():
        threshold = _UNLOCKED_BY.get(key.rsplit("/", 1)[-1])
        out[key] = g if threshold is None or g is None else (
            g * float(step >= getattr(cur, threshold)))
    return out


def prd_active(step: int, cur: Curriculum) -> float:
    """The weight of the PRD loss at ``step`` (0 before ``add_prd``)."""
    w = cur.ray_dist_loss_weight
    if cur.prd_anneal_until > 0 and step >= cur.prd_anneal_until:
        w = cur.ray_dist_loss_weight_after
    return float(step >= cur.add_prd) * w
