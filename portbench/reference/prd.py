"""Frozen copy of ``scnerf_tpu_torch/losses/prd.py`` (the benchmark's plain reference).

Projected Ray Distance (PRD), the paper's geometric calibration loss.

Port of ``scnerf_tpu/losses/prd.py``: fixed-size padded correspondence
batches with validity masks. For each correspondence, take the two camera
rays, find the closest points between them in closed form, project each
point into the *other* camera and penalise the squared pixel distance to the
matched keypoint; drop (train) or clamp (val/test) outliers beyond
``threshold``; drop points behind either camera (chirality).

The overflow guards of the JAX function are kept as they are: the floored
triangulation denominator, the clipped ray parameter, the sign-preserving
depth floor of the projection and the capped squared error. Without them
near-parallel ray pairs give partials of ~1e18 whose products with the zero
cotangents of masked-out entries turn into NaN in the backward (``0 * inf``),
in PyTorch's ``torch.where`` backward as in XLA's.
"""
from __future__ import annotations

import torch

from portbench.reference.distortion import undistort_pixels
from portbench.reference.reduce import global_count, share
from portbench.reference.so3 import se3_inverse

_EPS = 1e-10
_DENOM_MAX = -1e-4  # the triangulation denominator's ceiling
_T_MAX = 1e4  # |t| bound on the ray parameter
_Z_MIN = 1e-6  # |z| floor of the projection, sign kept
_L_MAX = 1e8  # squared-error cap


def _normalize(d: torch.Tensor) -> torch.Tensor:
    return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + _EPS)


def prd_pointwise(
    kps0: torch.Tensor,
    kps1: torch.Tensor,
    rays0: tuple,
    rays1: tuple,
    K: torch.Tensor,
    extrinsics_pair: torch.Tensor,
    method: str = "NeRF",
    distortion_k: torch.Tensor | None = None,
    image_wh: tuple | None = None,
):
    """Per-correspondence squared reprojection distances.

    Returns ``(loss0 (M,), loss1 (M,), chirality (M,))``: ``loss0`` is the
    distance in image 0 (the point of the ray pair projected into camera 0
    against ``kps0``), ``loss1`` likewise in image 1, ``chirality`` a float
    mask of the points in front of both cameras.

    ``distortion_k`` (with ``image_wh = (W, H)``) is the distortion-aware
    variant: with a radial-distortion camera the rays come from warped pixel
    coordinates, so the pinhole projection lands in warped space while the
    keypoints are raw pixels. The inverse-distortion lookup
    (``camera/distortion.py``) maps the projections back before the
    comparison, and a projection outside the table's range fails the
    validity mask, which multiplies ``chirality``. The lookup is
    differentiable in the projection and in ``k``: this is what makes ``k``
    observable through PRD.
    """
    if distortion_k is not None and image_wh is None:
        raise ValueError("distortion-aware PRD needs image_wh=(W, H)")
    if method == "NeRF":
        # Negate fx to bridge the OpenGL axes.
        K = torch.cat([torch.cat([-K[:1, :1], K[:1, 1:]], dim=1), K[1:]], dim=0)
    ext_inv = se3_inverse(extrinsics_pair)  # (2, 4, 4)

    o0, d0 = rays0
    o1, d1 = rays1
    d0 = _normalize(d0)
    d1 = _normalize(d1)

    r01 = torch.sum(d0 * d1, dim=-1)
    o_diff = o0 - o1
    # The reference's r01^2 - 1 + eps, floored: identical for every pair
    # whose rays subtend more than ~0.57 deg, bounded partials below that.
    denom = torch.clamp(r01**2 - 1.0 + _EPS, max=_DENOM_MAX)
    t0 = (torch.sum(d0 * o_diff, -1) - r01 * torch.sum(d1 * o_diff, -1)) / denom
    t1 = (torch.sum(d1 * -o_diff, -1) - r01 * torch.sum(d0 * -o_diff, -1)) / denom
    # Clipped entries keep their (filtered) value and get no t-gradient.
    t0 = torch.clamp(t0, -_T_MAX, _T_MAX)
    t1 = torch.clamp(t1, -_T_MAX, _T_MAX)

    p0 = o0 + t0[..., None] * d0
    p1 = o1 + t1[..., None] * d1

    def project(p, w2c):
        p4 = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
        pix = (p4 @ w2c.T) @ K.T
        # z + eps can round to exactly 0; a sign-preserving floor keeps the
        # partials bounded and leaves every |z| >= 1e-6 unchanged.
        z = pix[..., 2:3]
        z_floor = torch.where(z < 0, -_Z_MIN, _Z_MIN)
        z_safe = torch.where(torch.abs(z) < _Z_MIN, z_floor, z)
        return pix[..., :2] / z_safe

    p0_in_im1 = project(p0, ext_inv[1])
    p1_in_im0 = project(p1, ext_inv[0])

    chirality = torch.logical_and(t0 > 0, t1 > 0).to(torch.float32)
    if distortion_k is not None:
        W, H = image_wh
        v0, p1_in_im0 = undistort_pixels(W, H, distortion_k, p1_in_im0[..., 0], p1_in_im0[..., 1])
        v1, p0_in_im1 = undistort_pixels(W, H, distortion_k, p0_in_im1[..., 0], p0_in_im1[..., 1])
        chirality = chirality * v0.to(torch.float32) * v1.to(torch.float32)
    loss0 = torch.clamp(torch.sum((p1_in_im0 - kps0) ** 2, dim=-1), max=_L_MAX)
    loss1 = torch.clamp(torch.sum((p0_in_im1 - kps1) ** 2, dim=-1), max=_L_MAX)
    return loss0, loss1, chirality


def prd_loss(
    kps0: torch.Tensor,
    kps1: torch.Tensor,
    rays0: tuple,
    rays1: tuple,
    K: torch.Tensor,
    extrinsics_pair: torch.Tensor,
    mask: torch.Tensor | None = None,
    threshold: float = 5.0,
    method: str = "NeRF",
    mode: str = "train",
    distortion_k: torch.Tensor | None = None,
    image_wh: tuple | None = None,
):
    """PRD for one image pair over a padded batch of correspondences.

    Args:
      kps0, kps1: ``(M, 2)`` matched keypoints in images 0 / 1.
      rays0, rays1: (origins ``(M, 3)``, directions ``(M, 3)``) through the
        keypoints, from the camera under calibration.
      K: ``(4, 4)`` current intrinsics.
      extrinsics_pair: ``(2, 4, 4)`` current c2w extrinsics of the pair.
      mask: ``(M,)`` validity of each (padded) correspondence; None = all.
      threshold: squared-pixel-distance outlier threshold.
      method: "NeRF" negates fx (OpenGL axes); "NeRF++" leaves K as it is.
      mode: "train" drops outliers from the mean; "val"/"test" clamps them
        to ``threshold``.
      distortion_k, image_wh: the distortion-aware variant
        (:func:`prd_pointwise`).
    Returns:
      ``(loss, num_valid)``, both 0-d: the joint-validity count in train
      mode, the count of chirality-valid unpadded matches otherwise.
    """
    if mask is None:
        mask = torch.ones(kps0.shape[0], dtype=torch.bool, device=kps0.device)
    mask = mask.to(torch.float32)

    loss0, loss1, chirality = prd_pointwise(
        kps0, kps1, rays0, rays1, K, extrinsics_pair, method=method,
        distortion_k=distortion_k, image_wh=image_wh,
    )
    valid_base = mask * chirality

    if mode == "train":
        v0 = valid_base * (loss0 < threshold) * torch.isfinite(loss0)
        v1 = valid_base * (loss1 < threshold) * torch.isfinite(loss1)
        zero = loss0.new_zeros(())
        # Means over the valid matches of every rank in a data-parallel step.
        l0 = share(torch.sum(torch.where(v0 > 0, loss0, zero))
                   / torch.clamp(global_count(torch.sum(v0)), min=1.0))
        l1 = share(torch.sum(torch.where(v1 > 0, loss1, zero))
                   / torch.clamp(global_count(torch.sum(v1)), min=1.0))
        return 0.5 * (l0 + l1), global_count(torch.sum(v0 * v1))
    loss0 = torch.where(torch.logical_and(loss0 <= threshold, torch.isfinite(loss0)),
                        loss0, threshold)
    loss1 = torch.where(torch.logical_and(loss1 <= threshold, torch.isfinite(loss1)),
                        loss1, threshold)
    # Only chirality-valid unpadded matches enter the eval mean.
    count = torch.clamp(torch.sum(valid_base), min=1.0)
    l0 = torch.sum(loss0 * valid_base) / count
    l1 = torch.sum(loss1 * valid_base) / count
    return 0.5 * (l0 + l1), torch.sum(valid_base)
