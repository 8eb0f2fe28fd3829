"""Unit-sphere geometry for NeRF++'s inverted-sphere background.

Port of ``scnerf_tpu/geometry/sphere.py``: the far intersection of a ray with
the unit sphere, and the ``(x', y', z', 1/r)`` parameterisation of points
beyond it. Camera centres are assumed to lie inside the sphere.
"""
from __future__ import annotations

import torch

TINY_NUMBER = 1e-6
HUGE_NUMBER = 1e10


def intersect_sphere(ray_o: torch.Tensor, ray_d: torch.Tensor) -> torch.Tensor:
    """Depth, along the unnormalised ``ray_d``, of the far intersection of
    each ray ``(..., 3)`` with the unit sphere -> ``(...,)``."""
    d1 = -torch.sum(ray_d * ray_o, dim=-1) / torch.sum(ray_d * ray_d, dim=-1)
    p = ray_o + d1[..., None] * ray_d
    ray_d_cos = 1.0 / torch.linalg.vector_norm(ray_d, dim=-1)
    p_norm_sq = torch.sum(p * p, dim=-1)
    d2 = torch.sqrt(torch.clamp(1.0 - p_norm_sq, min=0.0)) * ray_d_cos
    return d1 + d2


def depth2pts_outside(ray_o: torch.Tensor, ray_d: torch.Tensor, depth: torch.Tensor):
    """Points beyond the unit sphere as ``(x', y', z', 1/r)``.

    Args:
      ray_o, ray_d: ``(..., 3)``.
      depth: ``(...,)`` inverse distance in ``[0, 1]``.
    Returns:
      (pts ``(..., 4)``, real_depth ``(...,)``).
    """
    d1 = -torch.sum(ray_d * ray_o, dim=-1) / torch.sum(ray_d * ray_d, dim=-1)
    p_mid = ray_o + d1[..., None] * ray_d
    p_mid_norm = torch.linalg.vector_norm(p_mid, dim=-1)
    ray_d_cos = 1.0 / torch.linalg.vector_norm(ray_d, dim=-1)
    d2 = torch.sqrt(torch.clamp(1.0 - p_mid_norm * p_mid_norm, min=0.0)) * ray_d_cos
    p_sphere = ray_o + (d1 + d2)[..., None] * ray_d

    rot_axis = torch.linalg.cross(ray_o, p_sphere, dim=-1)
    rot_axis = rot_axis / torch.clamp(
        torch.linalg.vector_norm(rot_axis, dim=-1, keepdim=True), min=TINY_NUMBER)
    phi = torch.asin(torch.clamp(p_mid_norm, -1.0, 1.0))
    theta = torch.asin(torch.clamp(p_mid_norm * depth, -1.0, 1.0))
    rot_angle = (phi - theta)[..., None]

    cosr = torch.cos(rot_angle)
    sinr = torch.sin(rot_angle)
    p_new = (
        p_sphere * cosr
        + torch.linalg.cross(rot_axis, p_sphere, dim=-1) * sinr
        + rot_axis * torch.sum(rot_axis * p_sphere, dim=-1, keepdim=True) * (1.0 - cosr)
    )
    p_new = p_new / torch.clamp(
        torch.linalg.vector_norm(p_new, dim=-1, keepdim=True), min=TINY_NUMBER)
    pts = torch.cat([p_new, depth[..., None]], dim=-1)

    depth_real = 1.0 / (depth + TINY_NUMBER) * torch.cos(theta) * ray_d_cos + d1
    return pts, depth_real
