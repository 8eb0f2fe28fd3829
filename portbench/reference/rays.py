"""Frozen copy of ``scnerf_tpu_torch/camera/rays.py`` (the benchmark's plain reference).

Ray generation through the learnable camera.

Port of ``scnerf_tpu/camera/rays.py``. :func:`pixels_to_rays` handles both
coordinate conventions:

- ``opengl`` (NeRF): dirs = K^-1 [x, y, 1], then negate y and z.
- ``opencv`` (NeRF++): dirs = K^-1 [u+0.5, v+0.5, 1], with optional radial
  distortion applied to the pixels first.
"""
from __future__ import annotations

import torch

from portbench.reference.camera import (
    OPENCV,
    OPENGL,
    Camera,
    get_distortion,
    get_extrinsic,
    get_intrinsic,
    ray_d_noise_at,
    ray_o_noise_at,
)
from portbench.reference.so3 import K_inverse_3x3

_EPS = 1e-10


def apply_radial_distortion(px, py, cx, cy, k1, k2):
    """Per-axis normalised radial warp: ``p' = (p - c)(1 + r²k1 + r⁴k2) + c``
    with ``r = (p - c) / c``."""
    rx = (px - cx) / cx
    ry = (py - cy) / cy
    px = (px - cx) * (1.0 + rx**2 * k1 + rx**4 * k2) + cx
    py = (py - cy) * (1.0 + ry**2 * k1 + ry**4 * k2) + cy
    return px, py


def _rotate(c2w: torch.Tensor, dirs: torch.Tensor):
    """World-frame rays from camera-frame dirs and one or per-ray c2w."""
    if c2w.ndim == 3:
        rays_d = torch.einsum("mij,mj->mi", c2w[:, :3, :3], dirs)
        rays_o = c2w[:, :3, 3]
    else:
        rays_d = dirs @ c2w[:3, :3].T
        rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def pixels_to_rays(
    camera: Camera,
    px,
    py,
    c2w: torch.Tensor | None = None,
    image_idx=None,
    add_noise: bool = True,
):
    """Rays through pixels ``(px, py)`` of one (or per-ray many) camera(s).

    Args:
      px, py: ``(M,)`` integer pixel coordinates (column, row); the
        convention's center offset is added here.
      c2w: optional ``(4, 4)`` or ``(M, 4, 4)``; else decoded from the camera
        at ``image_idx`` (scalar or ``(M,)``).
      add_noise: include the learnable ray o/d noise grids.
    Returns:
      ``(rays_o, rays_d)``, each ``(M, 3)`` on the camera's device.
      ``rays_d`` is L2-normalised iff noise is on.
    """
    cfg = camera.config
    device = camera.device
    px = torch.as_tensor(px, dtype=torch.float32, device=device)
    py = torch.as_tensor(py, dtype=torch.float32, device=device)
    if c2w is None:
        if isinstance(image_idx, torch.Tensor):
            image_idx = image_idx.to(device)
        c2w = get_extrinsic(camera, image_idx)
    K = get_intrinsic(camera)

    u = px + cfg.pixel_offset
    v = py + cfg.pixel_offset
    if cfg.convention == OPENCV and cfg.use_distortion:
        k = get_distortion(camera)
        u, v = apply_radial_distortion(u, v, K[0, 2], K[1, 2], k[0], k[1])

    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1)  # (M, 3)
    dirs = pix @ K_inverse_3x3(K).T
    if cfg.convention == OPENGL:
        # Negate y and z (no constant tensor: its host-to-device copy would
        # wait for the device).
        dirs = torch.cat([dirs[..., :1], -dirs[..., 1:]], dim=-1)

    rays_o, rays_d = _rotate(c2w, dirs)
    if add_noise:
        rays_o = rays_o + ray_o_noise_at(camera, px, py)
        rays_d = rays_d + ray_d_noise_at(camera, px, py)
        rays_d = rays_d / (torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True) + _EPS)
    return rays_o, rays_d
