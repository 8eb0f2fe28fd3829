"""Frozen copy of ``scnerf_tpu_torch/geometry/ndc.py`` (the benchmark's plain reference).

NDC ray warp for forward-facing (LLFF) scenes.

Port of ``scnerf_tpu/geometry/ndc.py``. One function covers the fixed-focal
and the learned-camera variants (``fx == fy == focal`` reduces to the former).
"""
from __future__ import annotations

import torch


def ndc_rays(H: int, W: int, focal_x, focal_y, near, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """Warp rays ``(..., 3)`` into NDC space; returns ``(rays_o, rays_d)``.

    ``focal_x``/``focal_y`` are Python floats or 0-d tensors (a learned K).
    """
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o.unbind(-1)
    dx, dy, dz = rays_d.unbind(-1)

    o0 = -1.0 / (W / (2.0 * focal_x)) * ox / oz
    o1 = -1.0 / (H / (2.0 * focal_y)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz

    d0 = -1.0 / (W / (2.0 * focal_x)) * (dx / dz - ox / oz)
    d1 = -1.0 / (H / (2.0 * focal_y)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
