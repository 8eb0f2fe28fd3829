"""Frozen copy of ``scnerf_tpu_torch/geometry/so3.py`` (the benchmark's plain reference).

SO(3) helpers used by the learnable camera.

Port of ``scnerf_tpu/geometry/so3.py``: the 6D (Gram-Schmidt) rotation and
its inverse, the 4x4 embedding, the rigid inverse, and the pinhole K and
its closed-form inverse (the conversions no step uses are left out).
Same clamps and epsilons, so a calibration learned by the JAX package decodes
to the same matrices here.
"""
from __future__ import annotations

import torch

_EPS_MAG = 1e-8
_EPS_DIV = 1e-10


def _normalize(v: torch.Tensor) -> torch.Tensor:
    mag = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    mag = torch.clamp(mag, min=_EPS_MAG)
    return v / (mag + _EPS_DIV)


def ortho2rotation(poses: torch.Tensor) -> torch.Tensor:
    """6D rotation ``(..., 6)`` -> rotation matrices ``(..., 3, 3)``.

    Columns of the result are ``(x, y, x × y)``, with ``y`` projected off
    ``x`` before normalising.
    """
    x_raw = poses[..., 0:3]
    y_raw = poses[..., 3:6]
    x = _normalize(x_raw)
    inner = torch.sum(x * y_raw, dim=-1, keepdim=True)
    norm2 = torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=_EPS_MAG)
    y = _normalize(y_raw - (inner / (norm2 + _EPS_DIV)) * x)
    z = torch.linalg.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def rotation2orth(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``(..., 3, 3)`` -> 6D rep (first two columns)."""
    return torch.cat([rot[..., :, 0], rot[..., :, 1]], dim=-1)


def embed_rotation_44(R: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` -> homogeneous ``(..., 4, 4)``."""
    out = R.new_zeros(R.shape[:-2] + (4, 4))
    out[..., :3, :3] = R
    # A slice, not out[..., 3, 3]: for one matrix that is a 0-d view, and
    # writing a Python number into a 0-d CUDA view copies it from the host
    # and waits for the device.
    out[..., 3, 3:] = 1.0
    return out


def se3_inverse(E: torch.Tensor) -> torch.Tensor:
    """Invert rigid transforms ``(..., 4, 4)`` without a linear solve:
    ``[R | t]^-1 = [R^T | -R^T t]``."""
    Rt = E[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", Rt, E[..., :3, 3])
    top = torch.cat([Rt, t[..., None]], dim=-1)
    bottom = torch.zeros_like(E[..., 3:, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def intrinsic_param_to_K(intrinsics: torch.Tensor) -> torch.Tensor:
    """``[fx, fy, cx, cy]`` -> 4x4 K."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, zero, cx, zero]),
        torch.stack([zero, fy, cy, zero]),
        torch.stack([zero, zero, one, zero]),
        torch.stack([zero, zero, zero, one]),
    ])


def K_inverse_3x3(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of an upper-triangular pinhole K (3x3 or 4x4)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    zero = torch.zeros_like(fx)
    return torch.stack([
        torch.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)]),
        torch.stack([zero, 1.0 / fy, -cy / fy]),
        torch.stack([zero, zero, torch.ones_like(fx)]),
    ])
