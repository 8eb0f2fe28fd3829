"""SO(3) helpers used by the learnable camera.

Port of ``scnerf_tpu/geometry/so3.py``: the 6D (Gram-Schmidt) rotation and
its inverse, axis-angle (Rodrigues) and Euler conversions, the 4x4
embedding, the rigid inverse, and the pinhole K and its closed-form inverse.
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


def axis_angle_to_rotation(axis: torch.Tensor, angle) -> torch.Tensor:
    """Rodrigues' formula, batched: unit axes ``(..., 3)`` and angles
    ``(...,)`` or ``(..., 1)`` in radians -> ``(..., 3, 3)``."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    if angle.ndim == axis.ndim:
        angle = angle[..., 0]
    ca, sa = torch.cos(angle), torch.sin(angle)
    c1 = 1.0 - ca
    x, y, z = axis.unbind(-1)
    row0 = torch.stack([x * x * c1 + ca, x * y * c1 - z * sa, z * x * c1 + y * sa], dim=-1)
    row1 = torch.stack([x * y * c1 + z * sa, y * y * c1 + ca, y * z * c1 - x * sa], dim=-1)
    row2 = torch.stack([z * x * c1 - y * sa, y * z * c1 + x * sa, z * z * c1 + ca], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_to_axis_angle(R: torch.Tensor):
    """Inverse Rodrigues: ``(..., 3, 3)`` -> (unit axis ``(..., 3)``, angle
    ``(...,)``). The angle is the clipped ``arccos`` of the trace; the axis
    norm is floored at ``_EPS_MAG``, so at angle 0 the axis is 0."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    angle = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    ax = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                      R[..., 0, 2] - R[..., 2, 0],
                      R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    norm = torch.linalg.vector_norm(ax, dim=-1, keepdim=True)
    return ax / torch.clamp(norm, min=_EPS_MAG), angle


def euler_to_rotation(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles ``(..., 3)`` -> ``(..., 3, 3)``, ``RZ @ RY @ RX`` of the
    negated angles: the reference's ``rot_from_angle`` stacks each axis
    rotation's rows where columns belong, which transposes it, the same as
    negating its angle. :func:`rotation_to_euler` negates back."""
    ax, ay, az = (-euler).unbind(-1)
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    zeros, ones = torch.zeros_like(ax), torch.ones_like(ax)

    def matrix(rows):
        return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)

    RX = matrix([[ones, zeros, zeros], [zeros, cx, -sx], [zeros, sx, cx]])
    RY = matrix([[cy, zeros, sy], [zeros, ones, zeros], [-sy, zeros, cy]])
    RZ = matrix([[cz, -sz, zeros], [sz, cz, zeros], [zeros, zeros, ones]])
    return RZ @ RY @ RX


def rotation_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`euler_to_rotation` (the reference's
    ``angle_from_rot``): ``(..., 3, 3)`` -> ``(..., 3)``."""
    x = -torch.atan2(R[..., 2, 1], R[..., 2, 2])
    y = -torch.atan2(-R[..., 2, 0], torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    z = -torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([x, y, z], dim=-1)


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
