"""Frozen copy of ``scnerf_tpu_torch/camera/distortion.py`` (the benchmark's plain reference).

Inverse radial-distortion lookup.

Port of ``scnerf_tpu/camera/distortion.py``: invert the per-axis forward
distortion ``f(c) = (1 + k1 d^2 + k2 d^4)(c - L/2) + L/2`` (with
``d = (c - L/2)/(L/2)``) by tabulating it on ``2^level + 1`` candidates,
finding each query's bracket in the table, and interpolating linearly
between the bracketing candidates. The interpolation is differentiable in
the query and in ``k``: the distortion-aware PRD reads ``k`` through it.

The bracket is a count, ``#{j : table[j] < loc}``, as the JAX package's
``searchsorted`` computes it for rows of up to 512 entries (one
``(M, 2^level + 1)`` comparison). The table is not sorted wherever
``1 + 3 k1 d^2 + 5 k2 d^4 < 0`` for some ``|d| <= 1`` (``k1 < -1/3`` with
``k2 = 0``): there a binary search such as ``torch.searchsorted`` finds
another bracket than the count does.
"""
from __future__ import annotations

import torch


def lookup_axis(L: float, k: torch.Tensor, loc: torch.Tensor, level: int = 8):
    """Invert the forward distortion along one axis of length ``L``.

    Args:
      L: axis length (W or H).
      k: ``(2,)`` distortion coefficients.
      loc: ``(M,)`` distorted coordinates to invert.
      level: the table has ``2^level + 1`` entries.
    Returns:
      (valid ``(M,)`` bool, idx ``(M,)`` int64 in ``[1, 2^level]``, table
      values ``(T,)``, candidates ``(T,)``).
    """
    n = 2**level
    candidate = torch.arange(0, n + 1, dtype=torch.float32, device=loc.device) * (L / n)
    d = (candidate - L / 2) / (L / 2)
    val = (1.0 + k[0] * d**2 + k[1] * d**4) * (candidate - L / 2) + L / 2

    idx = (loc[:, None] > val[None, :]).sum(-1)
    valid = torch.logical_and(idx <= n, idx > 0)
    return valid, torch.clamp(idx, 1, n), val, candidate


def undistort_pixels(W: int, H: int, k: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     level: int = 8):
    """Map distorted pixel coordinates back to undistorted ones.

    Returns:
      (valid ``(M,)`` bool, xy ``(M, 2)``).
    """
    vx, ix, val_x, cand_x = lookup_axis(float(W), k, x, level)
    vy, iy, val_y, cand_y = lookup_axis(float(H), k, y, level)
    valid = torch.logical_and(vx, vy)

    # index_select: its backward is one index_add (a plain x[t]'s is a
    # sort-based index_put).
    bx, ax = (val_x.index_select(0, i) for i in (ix - 1, ix))
    by, ay = (val_y.index_select(0, i) for i in (iy - 1, iy))
    x_out = (cand_x[ix] * (x - bx) + cand_x[ix - 1] * (ax - x)) / (ax - bx)
    y_out = (cand_y[iy] * (y - by) + cand_y[iy - 1] * (ay - y)) / (ay - by)
    return valid, torch.stack([x_out, y_out], dim=-1)
