"""Frozen copy of ``scnerf_tpu_torch/sampling/searchsorted.py`` (the benchmark's plain reference).

Batched row-wise sorted search.

Port of ``scnerf_tpu/sampling/searchsorted.py`` on ``torch.searchsorted``,
with the same broadcast rule: either input may have one row.
"""
from __future__ import annotations

import torch


def searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Row-wise ``searchsorted``.

    Args:
      a: ``(Ba, N)`` sorted rows.
      v: ``(Bv, M)`` query rows. ``Ba`` and ``Bv`` must match or one must be 1.
      side: "left" (first index where ``a[i] >= v``) or "right"
        (first index where ``a[i] > v``).
    Returns:
      ``(max(Ba, Bv), M)`` int32 insertion indices in ``[0, N]``.
    """
    if a.ndim != 2 or v.ndim != 2:
        raise ValueError(f"expected 2D inputs, got {tuple(a.shape)} and {tuple(v.shape)}")
    Ba, N = a.shape
    Bv, M = v.shape
    if Ba != Bv:
        if Ba == 1:
            a = a.expand(Bv, N)
        elif Bv == 1:
            v = v.expand(Ba, M)
        else:
            raise ValueError(f"batch mismatch: {Ba} vs {Bv}")
    if side not in ("left", "right"):
        raise ValueError(f"side must be left/right, got {side}")
    return torch.searchsorted(a.contiguous(), v.contiguous(), side=side, out_int32=True)
