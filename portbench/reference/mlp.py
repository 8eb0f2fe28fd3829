"""Frozen copy of ``scnerf_tpu_torch/fields/mlp.py`` (the benchmark's plain reference).

Dense layers as plain dicts of tensors.

Port of ``scnerf_tpu/fields/mlp.py``: ``{"w": (in, out), "b": (out,)}``, the
JAX layout, so parameters cross between the packages without transposes.
Xavier-uniform init with the activation's gain (sqrt(2) for relu, 1 for
linear), zero bias.
"""
from __future__ import annotations

import math

import torch


def init_dense(in_dim: int, out_dim: int, activation: str = "relu", *,
               generator: torch.Generator | None = None,
               device: torch.device | str = "cuda",
               dtype: torch.dtype = torch.float32) -> dict:
    """Draws on the CPU from ``generator`` (a CPU generator), so a seed gives
    the same weights whatever ``device`` they are then moved to."""
    gain = math.sqrt(2.0) if activation == "relu" else 1.0
    limit = gain * math.sqrt(6.0 / (in_dim + out_dim))
    w = torch.rand((in_dim, out_dim), generator=generator, dtype=dtype)
    w = (w * (2.0 * limit) - limit).to(device)
    return {"w": w, "b": torch.zeros((out_dim,), dtype=dtype, device=device)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` over the last axis of ``x``."""
    w, b = params["w"], params["b"]
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])
