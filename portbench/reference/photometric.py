"""Frozen copy of ``scnerf_tpu_torch/losses/photometric.py`` (the benchmark's plain reference).

Photometric losses and PSNR.

Port of ``scnerf_tpu/losses/photometric.py``. The means are over the whole
batch inside a data-parallel step (``distributed/reduce.py``).
"""
from __future__ import annotations

import math

import torch

from portbench.reference.reduce import batch_mean, global_count, share


def img2mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return batch_mean((pred - target) ** 2)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE over the valid entries only (the NeRF++ mask path)."""
    mask = mask[..., None].expand(pred.shape).to(pred.dtype)
    denom = torch.clamp(global_count(torch.sum(mask)), min=1.0)
    return share(torch.sum(mask * (pred - target) ** 2) / denom)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(torch.clamp(mse, min=1e-12)) / math.log(10.0)
