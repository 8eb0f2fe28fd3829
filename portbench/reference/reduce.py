"""Single-process counterparts of ``scnerf_tpu_torch/distributed/reduce.py``
(the benchmark's plain reference runs on one device, with no process
group): a share is the value itself, a count itself, a batch mean the
mean."""
from __future__ import annotations

import torch


def share(x: torch.Tensor) -> torch.Tensor:
    return x


def global_count(count: torch.Tensor) -> torch.Tensor:
    return count


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x)
