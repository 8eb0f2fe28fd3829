"""Metric logging.

Port of ``scnerf_tpu/train/logging_utils.py``: a JSONL file logger that is
always on, wandb attached only when asked for and importable (imported
where it is used), the ``config.json`` snapshot of the experiment, and image
summaries written as PNGs by ``core/imaging.write_png`` (no ``imageio``:
the images are always written, never skipped).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from scnerf_tpu_torch.core.imaging import write_png


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 when no
    group is up."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _scalar(v):
    """A number as a float: a one-element tensor by one ``.item()`` (which
    waits for the device), others by ``float``; non-numbers pass."""
    if isinstance(v, torch.Tensor) and v.numel() == 1:
        return float(v.item())
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class MetricLogger:
    """Coordinator-only by default: on a multi-process run, every rank but 0
    no-ops every call (the reference's rank-0 gating of its writes)."""

    def __init__(self, expdir: str, use_wandb: bool = False, wandb_kwargs: dict | None = None,
                 coordinator_only: bool = True):
        self.expdir = expdir
        self._active = not coordinator_only or process_rank() == 0
        self._f = None
        self._wandb = None
        if not self._active:
            return
        os.makedirs(expdir, exist_ok=True)
        self._f = open(os.path.join(expdir, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                print(f"[log] wandb unavailable ({e}); JSONL only")
            else:
                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))

    def log(self, step: int, metrics: dict[str, Any]) -> None:
        """Append one row: ``step``, the wall-clock ``time`` and ``metrics``
        (0-d tensors are read from the device here)."""
        if not self._active:
            return
        row = {"step": int(step), "time": time.time()}
        row.update({k: _scalar(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in row.items() if k != "step"}, step=step)

    def log_images(self, step: int, images: dict[str, Any]) -> None:
        """Image summaries: each (H, W, 3) float [0, 1] array is written to
        ``expdir/images/{name}_{step:08d}.png`` and, when wandb is attached,
        logged as a wandb.Image."""
        if not self._active or not images:
            return
        img_dir = os.path.join(self.expdir, "images")
        os.makedirs(img_dir, exist_ok=True)
        wb = {}
        for name, img in images.items():
            arr = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
            u8 = (arr * 255.0).round().astype(np.uint8)
            fname = f"{name.replace('/', '_')}_{int(step):08d}.png"
            write_png(os.path.join(img_dir, fname), u8)
            if self._wandb is not None:
                wb[name] = self._wandb.Image(u8)
        if wb:
            self._wandb.log(wb, step=int(step))

    def snapshot_config(self, config_json: str) -> None:
        if not self._active:
            return
        with open(os.path.join(self.expdir, "config.json"), "w") as f:
            f.write(config_json)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
