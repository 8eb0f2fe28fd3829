"""Step timing.

Port of ``scnerf_tpu/train/profiling.py:StepTimer``: wall-clock time per
step on the host, with a warm-up skip and a percentile summary. The step
returns before the device has run it, so in a loop that never waits for the
device a step's host time is its dispatch, until the device's queue is full
and the host waits at a launch: the steady state then measures the device's
pace.
"""
from __future__ import annotations

import time

import numpy as np


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return False

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "max_ms": float(arr.max() * 1e3),
        }
