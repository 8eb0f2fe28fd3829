"""``prd_step_ms.<scope>``: the median, over the window's PRD steps, of the
milliseconds between the CUDA events the harness records before and after
each one-step call (no synchronise between them)."""
from __future__ import annotations

import statistics


def read(ctx: dict, scope: str) -> float | None:
    ms = ctx["window"].get("prd_ms")
    return statistics.median(ms) if ms else None
