"""``serve_pad_share.<scope>``: the share of the rays that ``RenderService``
ran in the traced requests that nobody asked for, the padding of the last
slice, ``1 - serve.rays / serve.rays_run``, from the program's counters
(``recorded.py``)."""
from __future__ import annotations

from portbench.metrics.recorded import recorder


def read(ctx: dict, scope: str) -> float | None:
    rec = recorder(ctx)
    counts = rec.counters() if rec is not None else {}
    if not counts.get("serve.rays_run"):
        return None
    return (1.0 - counts.get("serve.rays", 0) / counts["serve.rays_run"]) * 100.0
