"""``k3_point_share.<scope>``: the share of the field points that the NeRF
serve function queried in the traced requests that went through K3,
``serve.field_points_k3 / serve.field_points``, from the program's counters
(``recorded.py``). ``None`` where the program keeps no such counters."""
from __future__ import annotations

from portbench.metrics.recorded import recorder


def read(ctx: dict, scope: str) -> float | None:
    rec = recorder(ctx)
    counts = rec.counters() if rec is not None else {}
    if not counts.get("serve.field_points"):
        return None
    return counts.get("serve.field_points_k3", 0) / counts["serve.field_points"] * 100.0
