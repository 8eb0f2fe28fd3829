"""``fused_point_share.<scope>``: the share of the field points that the
serve function queried in the traced requests that went through the fields'
inference twins (``query_field_fused``, ``query_mlpnet_fused``: the early
fields with their bias and ReLU in the products' epilogues and no
concatenation pass), ``serve.field_points_fused / serve.field_points``, from
the program's counters (``recorded.py``). ``None`` where the program keeps
no such counters, as a program without the twins keeps none."""
from __future__ import annotations

from portbench.metrics.recorded import recorder


def read(ctx: dict, scope: str) -> float | None:
    rec = recorder(ctx)
    counts = rec.counters() if rec is not None else {}
    if not counts.get("serve.field_points") or "serve.field_points_fused" not in counts:
        return None
    return counts["serve.field_points_fused"] / counts["serve.field_points"] * 100.0
