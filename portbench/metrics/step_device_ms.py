"""``step_device_ms.<scope>``: device milliseconds a step, the durations of
every kernel, copy and fill in the traced steps (``torch.profiler``) over
their count."""
from __future__ import annotations


def read(ctx: dict, scope: str) -> float | None:
    trace = ctx["trace"]
    if not trace or not trace["units"] or trace["kernel_s"] <= 0:
        return None
    return trace["kernel_s"] / trace["units"] * 1e3
