"""``optimizer_device_ms.<scope>``: device milliseconds a step of the
kernels launched inside the train step's ``scnerf.step.optimizer`` span
(the curriculum's mask, the optimizer's update and its application), from
the traced steps' host-and-device trace, over their count."""
from __future__ import annotations

SPAN = "scnerf.step.optimizer"


def read(ctx: dict, scope: str) -> float | None:
    trace = ctx["trace"]
    seconds = trace["op_device_s"].get(SPAN) if trace else None
    if not seconds or not trace["units"]:
        return None
    return seconds / trace["units"] * 1e3
