"""``device_idle_share.<scope>``: the share of the traced window in which no
kernel, copy or fill ran on the card, ``1 - union / window``."""
from __future__ import annotations


def read(ctx: dict, scope: str) -> float | None:
    trace = ctx["trace"]
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0
