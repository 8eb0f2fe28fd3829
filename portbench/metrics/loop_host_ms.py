"""``loop_host_ms.<scope>``: the host's milliseconds a step in the window,
by the harness's clock around each of its calls into the driver's loop (one
step a call, no synchronise): what the loop costs the host, or, where the
device is behind, how long the host waits for it."""
from __future__ import annotations


def read(ctx: dict, scope: str) -> float | None:
    spans = ctx["window"].get("spans_ms")
    return sum(spans) / len(spans) if spans else None
