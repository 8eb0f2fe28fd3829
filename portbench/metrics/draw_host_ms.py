"""``draw_host_ms.<scope>``: the host's milliseconds a step in the loop's
``scnerf.loop.draw`` span (the pixel draw, the target gather, the pack into
pinned memory and the copy's enqueue), median over the traced steps
(``recorded.py``)."""
from __future__ import annotations

from portbench.metrics.recorded import median_ms


def read(ctx: dict, scope: str) -> float | None:
    return median_ms(ctx, "scnerf.loop.step", ("scnerf.loop.draw",))
