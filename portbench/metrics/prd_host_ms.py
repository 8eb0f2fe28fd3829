"""``prd_host_ms.<scope>``: the host's milliseconds of PRD a PRD step, the
loop's ``scnerf.loop.prd_draw`` (the pair, its matches and their copy) and
the step's ``scnerf.step.prd`` (the loss's launches) together, median over
the traced PRD steps (``recorded.py``)."""
from __future__ import annotations

from portbench.metrics.recorded import median_ms


def read(ctx: dict, scope: str) -> float | None:
    return median_ms(ctx, "scnerf.loop.step", ("scnerf.loop.prd_draw", "scnerf.step.prd"))
