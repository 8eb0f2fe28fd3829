"""``mfu.<scope>``: the model FLOPs of the window's work (``counts.py``) over
the window's seconds, as a share of the card's dense TF32 peak: the whole
step's (or request's) share, which bounds every kernel's."""
from __future__ import annotations

from portbench.metrics.peaks import TF32_FLOP_PER_S


def read(ctx: dict, scope: str) -> float | None:
    w = ctx["window"]
    if not w.get("flops") or w["seconds"] <= 0:
        return None
    return w["flops"] / w["seconds"] / TF32_FLOP_PER_S * 100.0
