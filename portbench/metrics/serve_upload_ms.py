"""``serve_upload_ms.<scope>``: the host's milliseconds a request in
``RenderService``'s ``scnerf.serve.upload`` span (the request's arrays to
the card as float32, and the edge padding), median over the traced
requests (``recorded.py``)."""
from __future__ import annotations

from portbench.metrics.recorded import median_ms


def read(ctx: dict, scope: str) -> float | None:
    return median_ms(ctx, "scnerf.serve.request", ("scnerf.serve.upload",))
