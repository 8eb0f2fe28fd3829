"""``k2_roofline.<scope>``: K2's least time, its bytes (``counts.py``, at the
traced calls' shapes) at the HBM rate, over the device time of the kernels
launched under the ``scnerf_tpu_torch::sample_pdf_fwd`` operator in the
trace."""
from __future__ import annotations

from portbench.metrics.k1_roofline import roofline

OPERATOR = "scnerf_tpu_torch::sample_pdf_fwd"


def read(ctx: dict, scope: str) -> float | None:
    return roofline(ctx, OPERATOR)
