"""``k1_roofline.<scope>``: K1's least time, its bytes (``counts.py``, at the
traced calls' shapes) at the HBM rate, over the device time of the kernels
launched under the ``scnerf_tpu_torch::sample_pdf`` operator in the
trace."""
from __future__ import annotations

from portbench.metrics.peaks import HBM_BYTES_PER_S

OPERATOR = "scnerf_tpu_torch::sample_pdf"


def roofline(ctx: dict, operator: str) -> float | None:
    trace = ctx["trace"]
    seconds = trace["op_device_s"].get(operator) if trace else None
    n_bytes = trace["op_bytes"].get(operator) if trace else None
    if not seconds or not n_bytes:
        return None
    return n_bytes / HBM_BYTES_PER_S / seconds * 100.0


def read(ctx: dict, scope: str) -> float | None:
    return roofline(ctx, OPERATOR)
