"""``k3_roofline.<scope>``: K3's share of the card's dense TF32 peak: the
model FLOPs of the field queries that the traced requests sent through K3
(two a multiply-add, counted by the driver from the queries' shapes,
whatever implements them) over the device time of the kernels launched
under the ``scnerf_tpu_torch::fused_query_field`` operator in the trace,
against ``peaks.TF32_FLOP_PER_S``. K3 does each product in 3xTF32, three
passes on the tensor cores, so its own bound is a third of that peak: K3
at its bound reads 33.3%. ``None`` where the trace has no such operator or
the driver hands it no FLOPs."""
from __future__ import annotations

from portbench.metrics.peaks import TF32_FLOP_PER_S

OPERATOR = "scnerf_tpu_torch::fused_query_field"


def read(ctx: dict, scope: str) -> float | None:
    trace = ctx["trace"]
    seconds = trace["op_device_s"].get(OPERATOR) if trace else None
    flops = trace.get("op_flops", {}).get(OPERATOR) if trace else None
    if not seconds or not flops:
        return None
    return flops / TF32_FLOP_PER_S / seconds * 100.0
