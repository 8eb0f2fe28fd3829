"""The reduction of a Chrome trace to the per-layer metrics' numbers, on a
trace written by hand."""
from __future__ import annotations

import pytest

from portbench.metrics import device_idle_share, k1_roofline, step_device_ms
from portbench.metrics.peaks import HBM_BYTES_PER_S
from portbench.trace import WINDOW_RANGE, summarize


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


EVENTS = [
    x("user_annotation", WINDOW_RANGE, 0, 100),
    x("cpu_op", "scnerf_tpu_torch::sample_pdf", 10, 10),
    x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
    x("cpu_op", "aten::addmm", 30, 10),
    x("cuda_runtime", "cudaLaunchKernel", 32, 2, correlation=2),
    x("cuda_runtime", "cudaLaunchKernel", 35, 2, correlation=3),
    x("cpu_op", "aten::item", 60, 30),
    x("kernel", "pdf_kernel", 15, 5, tid=7, correlation=1),
    x("kernel", "gemm", 40, 20, tid=7, correlation=2),
    x("kernel", "gemm", 50, 20, tid=7, correlation=3),
    x("gpu_memcpy", "Memcpy DtoH", 90, 5, tid=7),
]


def test_summarize_a_trace_by_hand():
    s = summarize(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((5 + 30 + 5) * 1e-6)  # the gemms overlap
    assert s["kernel_s"] == pytest.approx((5 + 20 + 20 + 5) * 1e-6)
    assert s["op_device_s"]["scnerf_tpu_torch::sample_pdf"] == pytest.approx(5e-6)
    assert s["op_device_s"]["aten::addmm"] == pytest.approx(40e-6)
    assert s["device_ops"][0] == ["gemm", pytest.approx(40e-6)]
    gaps = dict(s["idle_gaps"])
    # 0-15 (mid 7.5: no operator), 20-40 (mid 30: addmm), 70-90 (mid 80: item),
    # 95-100 (mid 97.5: no operator)
    assert gaps["aten::addmm"] == pytest.approx(20e-6)
    assert gaps["aten::item"] == pytest.approx(20e-6)
    assert gaps["host outside any operator"] == pytest.approx(20e-6)
    assert s["kernels"] == 3


def test_readers_on_the_summary():
    s = summarize(EVENTS)
    s["units"] = 2
    s["op_bytes"] = {k1_roofline.OPERATOR: 1000}
    ctx = {"trace": s, "window": {}}
    assert step_device_ms.read(ctx, "x") == pytest.approx(50e-6 / 2 * 1e3)
    assert device_idle_share.read(ctx, "x") == pytest.approx(60.0)
    assert k1_roofline.read(ctx, "x") == pytest.approx(1000 / HBM_BYTES_PER_S / 5e-6 * 100)
    s["op_bytes"] = {}
    assert k1_roofline.read(ctx, "x") is None


def test_a_device_only_trace_takes_its_window_from_the_launch_calls():
    events = [e for e in EVENTS if e["cat"] not in ("user_annotation", "cpu_op")]
    s = summarize(events)
    assert s["window_s"] == pytest.approx((95 - 12) * 1e-6)  # to the copy's end
    assert s["busy_s"] == pytest.approx(40e-6)
