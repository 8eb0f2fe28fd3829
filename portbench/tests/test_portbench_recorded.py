"""The readers of the program's own spans and counters (``draw_host_ms``,
``prd_host_ms``, ``serve_upload_ms``, ``serve_pad_share``) and of the
optimizer's device time by span (``optimizer_device_ms``), on records and
traces written by hand; and ``serve_pad_share`` on the service's own
counters under the profiler."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.metrics import (
    draw_host_ms,
    optimizer_device_ms,
    prd_host_ms,
    recorded,
    serve_pad_share,
    serve_upload_ms,
)
from scnerf_tpu_torch.train import profiling
from scnerf_tpu_torch.train.profiling import SpanRecord

MS = 1_000_000  # ns


class Recorder:
    """What the readers ask of the program's recorder, holding given
    records and counters."""

    def __init__(self, records=(), counters=None):
        self.records, self.counts = list(records), dict(counters or {})

    def spans(self):
        return list(self.records)

    def counters(self):
        return dict(self.counts)


def step(i: int, t0: int, parts: dict[str, float]) -> list[SpanRecord]:
    """The records of loop step ``i`` from ``t0`` ns: one span of each of
    ``parts`` (name: ms) after another, inside the step's."""
    out, t = [], t0
    for name, ms in parts.items():
        parent = "scnerf.step.forward" if name == "scnerf.step.prd" else "scnerf.loop.step"
        out.append(SpanRecord(name, parent, i, t, t + int(ms * MS)))
        t += int(ms * MS)
    return out + [SpanRecord("scnerf.loop.step", None, i, t0, t + MS)]


# Two passes of two steps each: the readers take the first (steps 10, 11).
STEPS = (step(10, 0, {"scnerf.loop.draw": 2.0, "scnerf.loop.prd_draw": 1.0,
                      "scnerf.step.prd": 2.5})
         + step(11, 10 * MS, {"scnerf.loop.draw": 4.0})
         + step(12, 20 * MS, {"scnerf.loop.draw": 90.0, "scnerf.loop.prd_draw": 90.0})
         + step(13, 200 * MS, {"scnerf.loop.draw": 90.0}))
TRACE = {"units": 2, "op_device_s": {"scnerf.step.optimizer": 0.003, "aten::mm": 1.0}}


def ctx(records=STEPS, counters=None, trace=TRACE, rec=True):
    return {"window": {}, "trace": trace,
            "recorder": Recorder(records, counters) if rec else None}


def test_host_ms_of_the_first_pass():
    assert draw_host_ms.read(ctx(), "nerf_train") == pytest.approx(3.0)
    assert prd_host_ms.read(ctx(), "nerf_train") == pytest.approx(3.5)  # step 10 alone


def test_upload_ms_a_request():
    requests = []
    for i, ms in enumerate([1.0, 2.0, 6.0, 50.0]):
        t0 = i * 100 * MS
        requests += [SpanRecord("scnerf.serve.upload", "scnerf.serve.request", i, t0,
                                t0 + int(ms * MS)),
                     SpanRecord("scnerf.serve.request", None, i, t0, t0 + 99 * MS)]
    got = serve_upload_ms.read(ctx(requests, trace={"units": 3, "op_device_s": {}}), "serve")
    assert got == pytest.approx(2.0)


def test_pad_share_of_a_frame():
    frame = {"serve.rays": 3 * 190_512, "serve.rays_run": 3 * 24 * 8_192}
    got = serve_pad_share.read(ctx(counters=frame), "serve")
    assert got == pytest.approx(6_096 / 196_608 * 100) and round(got, 2) == 3.10
    assert serve_pad_share.read(ctx(counters={}), "serve") is None


def test_optimizer_device_ms_a_step():
    assert optimizer_device_ms.read(ctx(), "nerf_train") == pytest.approx(1.5)
    assert optimizer_device_ms.read(ctx(trace={"units": 2, "op_device_s": {}}), "x") is None
    assert optimizer_device_ms.read(ctx(trace=None), "x") is None


@pytest.mark.parametrize("reader", [draw_host_ms, prd_host_ms, serve_upload_ms,
                                    serve_pad_share])
def test_none_without_a_recorder_or_its_spans(reader, monkeypatch):
    assert reader.read(ctx(rec=False), "x") is None
    assert reader.read(ctx(records=[], counters={}), "x") is None
    # A program whose profiling module keeps no spans (as before it did).
    monkeypatch.delattr(profiling, "spans")
    assert reader.read({"window": {}, "trace": TRACE}, "x") is None


def test_none_without_a_prd_step():
    plain = [r for r in STEPS if r.name not in ("scnerf.loop.prd_draw", "scnerf.step.prd")]
    assert prd_host_ms.read(ctx(plain), "nerf_train") is None
    assert draw_host_ms.read(ctx(plain), "nerf_train") == pytest.approx(3.0)


def test_pad_share_from_the_services_counters():
    from scnerf_tpu_torch.serve import RenderService

    service = RenderService(lambda o: {"rgb": o}, 64, device="cpu")
    profiling.RECORDER.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        service(np.zeros((100, 3), np.float32))
    assert recorded.recorder({}) is profiling
    got = serve_pad_share.read({"window": {}, "trace": {"units": 1}}, "serve")
    assert got == pytest.approx((1 - 100 / 128) * 100)
    assert serve_upload_ms.read({"window": {}, "trace": {"units": 1}}, "serve") > 0
