"""The reader of ``fused_point_share`` on counters written by hand, and on
the serve functions' own counters under the profiler on the CPU, where every
field query goes through the inference twins."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.metrics import fused_point_share
from scnerf_tpu_torch.train import profiling


class Recorder:
    """What the reader asks of the program's recorder: given counters."""

    def __init__(self, counters):
        self.counts = dict(counters)

    def spans(self):
        return []

    def counters(self):
        return dict(self.counts)


def ctx(counters=None, rec=True):
    return {"window": {}, "trace": {"units": 3},
            "recorder": Recorder(counters or {}) if rec else None}


@pytest.mark.parametrize("counters,want", [
    # fern: the coarse field's 64 of 192 samples a ray.
    ({"serve.field_points": 3 * 24 * 8192 * 192, "serve.field_points_k3": 3 * 24 * 8192 * 128,
      "serve.field_points_fused": 3 * 24 * 8192 * 64}, 100.0 / 3.0),
    # Truck: level 0's 64 fg and 64 bg of 512 points a ray.
    ({"serve.field_points": 131 * 4096 * 512, "serve.field_points_k3": 131 * 4096 * 384,
      "serve.field_points_fused": 131 * 4096 * 128}, 25.0),
    ({"serve.field_points": 400, "serve.field_points_fused": 400}, 100.0),
    ({"serve.field_points": 400, "serve.field_points_fused": 0}, 0.0),
])
def test_share_of_the_points(counters, want):
    assert fused_point_share.read(ctx(counters), "serve") == pytest.approx(want)


def test_none_without_the_counters(monkeypatch):
    assert fused_point_share.read(ctx(rec=False), "serve") is None
    assert fused_point_share.read(ctx({"serve.rays": 10, "serve.rays_run": 16}), "serve") is None
    # A program whose fields have no twins counts no fused points.
    assert fused_point_share.read(ctx({"serve.field_points": 400,
                                       "serve.field_points_k3": 100}), "serve") is None
    # A program whose profiling module keeps no counters.
    monkeypatch.delattr(profiling, "spans")
    assert fused_point_share.read({"window": {}, "trace": {"units": 1}}, "serve") is None


def test_every_point_from_the_serve_functions_counters_on_the_cpu():
    from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp
    from scnerf_tpu_torch.render.renderer import RenderConfig
    from scnerf_tpu_torch.serve import RenderService, make_nerf_serve_fn

    cfg = NeRFConfig(depth=2, width=16, skips=(), multires=2, multires_views=1)
    params = {"coarse": init_nerf_mlp(cfg, device="cpu"), "fine": init_nerf_mlp(cfg, device="cpu")}
    service = RenderService(make_nerf_serve_fn(params, cfg, RenderConfig(n_samples=4,
                                                                        n_importance=4)),
                            16, device="cpu")
    rays = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (20, 1))
    profiling.RECORDER.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        service(np.zeros((20, 3), np.float32), rays, np.full(20, 2.0, np.float32),
                np.full(20, 6.0, np.float32))
    try:
        assert fused_point_share.read({"window": {}, "trace": {"units": 1}}, "serve") == 100.0
        assert profiling.counters()["serve.field_points_fused"] == 2 * 16 * (4 + 8)
    finally:
        profiling.RECORDER.clear()
