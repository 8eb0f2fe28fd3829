"""The NeRF++ serving cell (``drivers/serve_nerfpp.py``) at a tiny size on
the CPU: the port agrees with the reference, a planted altered answer is
caught, K2's bytes and K3's FLOPs are counted from shapes, the cell's files
resolve by name, and ``k3_roofline`` reads nothing where the trace has no
K3."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import serve_nerfpp
from portbench.metrics import counts, k3_roofline
from portbench.tests.tiny import ROOT, SERVE_LIMITS, load, truck

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def frames() -> dict:
    m = load("mixes", "test_frames")
    m.update(warmup_frames=1, checked_rays=100, test_views=3)
    return m


def run_tiny(tmpdir, seed: int = 2**31 + 23, seconds: float = 0.3) -> dict:
    """The harness's result of the tiny NeRF++ serving cell on the CPU."""
    mix = frames()
    bench = {"end_to_end": [{"name": "serve_rays_per_s", "unit": "rays/s",
                             "workloads": ["tiny"]}, {"name": "setup_s", "unit": "s"}],
             "per_layer": []}
    cell = {"name": "tiny", "config": "tiny", "traffic": mix["name"], "chips": 1}
    return harness.execute(bench, cell, truck(), mix, dict(SERVE_LIMITS), seed=seed,
                           seconds=seconds, trace=False, device=torch.device("cpu"),
                           tmpdir=str(tmpdir), t0=time.perf_counter())


@pytest.mark.parametrize("seed", [2**31 + 23, 3])
def test_port_agrees_with_the_reference(seed, tmp_path):
    result = run_tiny(tmp_path, seed)
    assert list(result) == KEYS
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"serve_rays_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_an_answer_altered_where_it_is_produced_is_caught(tmp_path, monkeypatch):
    from scnerf_tpu_torch import serve

    original = serve.make_nerfpp_serve_fn

    def altered(*args, **kwargs):
        fn = original(*args, **kwargs)

        def call(*rays):
            out = fn(*rays)
            out["rgb"] = out["rgb"] + 1e-3
            return out
        return call

    monkeypatch.setattr(serve, "make_nerfpp_serve_fn", altered)
    result = run_tiny(tmp_path)
    assert not result["correct"]
    assert result["checks"]["rgb_max_err"]["value"] > 5e-4


def test_rays_as_the_nerfpp_loader_makes_them():
    """``K^-1`` of the pixel centres: the principal point's ray is the
    optical axis, and one pixel to the right moves x by ``1 / focal``."""
    H, W, f = 6, 10, 5.0
    K = np.array([[f, 0, W / 2, 0], [0, f, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    dirs = serve_nerfpp.pixel_dirs(K, H, W).reshape(H, W, 3)
    assert dirs.dtype == np.float32 and np.all(dirs[..., 2] == 1)
    np.testing.assert_allclose(dirs[2, 4], [-0.5 / f, -0.5 / f, 1], atol=1e-7)
    np.testing.assert_allclose(dirs[3, 5], [0.5 / f, 0.5 / f, 1], atol=1e-7)


def truck_flags() -> dict:
    c = load("configs", "tat_training_Truck_ours")
    return {**c["published"], **c["defaults"]}


def test_k2_bytes_of_a_truck_slice():
    # fg and bg, forward only: 4,096 rays over 64 depths, 128 new samples
    assert serve_nerfpp.k2_bytes_per_slice(truck_flags()) == 2 * counts.resample_bytes(
        4096, 64, 128) == 2 * 4 * 4096 * (63 + 62 + 128 + 128)
    flags = {"cascade_samples": [5, 6, 7], "cascade_level": 3, "chunk_size": 2}
    assert serve_nerfpp.k2_bytes_per_slice(flags) == 2 * (counts.resample_bytes(2, 5, 6)
                                                          + counts.resample_bytes(2, 11, 7))


def test_k3_flops_of_a_truck_slice():
    # fg 593,408 and bg 604,160 multiply-adds a point, 192 points a net, 4,096 rays
    assert serve_nerfpp.k3_flops_per_slice(truck_flags()) == 2 * (593408 + 604160) * 192 * 4096
    # the last level's share of a ray's FLOPs: 384 of 512 points
    ray = counts.nerfpp_ray_forward_flops(truck_flags())
    assert serve_nerfpp.k3_flops_per_slice(truck_flags()) * 4 == ray * 3 * 4096


def test_the_cells_files_resolve_by_name():
    bench, cell, config, mix, limits = harness.resolve(ROOT, "truck.serve_frames")
    assert cell == {"name": "truck.serve_frames", "config": "tat_training_Truck_ours",
                    "traffic": "test_frames", "chips": 1, "why": cell["why"]}
    assert config["name"] == "tat_training_Truck_ours" and config["reduced"] == ["train_views"]
    assert mix["driver"] == "serve_nerfpp" and mix["scope"] == "nerfpp_serve"
    assert (mix["warmup_frames"], mix["traced_frames"], mix["checked_rays"],
            mix["test_views"]) == (1, 1, 65536, 24) and "test_views" in mix["assumed"]
    assert set(limits) == {"rgb_max_err"} and 0 < limits["rgb_max_err"] < 1e-2
    reported = {m["name"] for m in harness.cell_entries(bench, cell["name"], "end_to_end")}
    assert reported == {"serve_rays_per_s", "setup_s"}
    per_layer = {m["name"] for m in harness.cell_entries(bench, cell["name"], "per_layer")}
    assert per_layer == {f"{family}.nerfpp_serve" for family in (
        "mfu", "device_idle_share", "k2_roofline", "k3_roofline", "k3_point_share")}


def trace(op_device_s: dict, op_flops: dict | None = None) -> dict:
    t = {"op_device_s": op_device_s, "units": 1}
    if op_flops is not None:
        t["op_flops"] = op_flops
    return {"window": {}, "trace": t}


def test_k3_roofline_reads_the_flops_over_the_kernels_time():
    op = k3_roofline.OPERATOR
    ctx = trace({op: 2.0}, {op: 0.5 * 495e12 * 2.0})
    assert k3_roofline.read(ctx, "nerfpp_serve") == pytest.approx(50.0)


@pytest.mark.parametrize("ctx", [
    trace({"scnerf_tpu_torch::sample_pdf_fwd": 1.0}, {k3_roofline.OPERATOR: 1e12}),
    trace({"scnerf_tpu_torch::sample_pdf_fwd": 1.0}),
    trace({k3_roofline.OPERATOR: 1.0}),
    {"window": {}, "trace": None},
], ids=["no_operator", "no_operator_no_flops", "no_flops", "no_trace"])
def test_k3_roofline_reads_none_without_the_operator(ctx):
    assert k3_roofline.read(ctx, "nerfpp_serve") is None
