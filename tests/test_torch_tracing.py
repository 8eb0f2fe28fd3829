"""The port's spans and counters (``train/profiling.py``): recorded only
under ``torch.profiler``, with their parents and step or request numbers,
in the NeRF and NeRF++ training loops (a tiny fern and Truck config on
seeded scenes, PRD every second step on seeded matches) and in
``RenderService``; shown as ``user_annotation`` ranges in the Chrome trace;
and ``StepTimer`` across one-step calls of the loop. CPU only, no JAX."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_support import hang_watchdog  # noqa: F401
from _torch_support import write_llff_scene, write_nerfpp_scene
from scnerf_tpu_torch.core.config import load_experiment
from scnerf_tpu_torch.matching.provider import PairMatches, PrecomputedMatches
from scnerf_tpu_torch.serve import RenderService
from scnerf_tpu_torch.train import driver, nerfpp_driver, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "nerf": (os.path.join(REPO, "configs", "llff", "fern_ours.txt"),
             {"netdepth": 2, "netwidth": 16, "multires": 2, "multires_views": 2,
              "N_samples": 4, "N_importance": 4, "llffhold": 4}),
    "nerfpp": (os.path.join(REPO, "configs", "tanks_and_temples",
                            "tat_training_Truck_ours.txt"),
               {"scene": "", "netdepth": 2, "netwidth": 16, "max_freq_log2": 2,
                "max_freq_log2_viewdirs": 2, "cascade_samples": [4, 4],
                "ray_loss_type": "proj_ray_dist"}),
}
COMMON = {"N_rand": 32, "match_num": 16, "add_ie": 0, "add_od": 0, "add_prd": 0,
          "i_ray_dist_loss": 2, "matcher": "precomputed", "i_print": 2}
STEP = "scnerf.loop.step"
DRAW, PRD_DRAW, TO_DEVICE = "scnerf.loop.draw", "scnerf.loop.prd_draw", "scnerf.loop.to_device"
# (span, parent) of a loop's steps: every step's; a PRD step's besides; step
# 1's besides (no PRD; NeRF logs after it).
STEPS = {(STEP, None), (DRAW, STEP), ("scnerf.step.forward", STEP),
         ("scnerf.step.backward", STEP), ("scnerf.step.optimizer", STEP)}
LOOPS = {
    "nerf": (STEPS | {(TO_DEVICE, DRAW)},
             {(PRD_DRAW, STEP), (TO_DEVICE, PRD_DRAW), ("scnerf.step.prd", "scnerf.step.forward")},
             {("scnerf.loop.log", STEP)}),
    "nerfpp": (STEPS | {("scnerf.loop.log", STEP),
                        ("scnerf.kernels.sample_pdf_diff_backward", "scnerf.step.backward")},
               {(PRD_DRAW, STEP), (TO_DEVICE, PRD_DRAW)},
               {(TO_DEVICE, DRAW)}),
}
SERVE = {("scnerf.serve.request", None), ("scnerf.serve.upload", "scnerf.serve.request"),
         ("scnerf.serve.slices", "scnerf.serve.request"),
         ("scnerf.serve.readback", "scnerf.serve.request")}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    rng = np.random.RandomState(3)
    matches = PrecomputedMatches()
    for i in range(4):
        for j in range(i + 1, 4):
            matches.put(i, j, PairMatches(*rng.uniform(1, 15, (2, 12, 2)).astype(np.float32)))
    matches.save(str(root / "matches.npz"))
    write_nerfpp_scene(root / "nerfpp", splits=(("train", 4),), H=16, W=16)
    return {"nerf": write_llff_scene(root / "nerf", n_views=5, seed=5),
            "nerfpp": str(root / "nerfpp"), "matches": str(root / "matches.npz"),
            "root": root}


def experiment(scenes, kind: str, name: str):
    """A fresh experiment of ``kind`` on the CPU, in its own directory."""
    path, flags = CONFIGS[kind]
    expdir = scenes["root"] / name
    expdir.mkdir()
    (expdir / "matches.npz").write_bytes(open(scenes["matches"], "rb").read())
    cfg = load_experiment(path, {**flags, **COMMON, "datadir": scenes[kind]},
                          warn=lambda *_: None)
    if kind == "nerf":
        return driver.build_experiment(cfg, str(expdir), device="cpu")
    return nerfpp_driver.build_nerfpp_experiment(cfg, str(expdir), device="cpu")


def run(scenes, kind: str, name: str, n_steps: int = 3):
    """``n_steps`` steps of ``kind`` from step 0 (PRD at the even steps), or
    for ``"serve"`` a 100-ray request at batch 64 and a 64-ray one; the
    service's answer, or ``None``."""
    if kind == "serve":
        service = RenderService(lambda o, d: {"rgb": o * 2.0 + d}, 64, device="cpu")
        rays = np.arange(300, dtype=np.float32).reshape(100, 3)
        out = service(rays, rays)
        service(rays[:64], rays[:64])
        return out
    exp = experiment(scenes, kind, name)
    if kind == "nerf":
        driver.train_loop(exp, n_steps)
    else:
        nerfpp_driver.run_nerfpp_training(exp.cfg, str(scenes["root"] / name), n_steps,
                                          exp=exp, device="cpu")
    return None


@pytest.mark.parametrize("kind", ["nerf", "nerfpp", "serve"])
def test_nothing_recorded_without_a_profiler(scenes, kind):
    profiling.RECORDER.clear()
    run(scenes, kind, f"off_{kind}", n_steps=2)
    assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.span("scnerf.x.y") is profiling.span("scnerf.x.z")  # the shared no-op


@pytest.mark.parametrize("kind", ["nerf", "nerfpp", "serve"])
def test_spans_under_the_profiler(scenes, tmp_path, kind):
    profiling.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run(scenes, kind, f"on_{kind}")
    records = profiling.spans()
    by_id = {}
    for r in records:
        by_id.setdefault(r.id, set()).add((r.name, r.parent))
        assert r.start_ns <= r.end_ns
    if kind == "serve":
        np.testing.assert_array_equal(out["rgb"], np.arange(300.0).reshape(100, 3) * 3.0)
        assert by_id == {0: SERVE, 1: SERVE}
        assert profiling.counters() == {"serve.rays": 164, "serve.rays_run": 192}
    else:
        every, prd, step1 = LOOPS[kind]
        assert by_id == {0: every | prd, 1: every | step1, 2: every | prd}
        assert profiling.counters() == {}
    # Each span lies inside its parent, the one of its number that encloses it.
    for r in records:
        if r.parent is not None:
            assert any(p.name == r.parent and p.id == r.id and p.start_ns <= r.start_ns
                       and r.end_ns <= p.end_ns for p in records), r
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {name for name, _ in set().union(*by_id.values())} <= ranges


def test_step_timer_across_one_step_calls(scenes):
    exp = experiment(scenes, "nerf", "timer")
    for n in range(1, 5):
        driver.train_loop(exp, n)
    summary = exp.timer.summary()
    assert summary["steps"] == 2 and 0 < summary["p50_ms"] <= summary["max_ms"]
    with open(os.path.join(exp.logger.expdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    # Logged at steps 2 and 4: after the 2-step warm-up, the iterations
    # before the log's own.
    assert [(r["step"], r["steps"]) for r in rows if "steps" in r] == [(2, 0), (4, 1)]
    assert torch.isfinite(torch.tensor(rows[-1]["p50_ms"]))
