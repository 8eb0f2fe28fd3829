"""The harness drives tiny cells end to end on the CPU: the port agrees
with the reference, the last line has the contract's keys, and each fault a
cell can have makes ``correct`` false. A run without a card, or with a
module of JAX or of the JAX package loaded, prints no result."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import types

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import CELLS, ROOT, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_port_agrees_with_the_reference(kind, tmp_path):
    result = run_cell(kind, tmp_path)
    assert list(result) == KEYS
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == set(CELLS[kind][3]) | {"setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def frozen_step_fn(loss_fn, curriculum, optimizer, *, group=None):
    """A step that returns its state unchanged but for the counter."""
    def step(state, batch, generator=None):
        with torch.no_grad():
            _, metrics = loss_fn(state.params, batch, generator, state.step)
        return dataclasses.replace(state, step=state.step + 1), metrics
    return step


def half_batch_step_fn(original):
    """The step on the first half of every per-ray entry of the batch, the
    mean taken over that half."""
    def make(loss_fn, curriculum, optimizer, *, group=None):
        def halved(params, batch, generator, step):
            n = batch["px"].shape[0]
            batch = {k: v[:n // 2] if isinstance(v, torch.Tensor) and v.ndim
                     and v.shape[0] == n and not k.startswith(("kps", "kp_")) else v
                     for k, v in batch.items()}
            return loss_fn(params, batch, generator, step)
        return original(halved, curriculum, optimizer, group=group)
    return make


def patch_step(monkeypatch, make):
    from scnerf_tpu_torch.train import nerfpp_step, step

    monkeypatch.setattr(step, "make_step_fn", make)
    monkeypatch.setattr(nerfpp_step, "make_step_fn", make)


@pytest.mark.parametrize("kind", ["calib", "field", "camera"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(kind, tmp_path, monkeypatch):
    patch_step(monkeypatch, frozen_step_fn)
    result = run_cell(kind, tmp_path)
    assert not result["correct"]
    assert result["checks"]["change_group_gap"]["value"] > 0.5


@pytest.mark.parametrize("kind", ["calib", "field", "camera"])
def test_half_of_the_batch_left_out_is_caught(kind, tmp_path, monkeypatch):
    from scnerf_tpu_torch.train import step

    patch_step(monkeypatch, half_batch_step_fn(step.make_step_fn))
    result = run_cell(kind, tmp_path)
    assert not result["correct"]
    assert result["checks"]["loss1_gap"]["value"] > result["checks"]["loss1_gap"]["limit"]


def unmoved_camera_step_fn(original):
    """The step, with the camera's leaves put back as they were before it."""
    from scnerf_tpu_torch.train.optim import trainable_leaves

    def make(loss_fn, curriculum, optimizer, *, group=None):
        step = original(loss_fn, curriculum, optimizer, group=group)

        def call(state, batch, generator=None):
            before = {k: v.detach().clone() for k, v in trainable_leaves(state.params).items()
                      if k.startswith("camera/")}
            state, metrics = step(state, batch, generator)
            with torch.no_grad():
                for k, v in trainable_leaves(state.params).items():
                    if k in before:
                        v.copy_(before[k])
            return state, metrics
        return call
    return make


@pytest.mark.parametrize("kind", ["calib", "camera"])
def test_a_camera_left_unmoved_is_caught(kind, tmp_path, monkeypatch):
    from scnerf_tpu_torch.train import step

    patch_step(monkeypatch, unmoved_camera_step_fn(step.make_step_fn))
    result = run_cell(kind, tmp_path)
    assert not result["correct"]
    assert result["checks"]["change_group_gap"]["value"] > 0.5


def moved_camera_step_fn(original):
    """The step, with the camera's leaves nudged after it."""
    from scnerf_tpu_torch.train.optim import trainable_leaves

    def make(loss_fn, curriculum, optimizer, *, group=None):
        step = original(loss_fn, curriculum, optimizer, group=group)

        def call(state, batch, generator=None):
            state, metrics = step(state, batch, generator)
            with torch.no_grad():
                for k, v in trainable_leaves(state.params).items():
                    if k.startswith("camera/"):
                        v.add_(1e-6)
            return state, metrics
        return call
    return make


def test_a_masked_camera_that_moves_is_caught(tmp_path, monkeypatch):
    from scnerf_tpu_torch.train import step

    patch_step(monkeypatch, moved_camera_step_fn(step.make_step_fn))
    result = run_cell("field", tmp_path)
    assert not result["correct"]
    assert result["checks"]["frozen_moved"]["value"] > 0


def patch_draw(monkeypatch, kind: str, change):
    """Makes the program's own draw hand the step ``change(batch)``: the
    NeRF loop's ``sample_batch`` or the NeRF++ loop's ``_host_batch``."""
    from scnerf_tpu_torch.train import driver, nerfpp_driver

    if kind == "camera":
        original = nerfpp_driver._host_batch
        monkeypatch.setattr(nerfpp_driver, "_host_batch", lambda exp: change(original(exp)))
    else:
        original = driver.sample_batch
        monkeypatch.setattr(driver, "sample_batch",
                            lambda exp, step: change(original(exp, step)))


def half_draw(arrays: dict) -> dict:
    """The first half of every per-ray array of a drawn batch."""
    n = len(arrays["px"])
    return {k: v[:n // 2] if getattr(v, "ndim", 0) and len(v) == n else v
            for k, v in arrays.items()}


def strip_draw(arrays: dict) -> dict:
    """The drawn pixels moved into a strip four pixels wide."""
    return {**arrays, "px": arrays["px"] % 4}


@pytest.mark.parametrize("kind", ["calib", "field", "camera"])
def test_a_draw_of_half_a_batch_is_caught(kind, tmp_path, monkeypatch):
    patch_draw(monkeypatch, kind, half_draw)
    result = run_cell(kind, tmp_path)
    assert not result["correct"]
    assert result["checks"]["draw_faults"]["value"] > 0


@pytest.mark.parametrize("kind", ["calib", "camera"])
def test_a_draw_inside_one_region_is_caught(kind, tmp_path, monkeypatch):
    patch_draw(monkeypatch, kind, strip_draw)
    result = run_cell(kind, tmp_path)
    assert not result["correct"]
    assert result["checks"]["draw_faults"]["value"] > 0


def test_an_answer_altered_where_it_is_produced_is_caught(tmp_path, monkeypatch):
    from scnerf_tpu_torch import serve

    original = serve.make_nerf_serve_fn

    def altered(*args, **kwargs):
        fn = original(*args, **kwargs)

        def call(*rays):
            out = fn(*rays)
            out["rgb"] = out["rgb"] + 1e-3
            return out
        return call

    monkeypatch.setattr(serve, "make_nerf_serve_fn", altered)
    result = run_cell("frames", tmp_path)
    assert not result["correct"]
    assert result["checks"]["rgb_max_err"]["value"] > 5e-4


def test_a_loaded_jax_module_refuses_the_result(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        run_cell("frames", tmp_path)
    assert e.value.code != 0


def test_names_are_compared_whole(monkeypatch):
    for name in ("scnerf_tpu_torch_x", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not any(m.split(".")[0] in ("scnerf_tpu_torch_x", "jaxtyping", "flaxen")
                   for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "scnerf_tpu.core", types.ModuleType("scnerf_tpu.core"))
    assert "scnerf_tpu.core" in harness.forbidden_modules()


def test_importing_the_benchmark_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "import scnerf_tpu_torch.train.driver, scnerf_tpu_torch.train.nerfpp_driver\n"
        "import scnerf_tpu_torch.serve\n"
        "from portbench.harness import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "fern.calib",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == "" or not out.stdout.strip().splitlines()[-1].startswith("{")
