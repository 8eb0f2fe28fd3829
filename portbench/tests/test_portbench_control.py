"""On the card: at each cell's own size, the program's compared numbers
keep to the cell's limits, and the control (the reference in TF32, the
precision below the configuration's float32) and, for training, the fault
of half the batch left out break at least one of them."""
from __future__ import annotations

import importlib
import json
import time

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests.tiny import ROOT

with open(f"{ROOT}/BENCHMARK.json") as f:
    CELLS = [c["name"] for c in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_breaks_a_limit_the_program_keeps(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _, _, config, mix, limits = harness.resolve(ROOT, cell)
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    run = harness.Run(config=config, mix=mix, limits=limits, seed=2**31 + 7,
                      seconds=3.0, trace=False, device=torch.device("cuda", 0),
                      tmpdir=str(tmp_path), t0=time.perf_counter())
    readings = (calibrate.serve_readings if mix["driver"].startswith("serve")
                else calibrate.train_readings)
    rows = {r["kind"]: r for r in readings(driver, run, controls=True)}
    assert all(rows["program"][k] <= v for k, v in limits.items()), rows["program"]
    for kind in rows.keys() - {"program"}:
        assert any(rows[kind].get(k, 0) > v for k, v in limits.items()), (kind, rows[kind])
