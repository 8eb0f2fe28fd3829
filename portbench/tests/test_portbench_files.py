"""Every cell of ``BENCHMARK.json`` resolves its files by name, and the file
keeps to the benchmark's contract on names, units and keys."""
from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from portbench import harness
from portbench.tests.tiny import PACKAGE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == TOP_KEYS
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(isinstance(w, str) and "\t" not in w for w in b["command"])


@pytest.mark.parametrize("cell", [c["name"] for c in bench()["workloads"]])
def test_cell_resolves_its_files(cell):
    b, entry, config, mix, limits = harness.resolve(ROOT, cell)
    assert entry["chips"] == 1
    assert config["name"] == entry["config"]
    assert os.path.exists(os.path.join(PACKAGE, "drivers", f"{mix['driver']}.py"))
    importlib.import_module(f"portbench.drivers.{mix['driver']}")
    exact = ("draw_faults", "frozen_moved")
    assert limits and all(v > 0 for k, v in limits.items() if k not in exact)
    assert all(limits.get(k, 0) == 0 for k in exact)
    reported = harness.cell_entries(b, cell, "end_to_end")
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.cell_entries(b, cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names
        family = m["name"].split(".")[0]
        assert hasattr(importlib.import_module(f"portbench.metrics.{family}"), "read")


def test_names_units_and_entries():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    configs = {c["name"] for c in b["configs"]}
    assert configs == {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(len(w["why"]) <= 200 for w in b["workloads"])
