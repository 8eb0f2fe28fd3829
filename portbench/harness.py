"""The benchmark's run: one cell, one seed, one process.

``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` from the root of a checkout. The cell's entry in ``BENCHMARK.json``
names its configuration (``portbench/configs/<config>.json``) and its
traffic mix (``portbench/mixes/<traffic>.json``); the mix names the driver
(``portbench/drivers/<driver>.py``) that builds the port's experiment or
serve function, warms it up, drives the measured window and checks what the
window produced against the plain reference, with the limits of
``portbench/limits/<cell>.json``. Each per-layer metric ``<family>.<scope>``
is read by ``portbench/metrics/<family>.py``. Nothing here names a cell,
a configuration or a metric: a new one is new files and entries.

The run refuses to start without the cards the cell asks for, and refuses
to print a result when a module of JAX or of the JAX package is loaded
after the window.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Any

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "scnerf_tpu")


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell's files, the run's arguments and a
    private directory, and where it reports its set-up's end."""

    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    tmpdir: str
    t0: float
    setup_s: float | None = None

    def sub_seed(self, tag: str) -> int:
        """A 31-bit seed for ``tag``, drawn from the run's seed (of any
        size)."""
        words = [int(b) for b in tag.encode()]
        state = np.random.SeedSequence([self.seed % 2**63, *words]).generate_state(1)
        return int(state[0]) & 0x7FFFFFFF

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t0


def flags_of(config: dict) -> dict:
    """A configuration's flags as the port takes them: the published keys
    and the reference trainer's defaults for the rest."""
    return {**config["published"], **config["defaults"]}


def device_info(device, peak: int) -> dict:
    """The result's ``device`` entry for one card (or the CPU, in tests)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}


def host_usage() -> dict:
    """This process's CPU seconds and context switches, now."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": r.ru_utime + r.ru_stime, "nvcsw": r.ru_nvcsw, "nivcsw": r.ru_nivcsw}


def host_report(before: dict, after: dict, seconds: float) -> str:
    """What this process's host side did between two :func:`host_usage`
    readings: its share of one core and its context switches (a process
    that keeps ahead of the card waits for it, and switches)."""
    d = {k: after[k] - before[k] for k in before}
    return (f"host: process {d['cpu_s'] / seconds:.1%} of a core, {d['nvcsw']} voluntary and "
            f"{d['nivcsw']} involuntary context switches")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_TOP_LEVEL)


def cell_entries(bench: dict, cell_name: str, key: str) -> list[dict]:
    """The metrics of ``bench[key]`` that cell ``cell_name`` reports: those
    that list it under ``workloads``, or list no cells and move (or are) an
    end-to-end metric that the cell reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports_e2e(name: str) -> bool:
        m = e2e[name]
        return "workloads" not in m or cell_name in m["workloads"]

    out = []
    for m in bench[key]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif key == "end_to_end" or reports_e2e(m["moves"]):
            out.append(m)
    return out


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(root: str, cell_name: str) -> tuple[dict, dict, dict, dict, dict]:
    """``(bench, cell, config, mix, limits)`` of ``cell_name``, found by the
    names in ``BENCHMARK.json`` under ``root``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"portbench: no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, config_entry["file"]))
    mix = load_json(os.path.join(PACKAGE_DIR, "mixes", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(PACKAGE_DIR, "limits", f"{cell_name}.json"))
    return bench, cell, config, mix, limits


def card_line() -> str:
    """The first card's name, power limit and clocks, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "clocks.mem,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def read_per_layer(entries: list[dict], ctx: dict) -> dict:
    """Each per-layer metric that its reader finds something to read."""
    out = {}
    for m in entries:
        family, _, scope = m["name"].partition(".")
        reader = importlib.import_module(f"portbench.metrics.{family}")
        value = reader.read(ctx, scope)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(bench: dict, cell: dict, config: dict, mix: dict, limits: dict, *, seed: int,
            seconds: float, trace: bool, device, tmpdir: str, t0: float) -> dict:
    """Run the cell and return its result (the last line's object), or
    raise ``SystemExit`` when a forbidden module is loaded."""
    run = Run(config=config, mix=mix, limits=limits, seed=seed, seconds=seconds,
              trace=trace, device=device, tmpdir=tmpdir, t0=t0)
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    outcome = driver.run(run)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        raise SystemExit(3)
    if trace:
        ctx = {"window": outcome["window"], "trace": outcome["trace"]}
        metrics = read_per_layer(cell_entries(bench, cell["name"], "per_layer"), ctx)
    else:
        metrics = {}
        for m in cell_entries(bench, cell["name"], "end_to_end"):
            value = run.setup_s if m["name"] == "setup_s" else outcome["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = outcome["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    info = dict(outcome["device"])
    if trace and outcome["trace"] is not None:
        info["busy_s"] = outcome["trace"]["busy_s"]
        info["window_s"] = outcome["trace"]["window_s"]
    result = {"correct": correct, "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics, "device": info}
    if trace and outcome["trace"] is not None:
        result["breakdown"] = {k: outcome["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = checks
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m portbench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    root = os.getcwd()
    bench, cell, config, mix, limits = resolve(root, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    # Every build and kernel cache inside the checkout, at fixed paths.
    cache = os.path.join(root, "build", "portbench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    tmpdir = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"portbench-{os.getpid()}")
    os.makedirs(tmpdir, exist_ok=True)
    print(f"portbench: {args.workload} seed {args.seed} seconds {args.seconds} trace "
          f"{args.trace}; card: {card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; host threads: torch {torch.get_num_threads()}, "
          f"OMP_NUM_THREADS {os.environ.get('OMP_NUM_THREADS', 'unset')}, "
          f"{os.cpu_count()} CPUs", flush=True)
    try:
        result = execute(bench, cell, config, mix, limits, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         device=torch.device("cuda", 0), tmpdir=tmpdir, t0=t0)
    finally:
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)
    print(f"portbench: card after the run: {card_line()}", flush=True)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
