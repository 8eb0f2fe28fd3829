"""A traced segment of a run and what the per-layer metrics read from it.

:func:`traced` runs a segment twice under ``torch.profiler``. The first
time it records the device alone (kernels, copies, fills and the launch
calls), which costs the host little: the traced window (from the first
launch call to the end of the last call or device operation), the device's
busy time (the union of kernel, copy and fill intervals), the summed kernel
time and the device operations that took most time come from it. The
second time it records the host's operators too, inside a
``portbench.traced`` range that ends on a synchronise: the device time of
the kernels each operator launched (through the launch calls' correlation
ids) and the longest idle gaps, by the host operator that was running,
come from that one. Recording every operator slows the host, so its gaps
are longer than the window's.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

WINDOW_RANGE = "portbench.traced"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
TOP = 10


def _record(fn, tmpdir: str, host: bool) -> list[dict]:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_RANGE):
            fn()
            torch.cuda.synchronize()
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def traced(fn, tmpdir: str) -> dict:
    """Run ``fn()`` (one segment) under the profiler twice, the device alone
    and then with the host's operators; the numbers of both."""
    device = summarize(_record(fn, tmpdir, host=False))
    host = summarize(_record(fn, tmpdir, host=True))
    return {**device, "op_device_s": host["op_device_s"], "idle_gaps": host["idle_gaps"]}


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def _covering(host: list[dict], times: list[float]) -> list[list[str]]:
    """For each of ``times`` (ascending), the names of the host events that
    cover it, outermost first."""
    starts = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(starts) and starts[i]["ts"] <= t:
            stack.append(starts[i])
            i += 1
        stack = [e for e in stack if e["ts"] + e["dur"] >= t]
        out.append([e["name"] for e in stack])
    return out


def summarize(events: list[dict]) -> dict:
    """The numbers the per-layer metrics read from a Chrome trace's events
    (times in microseconds there, seconds here)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in spans if e["name"] == WINDOW_RANGE
              and e.get("cat") == "user_annotation"]
    calls = [e for e in spans if e.get("cat") in LAUNCH_CATEGORIES]
    if window:
        w0 = window[0]["ts"]
        w1 = w0 + window[0]["dur"]
        main_tid = window[0].get("tid")
    elif calls:
        w0 = min(e["ts"] for e in calls)
        w1 = max(e["ts"] + e["dur"] for e in spans
                 if e.get("cat") in LAUNCH_CATEGORIES + DEVICE_CATEGORIES)
        main_tid = None
    else:
        raise ValueError(f"the trace has no {WINDOW_RANGE} range and no launch call")
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    kernels = [e for e in device if e.get("cat") == "kernel"]
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device
                   if e["ts"] < w1 and e["ts"] + e["dur"] > w0])
    busy_us = sum(b - a for a, b in busy)

    # Each kernel's device time to every host operator open on the launching
    # thread when the launch call ran.
    launches = {e["args"]["correlation"]: e for e in spans
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    host_by_tid = defaultdict(list)
    for e in spans:
        if e.get("cat") in HOST_CATEGORIES:
            host_by_tid[e.get("tid")].append(e)
    launched = defaultdict(list)
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is not None:
            launched[launch.get("tid")].append((launch["ts"], k["dur"]))
    op_device_us = defaultdict(float)
    for tid, items in launched.items():
        items.sort()
        names = _covering(host_by_tid[tid], [ts for ts, _ in items])
        for (_, dur), covering in zip(items, names):
            for name in set(covering):
                op_device_us[name] += dur

    by_kernel = defaultdict(float)
    for e in device:
        by_kernel[e["name"][:120]] += e["dur"]
    device_ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]

    # Idle gaps inside the window, each named by the innermost host
    # operation running on the traced thread at its midpoint.
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in gaps]
    order = sorted(range(len(gaps)), key=lambda i: mids[i])
    covering = _covering([e for e in host_by_tid[main_tid] if e["name"] != WINDOW_RANGE],
                         [mids[i] for i in order])
    by_host = defaultdict(float)
    for i, names in zip(order, covering):
        a, b = gaps[i]
        by_host[names[-1] if names else "host outside any operator"] += b - a
    idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernel_s": sum(e["dur"] for e in device if w0 <= e["ts"] <= w1) * 1e-6,
        "op_device_s": {k: v * 1e-6 for k, v in op_device_us.items()},
        "device_ops": [[name, us * 1e-6] for name, us in device_ops],
        "idle_gaps": [[name, us * 1e-6] for name, us in idle_gaps],
        "kernels": sum(1 for k in kernels if w0 <= k["ts"] <= w1),
    }
