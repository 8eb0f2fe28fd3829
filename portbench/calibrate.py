"""The readings that a cell's correctness limits are set from, on the card.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--controls 3] [--seconds 3]

In one process, for each seed: the cell's set-up (and, for a serving cell,
a window of ``--seconds``), then the compared numbers of the program
against the reference (the lower readings; for training with each group's
median gaps and the widest gaps beside them), and, on the first
``--controls`` seeds, the same numbers of the reference computed in TF32
(the control: the nearest precision below the configuration's float32)
and, for a training cell, of the reference with half of each batch left
out and the mean taken over the rest (a fault). One JSON line a seed and
kind; nothing here is run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time

import torch

from portbench import harness, training


def half_batch(batch: dict) -> dict:
    """The fault: the first half of every per-ray entry, the rest left
    out."""
    n = batch["px"].shape[0]
    return {k: v[:n // 2] if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == n
            and k not in ("kps0", "kps1", "kp_mask") else v for k, v in batch.items()}


def train_readings(driver, run, controls: bool) -> list[dict]:
    prep = driver.prepare(run)
    program = training.program_record(prep)
    prep["calls"] = prep.pop("recorder").calls
    prep["exp"] = prep["call"] = None
    gc.collect()
    torch.cuda.empty_cache()
    reference = driver.reference_record(prep, run.device)
    draws = [training.draw_of(c["batch"]) for c in prep["calls"]]
    faults = training.draw_faults(draws, prep["flags"]["N_rand"], **prep["draw"])
    rows = [{"kind": "program", **training.readings(program, reference, reference["b1"]),
             "draw_faults": faults, **training.widest(program, reference, reference["b1"])}]
    if controls:
        for kind, other in (
                ("control_tf32", driver.reference_record(prep, run.device, tf32=True)),
                ("fault_half_batch", driver.reference_record(prep, run.device,
                                                             fault=half_batch))):
            rows.append({"kind": kind, **training.readings(other, reference, reference["b1"]),
                         **training.widest(other, reference, reference["b1"])})
    return rows


def serve_readings(driver, run, controls: bool) -> list[dict]:
    prep = driver.prepare(run)
    w = driver.window(prep, run.seconds)
    prep["window"] = w
    n_pixels = prep["H"] * prep["W"]
    prep["pixels"] = driver.checked_pixels(run.sub_seed("check"), len(w["frames"]), n_pixels,
                                           run.mix["checked_rays"])
    served = driver.served_pixels(w, prep["pixels"])
    prep["send"] = None
    w["rgbs"] = None
    gc.collect()
    torch.cuda.empty_cache()
    o, d = driver.sampled(prep, prep["pixels"])
    reference = driver.reference_rgb(prep["flags"], prep["focal"], prep["H"], prep["W"],
                                     prep["weights"], o, d, run.device)
    rows = [{"kind": "program", "frames": len(w["frames"]),
             **driver.gaps(prep, served, run.device, reference=reference)}]
    if controls:
        tf32 = driver.reference_rgb(prep["flags"], prep["focal"], prep["H"], prep["W"],
                                    prep["weights"], o, d, run.device, tf32=True)
        rows.append({"kind": "control_tf32",
                     **driver.gaps(prep, tf32, run.device, reference=reference)})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    _, _, config, mix, limits = harness.resolve(os.getcwd(), args.workload)
    import importlib

    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    readings = serve_readings if mix["driver"].startswith("serve") else train_readings
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        tmpdir = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                              f"portbench-cal-{args.workload}-{seed}")
        os.makedirs(tmpdir, exist_ok=True)
        run = harness.Run(config=config, mix=mix, limits=limits, seed=seed,
                          seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                          tmpdir=tmpdir, t0=time.perf_counter())
        for row in readings(driver, run, k < args.controls):
            print(json.dumps({"workload": args.workload, "seed": seed, **row}), flush=True)
        shutil.rmtree(tmpdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
