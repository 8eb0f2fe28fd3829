"""Tiny cells for the CPU tests: the benchmark's configurations and mixes
cut to a few pixels, samples and units, driven through the harness on the
CPU (K1 and K2 run their plain twins there)."""
from __future__ import annotations

import copy
import json
import os
import time

import torch

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PACKAGE = os.path.join(ROOT, "portbench")
TRAIN_LIMITS = {"loss1_gap": 1e-5, "grad_group_gap": 1e-5, "change_group_gap": 1e-5,
                "frozen_moved": 0, "draw_faults": 0}
SERVE_LIMITS = {"rgb_max_err": 1e-4}


def load(kind: str, name: str) -> dict:
    with open(os.path.join(PACKAGE, kind, f"{name}.json")) as f:
        return json.load(f)


def fern() -> dict:
    c = copy.deepcopy(load("configs", "fern_ours"))
    c["defaults"].update(netdepth=2, netwidth=16, multires=3, multires_views=2, chunk=64)
    c["published"].update(N_rand=64, N_samples=8, N_importance=8, grid_size=4)
    c["scene"].update(views=9, H=24, W=32, hwf=[192.0, 256.0, 208.0], match_points=60)
    return c


def truck() -> dict:
    c = copy.deepcopy(load("configs", "tat_training_Truck_ours"))
    c["published"].update(N_rand=32, cascade_samples=[8, 16], netdepth=2, netwidth=16,
                          max_freq_log2=3, max_freq_log2_viewdirs=2, chunk_size=64)
    c["defaults"].update(grid_size=4)
    c["scene"].update(train_views=4, H=20, W=36, focal=24.0)
    return c


def frames() -> dict:
    m = load("mixes", "frames_path")
    m.update(warmup_frames=1, checked_rays=100)
    return m


CELLS = {
    "calib": (fern, lambda: load("mixes", "calib_phase"), TRAIN_LIMITS,
              ["nerf_train_rays_per_s"]),
    "field": (fern, lambda: load("mixes", "field_phase"), TRAIN_LIMITS,
              ["nerf_field_train_rays_per_s"]),
    "camera": (truck, lambda: load("mixes", "camera_phase"), TRAIN_LIMITS,
               ["nerfpp_train_rays_per_s"]),
    "frames": (fern, frames, SERVE_LIMITS, ["serve_rays_per_s"]),
}


def run_cell(kind: str, tmpdir: str, seed: int = 2**31 + 11, seconds: float = 0.3) -> dict:
    """The harness's result of the tiny cell ``kind`` on the CPU."""
    config, mix, limits, e2e = CELLS[kind]
    mix = mix()
    bench = {"end_to_end": [{"name": n, "unit": "x", "workloads": [kind]} for n in e2e]
             + [{"name": "setup_s", "unit": "s"}], "per_layer": []}
    cell = {"name": kind, "config": "tiny", "traffic": mix["name"], "chips": 1}
    return harness.execute(bench, cell, config(), mix, dict(limits), seed=seed,
                           seconds=seconds, trace=False, device=torch.device("cpu"),
                           tmpdir=str(tmpdir), t0=time.perf_counter())
