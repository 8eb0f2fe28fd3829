"""The curriculum ablation through the NeRF training driver.

Port of ``scripts/ablation_curriculum.py``: the reference's ablation
(SCNeRF's Tables 1-2, the curriculum ``add_ie -> add_od -> add_prd`` of
its ``demo.sh``) on the analytic scene of ``scripts/_analytic_scene.py``,
every row trained end to end by ``train/driver.py``.

Rows, all with the same injected-noise realization (same seed and flags):

- ``gt_poses``: no noise, no camera model (the oracle);
- ``noisy_no_calib``: noisy poses, no camera model (the degraded baseline);
- ``ie``: the camera, intrinsics and extrinsics learned from step 0;
- ``ie_od``: and the ray origin and direction grids from ``add_od``;
- ``ie_od_prd``: and the projected-ray-distance loss from ``add_prd`` on
  exact offline matches (the full method).

Each row reports held-out PSNR and SSIM over every test view (the learned
camera's poses ATE-aligned, the reference's ``run_nerf.py:646-660``) and
the Sim(3)-aligned camera errors. Gates: the full method beats the noisy
baseline by ``--gain_gate`` dB, and every camera row ends with a smaller
rotation error than it started with. The classical self-calibration
baselines run on the PRD row's correspondences.

    python -m scnerf_tpu_torch.scripts.ablation_curriculum [--steps 6000]
        [--out ABLATION.json] [--small] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from scnerf_tpu_torch.cli.train import device_or_exit
from scnerf_tpu_torch.core.config import experiment_from_flags
from scnerf_tpu_torch.data.blender import load_blender
from scnerf_tpu_torch.matching.provider import PrecomputedMatches
from scnerf_tpu_torch.scripts._analytic_scene import build_blender_scene
from scnerf_tpu_torch.scripts.soak_nerf import (
    NOISE,
    camera_errors,
    device_name,
    write_exact_matches,
)
from scnerf_tpu_torch.tools.calibration_baselines import (
    fundamental_from_matches,
    run_all_baselines,
)
from scnerf_tpu_torch.train import driver


def row_config(name: str, scene: str, workdir: str, flags: dict, small: bool):
    """The experiment config of one row."""
    return experiment_from_flags({
        "dataset_type": "blender", "datadir": scene, "testskip": 1,
        "N_rand": 128 if small else 1024,
        "N_samples": 8 if small else 64,
        "N_importance": 8 if small else 64,
        **({"netdepth": 2, "netwidth": 32, "multires": 4,
            "multires_views": 2} if small else {}),
        "i_print": 10 ** 9, "i_img": 10 ** 9, "i_testset": 10 ** 9,
        "i_video": 10 ** 9, "i_weights": 10 ** 9,
        "expname": name, "basedir": workdir,
        **flags,
    }, warn=lambda *a: None)


def run_row(name: str, scene: str, workdir: str, n_steps: int,
            flags: dict, small: bool, device: torch.device | str = "cuda"):
    """Train one row through the driver; its metrics and its experiment."""
    cfg = row_config(name, scene, workdir, flags, small)
    expdir = os.path.join(workdir, name)
    os.makedirs(expdir, exist_ok=True)

    if cfg.camera.ray_loss_type != "none":
        # Written before the experiment is built, which then loads them and
        # never reaches the config's matcher.
        d0 = load_blender(scene, half_res=False, testskip=1)
        H, W = d0.images.shape[1:3]
        n_pairs = write_exact_matches(os.path.join(expdir, "matches.npz"), d0.gt_poses,
                                      d0.i_split[0], d0.gt_intrinsic[0, 0], H, W)
        print(f"[ablation:{name}] exact-match cache: {n_pairs} pairs", flush=True)

    t0 = time.perf_counter()
    exp = driver.build_experiment(cfg, expdir, device=device)
    err0 = camera_errors(exp)
    exp.state, metrics = driver.train_loop(exp, n_steps, ckpt_dir=None)
    dt = time.perf_counter() - t0
    ev = driver.evaluate_test_views(exp, max_views=None)
    err1 = camera_errors(exp)
    row = {
        "name": name,
        "heldout_psnr": float(ev["psnr"]),
        "heldout_ssim": float(ev["ssim"]),
        "n_views": int(ev["n_views"]),
        "final_train_loss": float(metrics["loss"]),
        "camera_err_initial": err0,
        "camera_err_final": err1,
        "wall_s": round(dt, 1),
    }
    print(f"[ablation] {json.dumps(row)}", flush=True)
    return row, exp


def classical_baselines(matches_npz: str, K_gt, K_noisy) -> dict:
    """The paper's Table-1 classical self-calibration comparisons: the
    intrinsics estimated from the pairwise fundamental matrices of the
    correspondences the PRD loss reads, from the noisy K; each as its focal
    error relative to GT."""
    cache = PrecomputedMatches(matches_npz)
    fundamental: dict = {}
    for i, j in cache.pairs():
        m = cache.get(i, j)
        F = fundamental_from_matches(m.kps0, m.kps1)
        if F is not None:
            fundamental.setdefault(i, {})[j] = F
    x0 = [K_noisy[0, 0], K_noisy[1, 1], K_noisy[0, 2], K_noisy[1, 2]]
    est = run_all_baselines(x0, fundamental)
    f_gt = 0.5 * (K_gt[0, 0] + K_gt[1, 1])
    out = {"initial_focal_rel_err": float(abs(0.5 * (x0[0] + x0[1]) - f_gt) / f_gt)}
    for name, p in est.items():
        if p is None:
            out[name + "_focal_rel_err"] = None
            continue
        p = np.asarray(p, np.float64).reshape(-1)  # DAQ may return (5, 1)
        out[name + "_focal_rel_err"] = float(abs(0.5 * (p[0] + p[1]) - f_gt) / f_gt)
    return out


def rows_spec(n_steps: int, camera_lr_mult: float = 1.0, camera_lr_until: int = 0) -> list:
    """The five rows' names and flags, with the curriculum's thresholds
    derived from ``n_steps``: ``add_od`` a sixth of it, ``add_prd`` a
    third."""
    noise = {
        "initial_noise_size_intrinsic": NOISE["intrinsic"],
        "initial_noise_size_rotation": NOISE["rotation"],
        "initial_noise_size_translation": NOISE["translation"],
    }
    # Multiplicative intrinsics noise is the published protocol (additive
    # noise stalls the focal at its injected error). The learning-rate
    # multiplier on the calibration leaves (1.0 = the reference's) applies
    # to every camera row, so that the rows stay comparable.
    cam = {"camera_model": "pinhole_rot_noise_10k_rayo_rayd",
           "multiplicative_noise": True,
           "camera_lrate_mult": camera_lr_mult,
           "camera_lrate_mult_until": camera_lr_until, **noise}
    off = 10 ** 9  # a curriculum threshold past any horizon
    add_od = max(n_steps // 6, 1)
    add_prd = max(n_steps // 3, 2)
    return [
        ("gt_poses", {}),
        ("noisy_no_calib", noise),
        ("ie", {**cam, "add_ie": 0, "add_od": off, "add_prd": off}),
        ("ie_od", {**cam, "add_ie": 0, "add_od": add_od, "add_prd": off}),
        ("ie_od_prd", {**cam, "add_ie": 0, "add_od": add_od,
                       "add_prd": add_prd, "ray_loss_type": "proj_ray_dist",
                       "matcher": "sift", "i_ray_dist_loss": 10}),
    ]


def main(n_steps: int, out_json: str | None, workdir: str | None,
         small: bool = False, gain_gate: float = 3.0,
         camera_lr_mult: float = 1.0, camera_lr_until: int = 0,
         device: torch.device | str = "cuda") -> dict:
    device = torch.device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="ablation_")
    scene = os.path.join(workdir, "scene")
    H, W = (40, 56) if small else (120, 160)
    build_blender_scene(scene, n_train=12, n_val=2, n_test=2, H=H, W=W, device=device)

    spec = rows_spec(n_steps, camera_lr_mult, camera_lr_until)
    rows = []
    for name, flags in spec:
        row, exp = run_row(name, scene, workdir, n_steps, flags, small, device)
        rows.append(row)

    by = {r["name"]: r for r in rows}
    gain = by["ie_od_prd"]["heldout_psnr"] - by["noisy_no_calib"]["heldout_psnr"]
    cam_rows = [r for r in rows if r["camera_err_final"]]
    rot_shrinks = all(
        r["camera_err_final"]["rot_err_deg"] < r["camera_err_initial"]["rot_err_deg"]
        for r in cam_rows)

    # The Table-1 classical comparison on the PRD row's correspondences
    # (``exp`` is that row's experiment, the last).
    K_noisy = np.asarray(exp.gt_intrinsic, np.float64).copy()
    K_noisy[0, 0] = K_noisy[1, 1] = exp.noisy_focal
    classical = classical_baselines(os.path.join(workdir, "ie_od_prd", "matches.npz"),
                                    np.asarray(exp.gt_intrinsic, np.float64), K_noisy)
    classical["learned_focal_rel_err"] = by["ie_od_prd"]["camera_err_final"]["focal_rel_err"]
    curriculum = dict(spec)["ie_od_prd"]
    report = {
        "n_steps": n_steps,
        "scene": f"analytic 3-blob field, {H}x{W}, 12 train / 2 test views",
        "injected_noise": NOISE,
        "curriculum": {"add_od": curriculum["add_od"], "add_prd": curriculum["add_prd"]},
        "camera_lr_mult": camera_lr_mult,
        "camera_lr_until": camera_lr_until,
        "rows": rows,
        "classical_baselines": classical,
        "full_vs_noisy_gain_db": round(gain, 2),
        "gain_gate_db": gain_gate,
        "gain_gate_pass": bool(gain > gain_gate),
        "rot_err_shrinks_all_camera_rows": bool(rot_shrinks),
        "device": device_name(device),
    }
    print(json.dumps(report, indent=2))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m scnerf_tpu_torch.scripts.ablation_curriculum")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--gain_gate", type=float, default=3.0)
    ap.add_argument("--camera_lr_mult", type=float, default=1.0,
                    help="learning-rate multiplier on the calibration leaves of every "
                         "camera row")
    ap.add_argument("--camera_lr_until", type=int, default=0,
                    help="switch the multiplier back to 1.0 after this step")
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes (a CPU check of the ablation's mechanics)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default the card)")
    a = ap.parse_args()
    dev = device_or_exit(a.device, ap.prog)
    if dev is None:
        sys.exit(2)
    main(a.steps, a.out, a.workdir, small=a.small, gain_gate=a.gain_gate,
         camera_lr_mult=a.camera_lr_mult, camera_lr_until=a.camera_lr_until, device=dev)
