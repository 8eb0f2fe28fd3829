"""Post-training calibration polish on a finished soak.

Port of ``scripts/polish_calibration.py``. Joint training leaves the
rotation error on a plateau (about 0.5 degrees on the analytic rig): once
the field has adapted to slightly wrong cameras the photometric term stops
pulling, and PRD's share of the joint gradient at weight 1e-4 is small.
This tests the two-phase remedy, one alternation, on the experiment a
``scripts/soak_nerf.py`` run left in ``--workdir`` (restored from its last
checkpoint):

- phase A, camera polish: full-batch PRD over every cached pair, Adam on
  the global calibration leaves only (``train/optim.py``'s
  ``CAMERA_POSE_LEAVES``: the intrinsics, extrinsics and distortion
  noise), the field frozen. Each pair's PRD is built as the train step
  builds it (``train/step.py``).
- phase B, field refit: the train step with the polished camera pinned
  after every update, so that the field fits the corrected rays.

Reports camera errors and held-out PSNR at the baseline, after A and
after B.

    python -m scnerf_tpu_torch.scripts.polish_calibration --workdir <soak workdir>
        [--polish_steps 3000] [--refit_steps 3000] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from scnerf_tpu_torch.camera.model import camera_leaves, get_extrinsic, get_intrinsic
from scnerf_tpu_torch.camera.rays import pixels_to_rays
from scnerf_tpu_torch.cli.train import device_or_exit
from scnerf_tpu_torch.core.config import experiment_from_flags
from scnerf_tpu_torch.losses.prd import prd_loss
from scnerf_tpu_torch.matching.provider import pad_matches
from scnerf_tpu_torch.scripts.soak_nerf import NOISE, camera_errors
from scnerf_tpu_torch.serve import fp32
from scnerf_tpu_torch.train import driver
from scnerf_tpu_torch.train.optim import CAMERA_POSE_LEAVES, Optimizer, apply_updates


def load_experiment(workdir: str, device: torch.device | str = "cuda"):
    """The soak's experiment, restored from its last checkpoint. The
    optimizer's knobs replay from the soak's ``config.json`` (a checkpoint
    restores only under the knobs it was saved with), and so do the model's
    and the sampler's sizes (a ``--small`` soak polishes too)."""
    with open(os.path.join(workdir, "soak", "config.json")) as f:
        snap = json.load(f)
    model, sampling = snap.get("model", {}), snap.get("sampling", {})
    cfg = experiment_from_flags({
        "camera_lrate_mult": snap["optim"].get("camera_lrate_mult", 1.0),
        "camera_lrate_mult_until": snap["optim"].get("camera_lrate_mult_until", 0),
        "camera_lrate_mult_hold": snap["optim"].get("camera_lrate_mult_hold", 1.0),
        "dataset_type": "blender",
        "datadir": os.path.join(workdir, "scene"), "testskip": 1,
        "N_rand": sampling.get("N_rand", 1024),
        "N_samples": sampling.get("N_samples", 64),
        "N_importance": sampling.get("N_importance", 64),
        "netdepth": model.get("netdepth", 8), "netwidth": model.get("netwidth", 256),
        "multires": model.get("multires", 10),
        "multires_views": model.get("multires_views", 4),
        "camera_model": "pinhole_rot_noise_10k_rayo_rayd",
        "multiplicative_noise": True,
        "ray_loss_type": "proj_ray_dist", "matcher": "sift",
        "i_ray_dist_loss": 10, "add_ie": 0, "add_od": 1000,
        "add_prd": 2000,
        "initial_noise_size_intrinsic": NOISE["intrinsic"],
        "initial_noise_size_rotation": NOISE["rotation"],
        "initial_noise_size_translation": NOISE["translation"],
    }, warn=lambda *a: None)
    return driver.build_experiment(cfg, os.path.join(workdir, "soak"), device=device)


def stack_all_pairs(exp, match_num: int):
    """Every cached pair, padded to ``match_num`` matches: kps ``(P, M, 2)``
    twice, the mask ``(P, M)`` and the pairs' indices ``(P, 2)``."""
    k0, k1, msk, idx = [], [], [], []
    for i, j in exp.pair_list:
        m = exp.match_cache.get(int(i), int(j))
        if m is None or m.kps0.shape[0] == 0:
            continue
        a, b, v = pad_matches(m, match_num)
        k0.append(a), k1.append(b), msk.append(v), idx.append((i, j))
    return (np.stack(k0), np.stack(k1), np.stack(msk), np.asarray(idx, np.int64))


def polish_camera(exp, steps: int, lr: float = 5e-4):
    """Phase A: full-batch PRD, Adam on the calibration leaves only.
    Returns the polished camera (a copy; the experiment's is untouched)
    and the PRD curve."""
    cam0 = exp.state.params["camera"]
    cam = dataclasses.replace(cam0, **{
        name: x.detach().clone().requires_grad_(name in CAMERA_POSE_LEAVES)
        for name, x in camera_leaves(cam0).items()})
    K0, K1, MSK, IDX = (torch.from_numpy(x).to(exp.device)
                        for x in stack_all_pairs(exp, exp.cfg.camera.match_num))
    P, M = MSK.shape
    thresh = float(exp.cfg.camera.proj_ray_dist_threshold)
    leaves = {f"camera/{name}": getattr(cam, name) for name in CAMERA_POSE_LEAVES}
    # Plain Adam: no clip, no decay, a constant rate.
    opt = Optimizer(lr, decay_steps=1.0, decay_factor=1.0, grad_clip=0.0)
    opt_state = opt.init(leaves)

    def pair_loss(k0, k1, m, r0, r1, E_pair, K):
        prd, n = prd_loss(k0, k1, r0, r1, K, E_pair, mask=m, threshold=thresh,
                          method="NeRF", mode="train")
        return torch.where(n > 0, prd, torch.zeros_like(prd))

    per_pair = torch.func.vmap(pair_loss, in_dims=(0, 0, 0, 0, 0, 0, None))

    def total_loss():
        # As the train step: each pair's poses decoded once, the rays of
        # its keypoints through them.
        E = get_extrinsic(cam, IDX)  # (P, 2, 4, 4)
        rays = [pixels_to_rays(cam, k[..., 0].reshape(-1), k[..., 1].reshape(-1),
                               c2w=E[:, side, None].expand(P, M, 4, 4).reshape(-1, 4, 4))
                for side, k in ((0, K0), (1, K1))]
        (o0, d0), (o1, d1) = ((o.reshape(P, M, 3), d.reshape(P, M, 3)) for o, d in rays)
        return per_pair(K0, K1, MSK, (o0, d0), (o1, d1), E, get_intrinsic(cam)).mean()

    hist = []
    for i in range(steps):
        with fp32():
            loss = total_loss()
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                         allow_unused=True)))
            apply_updates(leaves, opt.update(grads, opt_state, leaves))
        if i % max(steps // 10, 1) == 0:
            hist.append({"step": i, "prd": float(loss.detach())})
            print(f"[polish] {i} prd={hist[-1]['prd']:.6f}", flush=True)
    return cam, hist


def pin_camera(camera, pinned) -> None:
    """Copy ``pinned``'s leaf values into ``camera``'s leaves in place."""
    with torch.no_grad():
        for name, x in camera_leaves(camera).items():
            x.copy_(getattr(pinned, name))


def refit_field(exp, steps: int, pinned_cam):
    """Phase B: the train step, the camera pinned after every update."""
    pin_camera(exp.state.params["camera"], pinned_cam)
    for i in range(steps):
        b = driver.sample_batch(exp, 10 ** 7 + i)  # past every curriculum threshold
        exp.state, m = exp.step_fn(exp.state, b, driver.step_generator(20260818, i, exp.device))
        pin_camera(exp.state.params["camera"], pinned_cam)
        if i % max(steps // 10, 1) == 0:
            print(f"[refit] {i} loss={float(m['loss']):.6f}", flush=True)
    return exp


def snapshot(exp, tag: str) -> dict:
    ev = driver.evaluate_test_views(exp, max_views=None)
    row = {"tag": tag, "heldout_psnr": round(float(ev["psnr"]), 2),
           **{k: round(float(v), 5) for k, v in camera_errors(exp).items()}}
    print(f"[snap] {json.dumps(row)}", flush=True)
    return row


def main(workdir: str, out_json: str | None, polish_steps: int,
         refit_steps: int, device: torch.device | str = "cuda") -> dict:
    exp = load_experiment(workdir, device)
    t0 = time.perf_counter()
    rows = [snapshot(exp, "baseline")]

    cam1, hist = polish_camera(exp, polish_steps)
    pin_camera(exp.state.params["camera"], cam1)
    rows.append(snapshot(exp, "after_polish"))

    exp = refit_field(exp, refit_steps, cam1)
    rows.append(snapshot(exp, "after_refit"))

    base, pol, ref = rows
    report = {
        "workdir": workdir, "restored_step": int(exp.state.step),
        "polish_steps": polish_steps, "refit_steps": refit_steps,
        "phases": rows, "prd_curve": hist,
        "rot_improved": bool(ref["rot_err_deg"] < base["rot_err_deg"]),
        "psnr_improved": bool(ref["heldout_psnr"] > base["heldout_psnr"]),
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    print(json.dumps(report, indent=2))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m scnerf_tpu_torch.scripts.polish_calibration")
    ap.add_argument("--workdir", type=str, required=True,
                    help="the --workdir of a finished soak_nerf run")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--polish_steps", type=int, default=3000)
    ap.add_argument("--refit_steps", type=int, default=3000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default the card)")
    a = ap.parse_args()
    dev = device_or_exit(a.device, ap.prog)
    if dev is None:
        sys.exit(2)
    main(a.workdir, a.out, a.polish_steps, a.refit_steps, device=dev)
