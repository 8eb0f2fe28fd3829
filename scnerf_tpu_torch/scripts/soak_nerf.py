"""Long-run quality soak of the NeRF driver.

Port of ``scripts/soak_nerf.py``. Drives the published default path end to
end (batching on with the camera model: a shuffled pixel pool, per-ray
image indices through the learnable camera; injected camera noise; PRD on
exact offline matches one step in ten; the curriculum; checkpoints) on the
analytic scene of ``scripts/_analytic_scene.py``, which is a consistent 3D
scene, so the run measures quality:

- held-out PSNR over the test views every ``--eval_every`` steps, as a
  curve, gated at ``--psnr_gate`` (default 25 dB);
- the camera's calibration errors (rotation in degrees, translation, focal
  relative) against the injected noise, gated on shrinking from their
  initial values.

The PRD loss reads exact correspondences (blob points projected through
the GT cameras), written as the offline ``matches.npz`` that
``train/driver.py:build_experiment`` loads before any matcher.

    python -m scnerf_tpu_torch.scripts.soak_nerf [--steps 10000] [--out SOAK.json]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from scnerf_tpu_torch.camera.model import (
    get_extrinsic,
    get_extrinsics,
    get_intrinsic,
    host_camera,
)
from scnerf_tpu_torch.cli.train import device_or_exit
from scnerf_tpu_torch.core.config import experiment_from_flags
from scnerf_tpu_torch.data.blender import load_blender
from scnerf_tpu_torch.geometry.alignment import align_c2w_trajectories, apply_sim3
from scnerf_tpu_torch.losses.photometric import img2mse, mse2psnr
from scnerf_tpu_torch.matching.provider import PairMatches, PrecomputedMatches
from scnerf_tpu_torch.scripts._analytic_scene import _CENTERS, _WIDTHS, build_blender_scene
from scnerf_tpu_torch.train import driver

NOISE = dict(intrinsic=0.05, rotation=2.0, translation=0.05)
MARGINAL_STEPS = 500  # plain steps after the run, timed on a warm process


def write_exact_matches(path: str, gt_poses, i_train, focal: float,
                        H: int, W: int, n_pts: int = 600,
                        min_matches: int = 16) -> int:
    """Exact correspondences: 3D points drawn on the analytic blobs,
    projected through the GT cameras (OpenGL), stored per train pair in the
    ``.npz`` match-cache format. Returns the number of pairs written."""
    rng = np.random.RandomState(7)
    pts = np.concatenate([
        c + rng.randn(n_pts // len(_CENTERS), 3) * np.sqrt(w / 2.0)
        for c, w in zip(_CENTERS, _WIDTHS)
    ])

    def project(E):
        cam = (pts - E[:3, 3]) @ E[:3, :3]
        zc = -cam[:, 2]
        u = W / 2.0 + focal * cam[:, 0] / np.maximum(zc, 1e-6)
        v = H / 2.0 - focal * cam[:, 1] / np.maximum(zc, 1e-6)
        ok = (zc > 0.5) & (u >= 1) & (u < W - 1) & (v >= 1) & (v < H - 1)
        return np.stack([u, v], -1).astype(np.float32), ok

    cache = PrecomputedMatches()
    n_pairs = 0
    for a in range(len(i_train)):
        for b in range(a + 1, len(i_train)):
            pa, oka = project(gt_poses[i_train[a]])
            pb, okb = project(gt_poses[i_train[b]])
            ok = oka & okb
            if ok.sum() >= min_matches:
                cache.put(a, b, PairMatches(pa[ok], pb[ok]))
                n_pairs += 1
    cache.save(path)
    return n_pairs


def camera_errors(exp) -> dict:
    """Calibration error of the learned camera against GT after a Sim(3)
    alignment (the ATE protocol of ``geometry/alignment.py``).

    Computed on the host: the camera's leaves are copied to the CPU and
    decoded there in float32, as the JAX package decodes them, and the
    alignment and the errors are taken in float64. So the same camera gives
    the same errors on every device. (The JAX script aligns in float32,
    where two SVD implementations part by about 1e-6 of the translation
    error.) The rotation error is de-scaled by ``det^(1/3)`` and taken in
    the small-angle-stable form ``2 asin(||Ra - Rb||_F / (2 sqrt 2))``
    (exact for rotations; the arccos of the trace floors near 0.02 degrees
    in float32)."""
    cam = exp.state.params.get("camera")
    if cam is None:
        return {}
    cam = host_camera(cam)
    with torch.no_grad():
        learned = get_extrinsics(cam).double()
        K = get_intrinsic(cam).numpy()
    gt = torch.as_tensor(np.asarray(exp.gt_poses[exp.i_train], np.float32), dtype=torch.float64)
    _, (s, R, t) = align_c2w_trajectories(gt, learned)
    aligned = apply_sim3(gt, s, R, t).numpy()
    learned = learned.numpy()
    Ra = aligned[:, :3, :3]
    Ra = Ra / np.cbrt(np.linalg.det(Ra))[:, None, None]
    fro = np.linalg.norm((Ra - learned[:, :3, :3]).reshape(-1, 9), axis=-1)
    rot_deg = np.degrees(2.0 * np.arcsin(np.clip(fro / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))
    trans = np.linalg.norm(aligned[:, :3, 3] - learned[:, :3, 3], axis=-1)
    f_gt = float(exp.gt_intrinsic[0, 0])
    return {
        "rot_err_deg": float(rot_deg.mean()),
        "trans_err": float(trans.mean()),
        "focal_rel_err": float(abs(K[0, 0] - f_gt) / f_gt),
    }


def eval_protocol_ab(exp) -> dict:
    """Held-out PSNR over all test views under a ladder of evaluation
    protocols, from the production one down to the oracle camera; the
    differences between rungs say where quality is lost:

    - ``ate_full_camera``: the ATE-carried pose, the learned K and noise
      grids (``evaluate_test_views``'s path);
    - ``ate_no_grid``: the same with the grids zeroed (the trained ray
      noise);
    - ``gt_pose_full``: the GT pose, the learned K and grids (the Sim(3)
      transport's residual);
    - ``gt_pose_gt_focal``: the GT pose through GT-focal pinhole rays (how
      well the learned field renders with a perfect camera);
    - ``train_view``: the first train view through its learned extrinsics
      (the trajectory the field was fitted to).
    """
    cam = exp.state.params.get("camera")
    if cam is None:
        return {}
    no_grid = dataclasses.replace(cam, ray_o_grid=torch.zeros_like(cam.ray_o_grid),
                                  ray_d_grid=torch.zeros_like(cam.ray_d_grid))

    def mean_psnr(view_ids, pose_fn, camera=cam, camera_rays=True, focal=None):
        saved_cam, saved_focal = exp.state.params.get("camera"), exp.noisy_focal
        try:
            exp.state.params["camera"] = camera
            if focal is not None:
                exp.noisy_focal = float(focal)
            ps = []
            for i in view_ids:
                out = driver.render_image(exp, pose_fn(int(i)), camera_rays=camera_rays)
                mse = img2mse(torch.from_numpy(out["rgb"]), torch.from_numpy(exp.images[int(i)]))
                ps.append(float(mse2psnr(mse)))
            return round(float(np.mean(ps)), 2)
        finally:
            exp.state.params["camera"] = saved_cam
            exp.noisy_focal = saved_focal

    def train_pose(i):
        with torch.no_grad():
            return get_extrinsic(cam, int(np.where(exp.i_train == i)[0][0]))

    ate = lambda i: driver.aligned_eval_extrinsic(exp, i)  # noqa: E731
    gt = lambda i: exp.gt_poses[i]  # noqa: E731
    out = {
        "ate_full_camera": mean_psnr(exp.i_test, ate),
        "ate_no_grid": mean_psnr(exp.i_test, ate, camera=no_grid),
        "gt_pose_full": mean_psnr(exp.i_test, gt),
        "gt_pose_gt_focal": mean_psnr(exp.i_test, gt, camera_rays=False,
                                      focal=exp.gt_intrinsic[0, 0]),
        "train_view": mean_psnr(exp.i_train[:1], train_pose),
    }
    print(f"[soak] eval-protocol A/B: {json.dumps(out)}", flush=True)
    return out


def soak_flags(scene: str, workdir: str, n_steps: int, small: bool = False,
               eval_every: int = 1000, prd_weight: float = 1e-4, prd_cadence: int = 10,
               camera_lr_mult: float = 1.0, camera_lr_until: int = 0,
               camera_lr_hold: float = 1.0, add_prd: int = 2000) -> dict:
    """The soak's experiment flags: the scene in ``scene``, the experiment
    in ``workdir/soak``."""
    return {
        "dataset_type": "blender", "datadir": scene, "testskip": 1,
        "N_rand": 128 if small else 1024,
        "N_samples": 8 if small else 64,
        "N_importance": 8 if small else 64,
        **({"netdepth": 2, "netwidth": 32, "multires": 4,
            "multires_views": 2} if small else {}),
        "camera_model": "pinhole_rot_noise_10k_rayo_rayd",
        # The published protocol learns multiplicative intrinsics noise:
        # with additive noise Adam's step is about lr in pixels, too small
        # to cross the shallow dolly-zoom valley of an orbit in 20k steps.
        "multiplicative_noise": True,
        "ray_loss_type": "proj_ray_dist", "matcher": "sift",
        "i_ray_dist_loss": prd_cadence, "add_ie": 0, "add_od": 1000,
        "add_prd": add_prd,
        "ray_dist_loss_weight": prd_weight,
        "camera_lrate_mult": camera_lr_mult,
        "camera_lrate_mult_until": camera_lr_until,
        "camera_lrate_mult_hold": camera_lr_hold,
        "initial_noise_size_intrinsic": NOISE["intrinsic"],
        "initial_noise_size_rotation": NOISE["rotation"],
        "initial_noise_size_translation": NOISE["translation"],
        "i_print": 1000, "i_img": 10 ** 9, "i_testset": 10 ** 9,
        # A checkpoint at the eval cadence: a rerun with the same --workdir
        # resumes from the last eval boundary, and polish_calibration reads it.
        "i_video": 10 ** 9, "i_weights": min(max(n_steps // 2, 1), eval_every),
        "expname": "soak", "basedir": workdir,
    }


def main(n_steps: int, out_json: str | None, workdir: str | None,
         small: bool = False, eval_every: int = 1000,
         psnr_gate: float = 25.0, prd_weight: float = 1e-4,
         prd_cadence: int = 10, camera_lr_mult: float = 1.0,
         camera_lr_until: int = 0, camera_lr_hold: float = 1.0,
         add_prd: int = 2000, focal_gate: float | None = None,
         rot_gate: float | None = None, device: torch.device | str = "cuda") -> dict:
    device = torch.device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="soak_nerf_")
    scene = os.path.join(workdir, "scene")
    H, W = (40, 56) if small else (120, 160)
    build_blender_scene(scene, n_train=12, n_val=2, n_test=2, H=H, W=W, device=device)
    cfg = experiment_from_flags(
        soak_flags(scene, workdir, n_steps, small=small, eval_every=eval_every,
                   prd_weight=prd_weight, prd_cadence=prd_cadence,
                   camera_lr_mult=camera_lr_mult, camera_lr_until=camera_lr_until,
                   camera_lr_hold=camera_lr_hold, add_prd=add_prd),
        warn=lambda *a: None)
    expdir = os.path.join(workdir, "soak")
    os.makedirs(expdir, exist_ok=True)

    # Exact offline matches, which build_experiment loads before any matcher.
    d0 = load_blender(scene, half_res=False, testskip=1)
    n_pairs = write_exact_matches(os.path.join(expdir, "matches.npz"), d0.gt_poses,
                                  d0.i_split[0], d0.gt_intrinsic[0, 0], H, W)
    print(f"[soak] exact-match cache: {n_pairs} train pairs", flush=True)

    t0 = time.perf_counter()
    exp = driver.build_experiment(cfg, expdir, device=device)
    assert exp.pixel_pool is not None, "expected the batching+camera pool"
    assert exp.match_cache is not None and len(exp.match_cache.pairs()) > 0, \
        "PRD match cache empty: the PRD path would be vacuous"

    curve = []

    def snapshot(step):
        ev = driver.evaluate_test_views(exp, max_views=2)
        row = {"step": int(step),
               **{k: float(v) for k, v in ev.items() if isinstance(v, (int, float, np.floating))},
               **camera_errors(exp)}
        curve.append(row)
        print(f"[soak] {json.dumps(row)}", flush=True)

    snapshot(0)
    ckpt_dir = os.path.join(expdir, "ckpts")
    for seg_end in range(eval_every, n_steps + 1, eval_every):
        exp.state, metrics = driver.train_loop(exp, seg_end, ckpt_dir=ckpt_dir)
        snapshot(seg_end)
    if n_steps % eval_every:
        exp.state, metrics = driver.train_loop(exp, n_steps, ckpt_dir=ckpt_dir)
        snapshot(n_steps)
    total_dt = time.perf_counter() - t0

    # The marginal rate: steps past the curriculum on a warm process.
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t1 = time.perf_counter()
    extra = MARGINAL_STEPS
    for it in range(extra):
        b = driver.sample_batch(exp, n_steps + it)
        exp.state, m = exp.step_fn(exp.state, b, driver.step_generator(122, it, device))
    sync()
    marginal_dt = time.perf_counter() - t1
    final_metrics = {k: float(v) for k, v in m.items()}

    ev = driver.evaluate_test_views(exp, max_views=None)  # every test view
    cam_err = camera_errors(exp)
    protocol_ab = eval_protocol_ab(exp)
    initial = {k: curve[0][k] for k in ("rot_err_deg", "trans_err", "focal_rel_err")
               if k in curve[0]}
    quality = {
        "heldout_psnr_final": float(ev["psnr"]),
        "heldout_n_views": int(ev["n_views"]),
        "psnr_gate_db": psnr_gate,
        "psnr_gate_pass": bool(ev["psnr"] > psnr_gate),
        "camera_err_initial": initial,
        "camera_err_final": cam_err,
        "camera_gate_pass": bool(
            cam_err.get("rot_err_deg", 0.0) < curve[0].get("rot_err_deg", np.inf)
            and cam_err.get("trans_err", 0.0) < curve[0].get("trans_err", np.inf)
            # The focal must shrink too.
            and cam_err.get("focal_rel_err", 0.0) < 0.9 * curve[0].get("focal_rel_err", np.inf)
        ),
    }
    # Absolute gates, opt-in.
    if focal_gate is not None:
        quality["focal_gate"] = focal_gate
        quality["focal_gate_pass"] = bool(cam_err.get("focal_rel_err", np.inf) < focal_gate)
    if rot_gate is not None:
        quality["rot_gate_deg"] = rot_gate
        quality["rot_gate_pass"] = bool(cam_err.get("rot_err_deg", np.inf) < rot_gate)
        quality["rot_gate_basis"] = (
            "identifiability floor ~0.5 deg for the 66-pair/600-point 12-view rig; "
            "gate = floor + 0.1 deg margin")
    report = {
        "n_steps": n_steps + extra,
        "n_rand": cfg.sampling.N_rand,
        "scene": "analytic 3-blob field (consistent 3D), black background",
        "injected_noise": NOISE,
        "sampling_path": "pixel_pool (batching+camera, the published default)",
        "prd_protocol": {"weight": prd_weight, "cadence": prd_cadence,
                         "camera_lr_mult": camera_lr_mult,
                         "camera_lr_until": camera_lr_until,
                         "camera_lr_hold": camera_lr_hold,
                         "add_prd": add_prd},
        "train_rays_per_sec_incl_setup": round(n_steps * cfg.sampling.N_rand / total_dt, 1),
        "train_rays_per_sec_marginal": round(extra * cfg.sampling.N_rand / marginal_dt, 1),
        "final_metrics": final_metrics,
        "finite": bool(all(np.isfinite(v) for v in final_metrics.values())),
        "heldout_eval": {k: float(v) for k, v in ev.items()
                         if isinstance(v, (int, float, np.floating))},
        "eval_protocol_ab": protocol_ab,
        "quality": quality,
        "eval_curve": curve,
        "device": device_name(device),
    }
    print(json.dumps(report, indent=2))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


def device_name(device: torch.device) -> str:
    """The card's name, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m scnerf_tpu_torch.scripts.soak_nerf")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--eval_every", type=int, default=1000)
    ap.add_argument("--psnr_gate", type=float, default=25.0)
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes (a CPU check of the soak's mechanics)")
    # The calibration protocol's knobs; the defaults are the published one.
    ap.add_argument("--prd_weight", type=float, default=1e-4)
    ap.add_argument("--prd_cadence", type=int, default=10)
    ap.add_argument("--camera_lr_mult", type=float, default=1.0)
    ap.add_argument("--camera_lr_hold", type=float, default=1.0,
                    help="the multiplier on the calibration leaves after "
                         "--camera_lr_until (1.0 = the reference's)")
    ap.add_argument("--camera_lr_until", type=int, default=0,
                    help="switch the multiplier to the hold after this step (0 = never)")
    ap.add_argument("--add_prd", type=int, default=2000)
    ap.add_argument("--focal_gate", type=float, default=None)
    ap.add_argument("--rot_gate", type=float, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default the card)")
    a = ap.parse_args()
    dev = device_or_exit(a.device, ap.prog)
    if dev is None:
        sys.exit(2)
    main(a.steps, a.out, a.workdir, small=a.small, eval_every=a.eval_every,
         psnr_gate=a.psnr_gate, prd_weight=a.prd_weight,
         prd_cadence=a.prd_cadence, camera_lr_mult=a.camera_lr_mult,
         camera_lr_until=a.camera_lr_until,
         camera_lr_hold=a.camera_lr_hold,
         add_prd=a.add_prd, focal_gate=a.focal_gate, rot_gate=a.rot_gate, device=dev)
