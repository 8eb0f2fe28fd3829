"""Self-calibration end to end: noisy cameras recovered by joint training.

Port of ``examples/self_calibration_demo.py``: 12 views of the analytic
scene at 100x100 on an orbit, every camera perturbed by up to 3 degrees of
rotation, 0.1 of translation and 10% of focal; the learnable camera
trained jointly with a 4x64 NeRF (48+48 samples, 1,024 rays a step, sigma
noise 1.0) for 5,000 steps, with the PRD loss on exact correspondences
between neighbouring views every other step. The camera errors are taken
after a Sim(3) alignment of the learned poses onto GT (gauge-free); the
calibration counts as recovered when the rotation and translation errors
both halve.

Outcomes on an NVIDIA H100 are recorded in ``PERF.md``.

    python -m scnerf_tpu_torch.examples.self_calibration_demo [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from scnerf_tpu_torch.camera.model import (
    OPENGL,
    CameraConfig,
    get_extrinsics,
    get_intrinsic,
    host_camera,
    init_camera,
    trainable_camera,
)
from scnerf_tpu_torch.cli.train import device_or_exit
from scnerf_tpu_torch.data.batching import gather_target, sample_pixels
from scnerf_tpu_torch.data.noise import NoiseConfig, inject_pose_noise
from scnerf_tpu_torch.examples._common import (
    MODEL,
    Rig,
    StepClock,
    orbit_poses,
    project,
    render_gt_images,
    rig_for,
    small_nerf,
)
from scnerf_tpu_torch.geometry.alignment import align_c2w_trajectories
from scnerf_tpu_torch.geometry.so3 import rotation_to_axis_angle
from scnerf_tpu_torch.matching.provider import PairMatches, PrecomputedMatches, pad_matches
from scnerf_tpu_torch.render.renderer import RenderConfig
from scnerf_tpu_torch.train.curriculum import Curriculum
from scnerf_tpu_torch.train.driver import step_generator, to_device
from scnerf_tpu_torch.train.optim import Optimizer
from scnerf_tpu_torch.train.step import TrainConfig, create_train_state, make_train_step

N_IMG = 12
N_STEPS = 5000
NEAR, FAR = 2.0, 5.5


def build_scene(rig: Rig, device: torch.device | str) -> dict:
    """GT poses and images, the noise on every camera and the exact
    correspondences between neighbouring views, from ``RandomState(0)`` in
    the JAX example's order."""
    rng = np.random.RandomState(0)
    gt_poses = orbit_poses(N_IMG)
    images = render_gt_images(rig, gt_poses, NEAR, FAR, device)
    noise = NoiseConfig(intrinsic_scale=0.10, rotation_deg=3.0, translation=0.10)
    noisy_poses, noisy_focal = inject_pose_noise(gt_poses[:, :3, :4], rig.F, np.arange(N_IMG),
                                                 noise, rng)
    pts3d = rng.randn(400, 3) * 0.5
    cache, pairs = PrecomputedMatches(), []
    for i in range(N_IMG):
        j = (i + 1) % N_IMG
        pi, oki = project(rig, gt_poses[i], pts3d)
        pj, okj = project(rig, gt_poses[j], pts3d)
        ok = oki & okj
        if ok.sum() >= 16:
            # Stored under (lower, higher) with kps0 in the lower view. The
            # JAX example puts the wrap-around pair's matches the other way
            # round, so its PRD reads them against swapped cameras.
            lo, hi = (pi, pj) if i < j else (pj, pi)
            cache.put(min(i, j), max(i, j),
                      PairMatches(lo[ok].astype(np.float32), hi[ok].astype(np.float32)))
            pairs.append((min(i, j), max(i, j)))
    return dict(rig=rig, gt_poses=gt_poses, images=images, noisy_poses=noisy_poses,
                noisy_focal=noisy_focal, cache=cache, pairs=pairs)


def pose_errors(camera, gt_poses: np.ndarray, focal: float):
    """Mean rotation error (degrees) and translation error after a Sim(3)
    alignment of the learned poses onto GT, and the focal's absolute
    error; on the host, in float32 as the JAX example."""
    cam = host_camera(camera)
    with torch.no_grad():
        aligned, _ = align_c2w_trajectories(get_extrinsics(cam),
                                            torch.as_tensor(gt_poses, dtype=torch.float32))
        R_rel = aligned[:, :3, :3].transpose(1, 2).double() @ torch.from_numpy(gt_poses[:, :3, :3])
        _, angle = rotation_to_axis_angle(R_rel)
        aligned = aligned.numpy()
    t_err = np.linalg.norm(aligned[:, :3, 3] - gt_poses[:, :3, 3], axis=1)
    return (float(np.degrees(angle.numpy()).mean()), float(np.mean(t_err)),
            float(abs(get_intrinsic(cam)[0, 0] - focal)))


def main(steps: int | None = None, device: torch.device | str = "cuda",
         small: bool = False) -> dict:
    """``steps`` of joint training (default 5,000); ``small`` at 20x20 and
    64 rays a step."""
    device = torch.device(device)
    steps = N_STEPS if steps is None else steps
    scene = build_scene(rig_for(small), device)
    rig, images, gt_poses = scene["rig"], scene["images"], scene["gt_poses"]
    H, W, n_rand = rig.H, rig.W, rig.n_rand
    print("GT images rendered:", images.shape, images.min(), images.max())
    n_matches = [scene["cache"].get(i, j).kps0.shape[0] for i, j in scene["pairs"]]
    print("pairs with matches:", len(scene["pairs"]), "avg matches:", np.mean(n_matches))

    K_noisy = rig.K
    K_noisy[0, 0] = K_noisy[1, 1] = scene["noisy_focal"]
    ccfg = CameraConfig(H=H, W=W, grid_size=10, convention=OPENGL,
                        intrinsics_noise_scale=1.0, extrinsics_noise_scale=0.1)
    params = small_nerf(device)
    params["camera"] = trainable_camera(
        init_camera(K_noisy, scene["noisy_poses"], ccfg, device=device))
    render = RenderConfig(n_samples=48, n_importance=48, white_bkgd=False, raw_noise_std=1.0)
    tcfg = TrainConfig(lr_init=1e-3, lr_decay_steps=200e3, near=NEAR, far=FAR,
                       prd_method="NeRF")
    cur = Curriculum(add_ie=0, add_od=100000, add_prd=0, i_ray_dist_loss=2,
                     ray_dist_loss_weight=1e-3)
    opt = Optimizer.from_config(tcfg)
    state = create_train_state(params, opt)
    step = make_train_step(MODEL, render, tcfg, cur, opt)
    step_prd = make_train_step(MODEL, render, tcfg, cur, opt, with_prd=True)

    r0, t0, f0 = pose_errors(state.params["camera"], gt_poses, rig.F)
    print("initial: rot_err=%.3f deg  t_err=%.4f  focal_err=%.2f" % (r0, t0, f0))
    nprng = np.random.RandomState(2)
    first = m = None
    curve = []
    with StepClock(device) as clock:
        for it in range(steps):
            li = nprng.randint(0, N_IMG)
            px, py = sample_pixels(nprng, H, W, n_rand)
            arrays = {"px": px, "py": py, "img_idx": np.full((n_rand,), li, np.int32),
                      "target": gather_target(images, li, px, py)}
            gen = step_generator(0, it, device)
            if it % 2 == 0:
                i, j = scene["pairs"][nprng.randint(len(scene["pairs"]))]
                kps0, kps1, mask = pad_matches(scene["cache"].get(i, j), 256)
                arrays.update(kps0=kps0, kps1=kps1, kp_mask=mask,
                              pair_idx=np.array([i, j], np.int64))
                state, m = step_prd(state, to_device(arrays, device), gen)
            else:
                state, m = step(state, to_device(arrays, device), gen)
            if first is None:
                first = m
            if it % 500 == 0:
                r, t, f = pose_errors(state.params["camera"], gt_poses, rig.F)
                row = {"it": it, "loss": float(m["loss"]), "psnr": float(m["psnr"]),
                       "prd": float(m.get("prd", -1)), "rot": r, "t": t, "f": f}
                curve.append(row)
                print("it %4d loss=%.4f psnr=%.1f prd=%.3f | rot=%.3f t=%.4f f=%.2f" % (
                    it, row["loss"], row["psnr"], row["prd"], r, t, f))
    r1, t1, f1 = pose_errors(state.params["camera"], gt_poses, rig.F)
    recovered = r1 < r0 * 0.5 and t1 < t0 * 0.5
    print("final:   rot_err=%.3f deg  t_err=%.4f  focal_err=%.2f" % (r1, t1, f1))
    print("CALIBRATION %s" % ("RECOVERED" if recovered else "PARTIAL"))
    return {"steps": steps, "rot_err_initial": r0, "trans_err_initial": t0,
            "focal_err_initial": f0, "rot_err_final": r1, "trans_err_final": t1,
            "focal_err_final": f1, "recovered": bool(recovered),
            "loss_first": float(first["loss"]), "loss_last": float(m["loss"]),
            "prd_first": float(first.get("prd", np.nan)), "curve": curve,
            "ms_per_step": clock.ms_per_step(steps)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m scnerf_tpu_torch.examples.self_calibration_demo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args()
    dev = device_or_exit(a.device, ap.prog)
    if dev is None:
        sys.exit(2)
    main(device=dev)
