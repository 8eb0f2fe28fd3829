"""The paper's claim as an ablation: noisy cameras, a NeRF trained with and
without the self-calibrating camera model, held-out PSNR of each.

Port of ``examples/calibration_ablation.py``: 14 views of the analytic
scene at 100x100 (12 train, 2 test), the train cameras perturbed by up to 3
degrees of rotation, 0.1 of translation and 10% of focal; a 4x64 NeRF
with 48+48 samples and 1,024 rays a step for 6,000 steps each way. With the
camera model the intrinsics and extrinsics learn from step 0, the ray
grids from step 4,000, and every other step adds the PRD loss on exact
correspondences between neighbouring train views; the test views render at
their GT poses carried into the learned frame by an ATE alignment. Without
it the rays come from the noisy poses and focal.

Outcomes on an NVIDIA H100 are recorded in ``PERF.md``.

    python -m scnerf_tpu_torch.examples.calibration_ablation [--device cuda|cpu]
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
    init_camera,
    trainable_camera,
)
from scnerf_tpu_torch.camera.rays import full_image_pixels, pixels_to_rays, rays_no_camera
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
from scnerf_tpu_torch.geometry.alignment import align_c2w_trajectories, apply_sim3
from scnerf_tpu_torch.losses.photometric import img2mse, mse2psnr
from scnerf_tpu_torch.matching.provider import PairMatches, PrecomputedMatches, pad_matches
from scnerf_tpu_torch.render.renderer import RenderConfig, render_chunked
from scnerf_tpu_torch.serve import fp32_inference
from scnerf_tpu_torch.train.curriculum import Curriculum
from scnerf_tpu_torch.train.driver import step_generator, to_device
from scnerf_tpu_torch.train.optim import Optimizer
from scnerf_tpu_torch.train.step import TrainConfig, create_train_state, make_train_step

N_IMG = 14
N_STEPS = 6000
NEAR, FAR = 2.0, 5.5
RENDER = RenderConfig(n_samples=48, n_importance=48, white_bkgd=False)


def build_scene(rig: Rig, device: torch.device | str) -> dict:
    """GT poses and images, the split, the injected noise and the exact
    correspondences between neighbouring train views (camera-table
    indices), all from ``RandomState(0)`` in the JAX example's order."""
    rng = np.random.RandomState(0)
    gt_poses = orbit_poses(N_IMG)
    images = render_gt_images(rig, gt_poses, NEAR, FAR, device)
    i_test = np.array([0, 7])
    i_train = np.array([i for i in range(N_IMG) if i not in i_test])
    noise = NoiseConfig(intrinsic_scale=0.10, rotation_deg=3.0, translation=0.10)
    noisy_poses, noisy_focal = inject_pose_noise(gt_poses[:, :3, :4], rig.F, i_train, noise, rng)
    pts3d = rng.randn(400, 3) * 0.5
    cache, pair_list = PrecomputedMatches(), []
    for a in range(len(i_train)):
        b = (a + 1) % len(i_train)
        pa, oka = project(rig, gt_poses[i_train[a]], pts3d)
        pb, okb = project(rig, gt_poses[i_train[b]], pts3d)
        ok = oka & okb
        if ok.sum() >= 16:
            # Stored under (lower, higher) with kps0 in the lower view. The
            # JAX example puts the wrap-around pair's matches the other way
            # round, so its PRD reads them against swapped cameras.
            lo, hi = (pa, pb) if a < b else (pb, pa)
            cache.put(min(a, b), max(a, b),
                      PairMatches(lo[ok].astype(np.float32), hi[ok].astype(np.float32)))
            pair_list.append((min(a, b), max(a, b)))
    return dict(rig=rig, gt_poses=gt_poses, images=images, i_test=i_test, i_train=i_train,
                noisy_poses=noisy_poses, noisy_focal=noisy_focal, cache=cache,
                pair_list=pair_list)


def run(scene: dict, with_camera: bool, steps: int, device: torch.device) -> dict:
    """Train one arm of the ablation; its held-out PSNR and its loss."""
    rig, images, i_train = scene["rig"], scene["images"], scene["i_train"]
    H, W, n_rand = rig.H, rig.W, rig.n_rand
    noisy_poses, noisy_focal = scene["noisy_poses"], scene["noisy_focal"]
    tcfg = TrainConfig(lr_init=1e-3, lr_decay_steps=200e3, near=NEAR, far=FAR)
    params = small_nerf(device)
    if with_camera:
        K_noisy = rig.K
        K_noisy[0, 0] = K_noisy[1, 1] = noisy_focal
        ccfg = CameraConfig(H=H, W=W, grid_size=10, convention=OPENGL,
                            intrinsics_noise_scale=1.0, extrinsics_noise_scale=0.1)
        params["camera"] = trainable_camera(
            init_camera(K_noisy, noisy_poses[i_train], ccfg, device=device))
    opt = Optimizer.from_config(tcfg)
    state = create_train_state(params, opt)
    cur = Curriculum(add_ie=0, add_od=4000, add_prd=0, i_ray_dist_loss=2,
                     ray_dist_loss_weight=1e-3)
    step = make_train_step(MODEL, RENDER, tcfg, cur, opt)
    step_prd = make_train_step(MODEL, RENDER, tcfg, cur, opt, with_prd=True)
    nprng = np.random.RandomState(2)
    first = m = None
    with StepClock(device) as clock:
        for it in range(steps):
            ci = nprng.randint(0, len(i_train))
            img_i = i_train[ci]
            px, py = sample_pixels(nprng, H, W, n_rand)
            target = gather_target(images, img_i, px, py)
            gen = step_generator(0, it, device)
            if not with_camera:
                b = to_device({"px": px, "py": py, "target": target,
                               "c2w": noisy_poses[img_i].astype(np.float32)}, device)
                o, d = rays_no_camera(H, W, noisy_focal, b["c2w"], b["px"], b["py"])
                state, m = step(state, {"rays_o": o, "rays_d": d, "target": b["target"]}, gen)
            elif it % 2 == 0 and scene["pair_list"]:
                a, b = scene["pair_list"][nprng.randint(len(scene["pair_list"]))]
                kps0, kps1, mask = pad_matches(scene["cache"].get(a, b), 256)
                batch = to_device({"px": px, "py": py,
                                   "img_idx": np.full((n_rand,), ci, np.int32),
                                   "target": target, "kps0": kps0, "kps1": kps1,
                                   "kp_mask": mask, "pair_idx": np.array([a, b], np.int64)},
                                  device)
                state, m = step_prd(state, batch, gen)
            else:
                batch = to_device({"px": px, "py": py,
                                   "img_idx": np.full((n_rand,), ci, np.int32),
                                   "target": target}, device)
                state, m = step(state, batch, gen)
            if first is None:
                first = m
    psnrs = heldout_psnrs(scene, state.params, with_camera, device)
    out = {"psnr": float(np.mean(psnrs)), "per_view_psnr": psnrs,
           "loss_first": float(first["loss"]), "loss_last": float(m["loss"]),
           "ms_per_step": clock.ms_per_step(steps)}
    print("  per-view test psnrs:", ["%.3f" % p for p in psnrs],
          " last-train-loss %.5f" % out["loss_last"])
    return out


def heldout_psnrs(scene: dict, params: dict, with_camera: bool, device) -> list:
    """PSNR of each test view: at its GT pose carried into the learned frame
    (ATE alignment) through the learned camera, or at its GT pose through
    the noisy focal."""
    rig, gt_poses = scene["rig"], scene["gt_poses"]
    psnrs = []
    with fp32_inference():
        px, py = full_image_pixels(rig.H, rig.W, device=device)
        for ti in scene["i_test"]:
            gt = torch.as_tensor(gt_poses[ti:ti + 1], dtype=torch.float32, device=device)
            if with_camera:
                cam = params["camera"]
                train_gt = torch.as_tensor(gt_poses[scene["i_train"]], dtype=torch.float32,
                                           device=device)
                _, (s3, R3, t3) = align_c2w_trajectories(train_gt, get_extrinsics(cam))
                o, d = pixels_to_rays(cam, px, py, c2w=apply_sim3(gt, s3, R3, t3)[0])
            else:
                o, d = rays_no_camera(rig.H, rig.W, scene["noisy_focal"], gt[0], px, py)
            vd = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-10)
            out = render_chunked(params, MODEL, RENDER.eval_mode(), o, d, vd, NEAR, FAR)
            rgb = torch.clamp(out["rgb"], max=1.0)
            target = torch.as_tensor(scene["images"][ti].reshape(-1, 3), device=device)
            psnrs.append(float(mse2psnr(img2mse(rgb, target))))
    return psnrs


def main(steps: int | None = None, device: torch.device | str = "cuda",
         small: bool = False) -> dict:
    """Both arms for ``steps`` each (default 6,000); ``small`` at 20x20 and
    64 rays a step."""
    device = torch.device(device)
    steps = N_STEPS if steps is None else steps
    scene = build_scene(rig_for(small), device)
    with_cam = run(scene, True, steps, device)
    print("WITH camera model:    test PSNR = %.2f dB" % with_cam["psnr"])
    without = run(scene, False, steps, device)
    print("WITHOUT camera model: test PSNR = %.2f dB" % without["psnr"])
    gain = with_cam["psnr"] - without["psnr"]
    print("calibration gain: %+.2f dB" % gain)
    return {"steps": steps, "with_camera": with_cam, "without_camera": without,
            "gain_db": gain}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m scnerf_tpu_torch.examples.calibration_ablation")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args()
    dev = device_or_exit(a.device, ap.prog)
    if dev is None:
        sys.exit(2)
    main(device=dev)
