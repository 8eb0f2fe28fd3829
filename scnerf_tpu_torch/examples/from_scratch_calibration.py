"""Self-calibration from scratch: no initial poses and a wrong focal.

Port of ``examples/from_scratch_calibration.py``, the reference's
``run_without_colmap`` regime: a forward-facing rig of 12 views of the
analytic scene at 100x100 (cameras near (0, 0, 4) looking down -z with
small tilts; 11 train views, 1 held out). The learnable camera starts at
identity rotations, zero translations and a focal of W (the true one is
90); a 4x64 NeRF (48+48 samples, 1,024 rays a step) trains with it for
12,000 steps, the PRD loss (weight 0.05) on exact correspondences between
every pair of train views on every step. Reported: the rotation and
translation errors after a Sim(3) alignment onto GT, and the held-out
view's PSNR at its GT pose carried into the learned frame. Identity is a
small perturbation only for a forward-facing rig; an orbit cannot be
recovered this way.

Outcomes on an NVIDIA H100 are recorded in ``PERF.md``.

    python -m scnerf_tpu_torch.examples.from_scratch_calibration [--device cuda|cpu]
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
    host_camera,
    init_camera,
    trainable_camera,
)
from scnerf_tpu_torch.camera.rays import full_image_pixels, pixels_to_rays
from scnerf_tpu_torch.cli.train import device_or_exit
from scnerf_tpu_torch.data.batching import gather_target, sample_pixels
from scnerf_tpu_torch.examples._common import (
    MODEL,
    Rig,
    StepClock,
    project,
    render_gt_images,
    rig_for,
    small_nerf,
)
from scnerf_tpu_torch.geometry.alignment import align_c2w_trajectories, apply_sim3
from scnerf_tpu_torch.geometry.so3 import axis_angle_to_rotation
from scnerf_tpu_torch.losses.photometric import img2mse, mse2psnr
from scnerf_tpu_torch.matching.provider import PairMatches, PrecomputedMatches, pad_matches
from scnerf_tpu_torch.render.renderer import RenderConfig, render_chunked
from scnerf_tpu_torch.serve import fp32_inference
from scnerf_tpu_torch.train.curriculum import Curriculum
from scnerf_tpu_torch.train.driver import step_generator, to_device
from scnerf_tpu_torch.train.optim import Optimizer
from scnerf_tpu_torch.train.step import TrainConfig, create_train_state, make_train_step

N_IMG = 12
N_STEPS = 12000
NEAR, FAR = 0.5, 8.0  # the training and held-out render's bounds
RENDER = RenderConfig(n_samples=48, n_importance=48)


def forward_facing_poses(rng: np.random.RandomState) -> np.ndarray:
    """GT poses near (0, 0, 4) looking down -z, each tilted by up to 0.06
    rad about a random axis (``axis_angle_to_rotation`` in float32, as the
    JAX example)."""
    gt_poses = np.broadcast_to(np.eye(4), (N_IMG, 4, 4)).copy()
    for i in range(N_IMG):
        ax = rng.randn(3)
        ax /= np.linalg.norm(ax)
        angle = rng.uniform(-0.06, 0.06)
        gt_poses[i, :3, :3] = axis_angle_to_rotation(
            torch.tensor(ax[None], dtype=torch.float32),
            torch.tensor([angle], dtype=torch.float32))[0].numpy()
        gt_poses[i, :3, 3] = [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5),
                              4.0 + rng.uniform(-0.3, 0.3)]
    return gt_poses


def build_scene(rig: Rig, device: torch.device | str) -> dict:
    """GT poses and images (rendered in [2, 6.5]), the split and the exact
    correspondences between every pair of train views with 32 or more,
    from ``RandomState(0)`` in the JAX example's order."""
    rng = np.random.RandomState(0)
    gt_poses = forward_facing_poses(rng)
    images = render_gt_images(rig, gt_poses, 2.0, 6.5, device)
    i_test = np.array([0])
    i_train = np.array([i for i in range(N_IMG) if i != 0])
    pts3d = rng.randn(500, 3) * 0.5
    cache, pair_list = PrecomputedMatches(), []
    for a in range(len(i_train)):
        for b in range(a + 1, len(i_train)):
            pa, oka = project(rig, gt_poses[i_train[a]], pts3d)
            pb, okb = project(rig, gt_poses[i_train[b]], pts3d)
            ok = oka & okb
            if ok.sum() >= 32:
                cache.put(a, b, PairMatches(pa[ok].astype(np.float32),
                                            pb[ok].astype(np.float32)))
                pair_list.append((a, b))
    return dict(rig=rig, gt_poses=gt_poses, images=images, i_test=i_test, i_train=i_train,
                cache=cache, pair_list=pair_list)


def aligned_err(camera, gt_train: np.ndarray):
    """Mean rotation error (degrees) and translation error of the learned
    poses aligned onto GT by a Sim(3), on the host."""
    with torch.no_grad():
        aligned, _ = align_c2w_trajectories(get_extrinsics(host_camera(camera)),
                                            torch.as_tensor(gt_train, dtype=torch.float32))
    aligned = aligned.numpy()
    rot = [np.degrees(np.arccos(np.clip((np.trace(aligned[i][:3, :3].T @ gt_train[i][:3, :3])
                                         - 1) / 2, -1, 1)))
           for i in range(len(gt_train))]
    t = np.linalg.norm(aligned[:, :3, 3] - gt_train[:, :3, 3], axis=1)
    return float(np.mean(rot)), float(np.mean(t))


def heldout_psnr(scene: dict, params: dict, device) -> float:
    """The held-out view at its GT pose carried into the learned frame."""
    rig, gt_poses, ti = scene["rig"], scene["gt_poses"], int(scene["i_test"][0])
    cam = params["camera"]
    with fp32_inference():
        train_gt = torch.as_tensor(gt_poses[scene["i_train"]], dtype=torch.float32,
                                   device=device)
        _, (s3, R3, t3) = align_c2w_trajectories(train_gt, get_extrinsics(cam))
        gt = torch.as_tensor(gt_poses[ti:ti + 1], dtype=torch.float32, device=device)
        px, py = full_image_pixels(rig.H, rig.W, device=device)
        o, d = pixels_to_rays(cam, px, py, c2w=apply_sim3(gt, s3, R3, t3)[0])
        vd = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-10)
        out = render_chunked(params, MODEL, RENDER.eval_mode(), o, d, vd, NEAR, FAR)
        target = torch.as_tensor(scene["images"][ti].reshape(-1, 3), device=device)
        return float(mse2psnr(img2mse(torch.clamp(out["rgb"], max=1.0), target)))


def main(steps: int | None = None, device: torch.device | str = "cuda",
         small: bool = False) -> dict:
    """``steps`` of training with PRD on every step (default 12,000);
    ``small`` at 20x20 and 64 rays a step."""
    device = torch.device(device)
    steps = N_STEPS if steps is None else steps
    scene = build_scene(rig_for(small), device)
    images, i_train, pair_list = scene["images"], scene["i_train"], scene["pair_list"]
    H, W, n_rand = scene["rig"].H, scene["rig"].W, scene["rig"].n_rand
    gt_train = scene["gt_poses"][i_train]
    print("pairs:", len(pair_list))

    # From scratch: identity R, zero t, fx = W and fy = H (the reference's
    # run_without_colmap).
    scratch = np.broadcast_to(np.eye(4), (len(i_train), 4, 4)).copy()
    K0 = np.array([[W, 0, W / 2, 0], [0, H, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    ccfg = CameraConfig(H=H, W=W, grid_size=10, convention=OPENGL,
                        intrinsics_noise_scale=1.0, extrinsics_noise_scale=1.0)
    params = small_nerf(device)
    params["camera"] = trainable_camera(init_camera(K0, scratch, ccfg, device=device))
    tcfg = TrainConfig(lr_init=1e-3, lr_decay_steps=200e3, near=NEAR, far=FAR,
                       prd_method="NeRF")
    cur = Curriculum(add_ie=0, add_od=1000000, add_prd=0, i_ray_dist_loss=1,
                     ray_dist_loss_weight=0.05)
    opt = Optimizer.from_config(tcfg)
    state = create_train_state(params, opt)
    step_prd = make_train_step(MODEL, RENDER, tcfg, cur, opt, with_prd=True)

    nprng = np.random.RandomState(2)
    first = m = None
    curve = []
    with StepClock(device) as clock:
        for it in range(steps):
            ci = nprng.randint(0, len(i_train))
            px, py = sample_pixels(nprng, H, W, n_rand)
            a, b = pair_list[nprng.randint(len(pair_list))]
            kps0, kps1, mask = pad_matches(scene["cache"].get(a, b), 256)
            batch = to_device({"px": px, "py": py, "img_idx": np.full((n_rand,), ci, np.int32),
                               "target": gather_target(images, i_train[ci], px, py),
                               "kps0": kps0, "kps1": kps1, "kp_mask": mask,
                               "pair_idx": np.array([a, b], np.int64)}, device)
            state, m = step_prd(state, batch, step_generator(0, it, device))
            if first is None:
                first = m
            if it % 2000 == 0:
                r, t = aligned_err(state.params["camera"], gt_train)
                row = {"it": it, "loss": float(m["loss"]), "psnr": float(m["psnr"]),
                       "prd": float(m["prd"]), "prd_matches": int(m["prd_matches"]),
                       "rot": r, "t": t}
                curve.append(row)
                print("it %5d loss=%.4f psnr=%.1f prd=%.3f n=%3d | rot=%.3f t=%.4f" % (
                    it, row["loss"], row["psnr"], row["prd"], row["prd_matches"], r, t))
    r1, t1 = aligned_err(state.params["camera"], gt_train)
    psnr = heldout_psnr(scene, state.params, device)
    print("final: rot=%.3f deg t=%.4f | held-out PSNR=%.2f dB" % (r1, t1, psnr))
    # The identity start puts every camera centre at the origin, where the
    # alignment is undefined: the errors start from the first step's.
    return {"steps": steps, "rot_err_initial": curve[0]["rot"], "trans_err_initial": curve[0]["t"],
            "rot_err_final": r1, "trans_err_final": t1, "heldout_psnr": psnr,
            "train_psnr_last": float(m["psnr"]), "prd_last": float(m["prd"]),
            "prd_matches_last": int(m["prd_matches"]),
            "loss_first": float(first["loss"]), "loss_last": float(m["loss"]),
            "curve": curve, "ms_per_step": clock.ms_per_step(steps)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m scnerf_tpu_torch.examples.from_scratch_calibration")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args()
    dev = device_or_exit(a.device, ap.prog)
    if dev is None:
        sys.exit(2)
    main(device=dev)
