"""Radial distortion found from k = 0 by the distortion-aware PRD.

Port of ``examples/distortion_discovery.py``. The reference's PRD compares
projections made in warped pixel space with raw keypoints, so radial
coefficients are not observable through it. ``losses/prd.py``'s
distortion-aware variant maps the projections back through the
differentiable inverse-distortion lookup (``camera/distortion.py``), which
makes ``k`` learnable from correspondences alone.

A synthetic rig of 4 views (480x640, focal 520) sees 256 points through a
GT camera with k = (0.08, -0.03): its raw keypoints are the pinhole
projections taken through ``undistort_pixels`` with the GT ``k``. The
learnable OpenCV camera starts at k = 0, and Adam on its distortion noise
alone (lr 0.3 on a noise scaled by 1e-2) minimises the distortion-aware
PRD over every pair for 1,500 steps. Reported: ``|k - k_gt|`` and the PRD
before and after (the residual PRD is the half-pixel convention and the
lookup's linear interpolation).

Outcomes on an NVIDIA H100 are recorded in ``PERF.md``.

    python -m scnerf_tpu_torch.examples.distortion_discovery [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from scnerf_tpu_torch.camera.distortion import undistort_pixels
from scnerf_tpu_torch.camera.model import (
    OPENCV,
    CameraConfig,
    get_distortion,
    get_extrinsic,
    get_intrinsic,
    init_camera,
)
from scnerf_tpu_torch.camera.rays import pixels_to_rays
from scnerf_tpu_torch.cli.train import device_or_exit
from scnerf_tpu_torch.examples._common import StepClock
from scnerf_tpu_torch.geometry.so3 import axis_angle_to_rotation, embed_rotation_44
from scnerf_tpu_torch.losses.prd import prd_loss
from scnerf_tpu_torch.serve import fp32
from scnerf_tpu_torch.train.optim import Optimizer, apply_updates

K_GT = np.array([0.08, -0.03], np.float32)
H, W = 480, 640
N_VIEWS = 4
N_PTS = 256
N_STEPS = 1500


def build_rig():
    """GT K, the views' c2w ``(N_VIEWS, 4, 4)`` and, for each pair with 64
    or more points seen by both, up to 128 raw-pixel keypoints in each
    view: ``[(i, j, kps0, kps1)]``. Built on the host from
    ``RandomState(0)`` in the JAX example's order."""
    rng = np.random.RandomState(0)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 520.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    ax = rng.randn(N_VIEWS, 3)
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    E = embed_rotation_44(axis_angle_to_rotation(
        torch.tensor(ax, dtype=torch.float32),
        torch.tensor(rng.rand(N_VIEWS) * 0.12, dtype=torch.float32))).numpy()
    E[:, :3, 3] = rng.randn(N_VIEWS, 3) * 0.25
    pts = rng.randn(N_PTS, 3) * np.array([1.2, 0.9, 0.4]) + np.array([0, 0, 5.0])

    def observe(E_i):
        """Raw-pixel keypoints of ``pts`` as the distorted GT camera sees
        them."""
        cam_pts = (pts - E_i[:3, 3]) @ E_i[:3, :3]
        pix = cam_pts @ K[:3, :3].T
        warped = pix[:, :2] / pix[:, 2:3]
        valid, xy = undistort_pixels(W, H, torch.from_numpy(K_GT),
                                     torch.tensor(warped[:, 0], dtype=torch.float32),
                                     torch.tensor(warped[:, 1], dtype=torch.float32))
        return valid.numpy(), xy.numpy().astype(np.float32)

    obs = [observe(E[i]) for i in range(N_VIEWS)]
    pairs = []
    for i in range(N_VIEWS):
        for j in range(i + 1, N_VIEWS):
            keep = obs[i][0] & obs[j][0]
            if keep.sum() >= 64:
                pairs.append((i, j, obs[i][1][keep][:128], obs[j][1][keep][:128]))
    return K, E, pairs


def main(steps: int | None = None, device: torch.device | str = "cuda") -> dict:
    device = torch.device(device)
    steps = N_STEPS if steps is None else steps
    K, E, pairs = build_rig()
    print(f"rig: {N_VIEWS} views, {len(pairs)} correspondence pairs, k_gt={K_GT.tolist()}")
    cam = init_camera(
        K, E,
        CameraConfig(H=H, W=W, convention=OPENCV, pixel_offset=0.5,
                     use_distortion=True, distortion_noise_scale=1e-2),
        k=np.zeros(2, np.float32),  # zero-init: k is found
        device=device)
    # Every pair's keypoints padded to one length, so that one vmapped PRD
    # covers them all (a padded match is masked out of its pair's mean).
    M = max(len(k0) for _, _, k0, _ in pairs)
    kps = np.zeros((2, len(pairs), M, 2), np.float32)
    mask = np.zeros((len(pairs), M), bool)
    for p, (_, _, k0, k1) in enumerate(pairs):
        kps[0, p, :len(k0)], kps[1, p, :len(k1)], mask[p, :len(k0)] = k0, k1, True
    kps, mask = torch.from_numpy(kps).to(device), torch.from_numpy(mask).to(device)
    idx = torch.tensor([(i, j) for i, j, _, _ in pairs], device=device)
    noise = cam.distortion_noise.clone().requires_grad_(True)
    leaves = {"camera/distortion_noise": noise}
    # Adam alone on the noise (scaled by 1e-2: k's rate is 3e-3).
    opt = Optimizer(3e-1, decay_steps=1.0, decay_factor=1.0, grad_clip=0.0)
    opt_state = opt.init(leaves)

    def pair_prd(k0, k1, m, r0, r1, E_pair, K, k):
        loss, _ = prd_loss(k0, k1, r0, r1, K, E_pair, mask=m, method="NeRF++", mode="val",
                           threshold=100.0, distortion_k=k, image_wh=(W, H))
        return loss

    per_pair = torch.func.vmap(pair_prd, in_dims=(0, 0, 0, 0, 0, 0, None, None))

    def total_prd(noise):
        """The mean over the pairs of each pair's PRD, the rays through the
        raw keypoints (less the half-pixel offset the camera adds back)."""
        c = dataclasses.replace(cam, distortion_noise=noise)
        E = get_extrinsic(c, idx)  # (P, 2, 4, 4)
        rays = []
        for side in (0, 1):
            c2w = E[:, side, None].expand(-1, M, 4, 4).reshape(-1, 4, 4)
            o, d = pixels_to_rays(c, kps[side, ..., 0].reshape(-1) - 0.5,
                                  kps[side, ..., 1].reshape(-1) - 0.5, c2w=c2w,
                                  add_noise=False)
            rays.append((o.reshape(-1, M, 3), d.reshape(-1, M, 3)))
        return per_pair(kps[0], kps[1], mask, rays[0], rays[1], E, get_intrinsic(c),
                        get_distortion(c)).mean()

    def k_now():
        with torch.no_grad():
            return get_distortion(dataclasses.replace(cam, distortion_noise=noise)).cpu().numpy()

    with fp32(), torch.no_grad():
        prd0 = float(total_prd(noise))
    k0 = k_now()
    err0 = float(np.abs(k0 - K_GT).max())
    print(f"init:  k={k0.tolist()}  |k-k_gt|={err0:.4f}  prd={prd0:.4f}")
    curve = []
    with StepClock(device) as clock:
        for it in range(steps):
            with fp32():
                loss = total_prd(noise)
                (g,) = torch.autograd.grad(loss, [noise])
                apply_updates(leaves, opt.update({"camera/distortion_noise": g}, opt_state,
                                                 leaves))
            if (it + 1) % 300 == 0:
                k = k_now()
                curve.append({"step": it + 1, "prd": float(loss), "k": k.tolist(),
                              "k_err": float(np.abs(k - K_GT).max())})
                print(f"step {it + 1:5d}: prd={float(loss):.5f}  k={np.round(k, 4).tolist()}  "
                      f"|k-k_gt|={curve[-1]['k_err']:.4f}")
    with fp32(), torch.no_grad():
        prd1 = float(total_prd(noise))
    k_final = k_now()
    err = float(np.abs(k_final - K_GT).max())
    print(f"final: k={k_final.tolist()} vs k_gt={K_GT.tolist()} -> max err {err:.4f} "
          f"({'OK' if err < 0.005 else 'NOT CONVERGED'}); prd {prd0:.4f} -> {prd1:.4f}")
    return {"steps": steps, "k_initial": k0.tolist(), "k_final": k_final.tolist(),
            "k_err_initial": err0, "k_err_final": err, "prd_initial": prd0,
            "prd_final": prd1, "converged": bool(err < 0.005), "curve": curve,
            "ms_per_step": clock.ms_per_step(steps)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m scnerf_tpu_torch.examples.distortion_discovery")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args()
    dev = device_or_exit(a.device, ap.prog)
    if dev is None:
        sys.exit(2)
    main(device=dev)
