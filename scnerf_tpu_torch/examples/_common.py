"""What the examples share: the OpenGL rig looking at the analytic scene
(``scripts/_analytic_scene.py:field`` at scale 1), its GT renders, exact
correspondences, the small NeRF, the step clock, and the finite check of
an outcome."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from scnerf_tpu_torch.camera.rays import full_image_pixels, rays_no_camera
from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp
from scnerf_tpu_torch.scripts._analytic_scene import render_gt_rays
from scnerf_tpu_torch.serve import fp32_inference
from scnerf_tpu_torch.train.optim import named_leaves

GT_SAMPLES = 128
MODEL = NeRFConfig(depth=4, width=64, skips=(2,), multires=6, multires_views=2)


@dataclasses.dataclass(frozen=True)
class Rig:
    """The images' size, the GT focal and the rays a train step draws."""

    H: int
    W: int
    F: float
    n_rand: int

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.F, 0, self.W / 2, 0], [0, self.F, self.H / 2, 0],
                         [0, 0, 1, 0], [0, 0, 0, 1]])


# The examples' own rig; ``small`` keeps its field of view at a fifth of the
# size, for a check of their mechanics on the CPU.
FULL = Rig(H=100, W=100, F=90.0, n_rand=1024)
SMALL = Rig(H=20, W=20, F=18.0, n_rand=64)


def rig_for(small: bool) -> Rig:
    return SMALL if small else FULL


def look_at(eye: np.ndarray) -> np.ndarray:
    """OpenGL c2w at ``eye`` looking at the origin (z away from the target,
    y up)."""
    z = eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    E = np.eye(4)
    E[:3, 0], E[:3, 1], E[:3, 2], E[:3, 3] = x, y, z, eye
    return E


def orbit_poses(n: int) -> np.ndarray:
    """``n`` views on a radius-3.5 circle with a height wobble."""
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([look_at(np.array([3.5 * np.cos(a), 0.8 * np.sin(2 * a), 3.5 * np.sin(a)]))
                     for a in angles])


def render_gt_images(rig: Rig, poses: np.ndarray, near: float, far: float,
                     device: torch.device | str) -> np.ndarray:
    """``(N, H, W, 3)`` float32 GT renders of the analytic scene through
    ``rays_no_camera`` at the GT focal, 128 samples in ``[near, far]``."""
    out = []
    with fp32_inference():
        px, py = full_image_pixels(rig.H, rig.W, device=device)
        for c2w in poses:
            c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
            o, d = rays_no_camera(rig.H, rig.W, rig.F, c2w, px, py)
            out.append(render_gt_rays(o, d, near, far, n_samples=GT_SAMPLES)
                       .reshape(rig.H, rig.W, 3))
    return torch.stack(out).cpu().numpy()


def project(rig: Rig, E: np.ndarray, pts: np.ndarray):
    """OpenGL projection of ``pts`` into the GT camera ``E``: pixels and
    whether each lies in front (depth > 0.5) and inside the image."""
    cam = (pts - E[:3, 3]) @ E[:3, :3]
    zc = -cam[:, 2]
    u = rig.W / 2 + rig.F * cam[:, 0] / zc
    v = rig.H / 2 - rig.F * cam[:, 1] / zc
    ok = (zc > 0.5) & (u >= 0) & (u < rig.W - 1) & (v >= 0) & (v < rig.H - 1)
    return np.stack([u, v], -1), ok


def small_nerf(device: torch.device | str, seed: int = 1) -> dict:
    """The coarse and fine 4x64 MLPs, seeded, requiring grad."""
    gen = torch.Generator().manual_seed(seed)
    params = {"coarse": init_nerf_mlp(MODEL, generator=gen, device=device),
              "fine": init_nerf_mlp(MODEL, generator=gen, device=device)}
    for x in named_leaves(params).values():
        x.requires_grad_(True)
    return params


class StepClock:
    """Wall milliseconds a step over a loop, the device drained at both
    ends."""

    def __init__(self, device: torch.device):
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def __enter__(self):
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.seconds = time.perf_counter() - self.t0

    def ms_per_step(self, steps: int) -> float:
        return 1e3 * self.seconds / max(steps, 1)


def all_finite(outcome) -> bool:
    """Whether every number in an example's outcome (nested dicts and
    lists; flags and names pass) is finite."""
    if isinstance(outcome, dict):
        return all(all_finite(v) for v in outcome.values())
    if isinstance(outcome, (list, tuple)):
        return all(all_finite(v) for v in outcome)
    return isinstance(outcome, (bool, str)) or bool(np.isfinite(outcome))
