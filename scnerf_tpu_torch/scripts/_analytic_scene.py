"""Geometrically consistent analytic test scenes for the quality soaks.

Port of ``scripts/_analytic_scene.py``. Renders ground-truth images of an
analytic emission/absorption field (three Gaussian blobs) through the same
ray paths the trainers use, so a model that converges can reach a high
held-out PSNR:

- :func:`build_blender_scene`: the blender layout (``transforms_*.json``
  and RGBA PNGs, black background) for the NeRF pipeline, rays by
  ``rays_no_camera`` (the train path without a camera model);
- :func:`build_nerfpp_scene`: the NeRF++ split layout through
  ``tools/colmap.write_nerfpp_split``, rays by the OpenCV
  ``pixel + 0.5 -> K^-1`` path, with the radial warp of
  ``camera/rays.apply_radial_distortion`` when ``dist_k`` is given.

The renders run on ``device`` (the card unless asked otherwise) through
the port's ``stratified_z_vals`` and ``raw2outputs`` in full float32; the
PNGs are written by ``core/imaging.write_png``. Stored as 8-bit PNGs, the
images cap PSNR near 48 dB.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from scnerf_tpu_torch.camera.rays import apply_radial_distortion, full_image_pixels, rays_no_camera
from scnerf_tpu_torch.core.imaging import write_png
from scnerf_tpu_torch.data.blender import pose_spherical
from scnerf_tpu_torch.geometry.so3 import K_inverse_3x3
from scnerf_tpu_torch.render.composite import raw2outputs
from scnerf_tpu_torch.sampling.stratified import stratified_z_vals
from scnerf_tpu_torch.serve import fp32_inference
from scnerf_tpu_torch.tools.colmap import write_nerfpp_split

# The field's centres, widths, densities and colour logits. Geometry scaled
# by ``s`` needs widths * s^2 (squared distances) and sigma / s (the same
# optical depth along paths s times shorter).
_CENTERS = np.array([[0.5, 0.2, -0.1], [-0.6, -0.3, 0.3], [0.0, 0.6, 0.5]])
_WIDTHS = np.array([0.08, 0.10, 0.05])
_SIGMA = np.array([40.0, 35.0, 30.0])
_COLORS = np.array([[4.0, -4.0, -4.0], [-4.0, 4.0, -4.0], [-4.0, -4.0, 4.0]])


def field(pts: torch.Tensor, scale: float = 1.0, texture: bool = False) -> torch.Tensor:
    """Raw ``[rgb_logits, sigma]`` ``(..., 4)`` of the analytic scene at
    ``pts`` ``(..., 3)``.

    ``texture``: modulate the blob albedo with an aperiodic sum of eight
    seeded plane waves (15-45 cycles per unit), 3D-consistent and well
    inside the positional encoding's band, so that a corner detector finds
    distinctive keypoints on it."""
    sigma = rgb = gsum = 0.0
    for c, w, s, col in zip(_CENTERS, _WIDTHS, _SIGMA, _COLORS):
        center = torch.as_tensor(c * scale, dtype=pts.dtype, device=pts.device)
        d2 = torch.sum((pts - center) ** 2, dim=-1)
        g = torch.exp(-d2 / (w * scale * scale))
        sigma = sigma + (s / scale) * g
        rgb = rgb + g[..., None] * torch.as_tensor(col, dtype=pts.dtype, device=pts.device)
        gsum = gsum + g
    if texture:
        rngt = np.random.RandomState(11)
        kvecs = rngt.randn(8, 3)
        kvecs *= (rngt.uniform(15.0, 45.0, (8, 1))
                  / np.linalg.norm(kvecs, axis=1, keepdims=True)) / scale
        phases = rngt.uniform(0, 2 * np.pi, 8)
        m = 0.0
        for kv, ph in zip(kvecs, phases):
            m = m + torch.sin(pts[..., 0] * kv[0] + pts[..., 1] * kv[1]
                              + pts[..., 2] * kv[2] + ph)
        rgb = rgb + (gsum * m * 2.0)[..., None]
    return torch.cat([rgb, sigma[..., None]], dim=-1)


def render_gt_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float, far: float,
                   n_samples: int = 192, scale: float = 1.0,
                   texture: bool = False) -> torch.Tensor:
    """Ground-truth volume render ``(N, 3)`` of the analytic field along
    the rays ``(N, 3)``: ``n_samples`` evenly spaced depths, no noise."""
    n = rays_o.shape[0]
    z = stratified_z_vals(None, torch.full((n,), float(near), device=rays_o.device),
                          torch.full((n,), float(far), device=rays_o.device), n_samples,
                          perturb=False)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    return raw2outputs(field(pts, scale, texture=texture), z, rays_d, white_bkgd=False)["rgb"]


def build_blender_scene(root: str, n_train: int = 12, n_val: int = 2,
                        n_test: int = 2, H: int = 120, W: int = 160,
                        camera_angle_x: float = 0.69, radius: float = 4.0, *,
                        device: torch.device | str = "cuda") -> dict[str, np.ndarray]:
    """Write the blender layout of the analytic scene (black background)
    into ``root`` and return each split's float renders ``(n, H, W, 3)``
    before their 8-bit rounding.

    Views sit on a radius-``radius`` orbit with the elevation varied over
    [-45, -15] degrees so that the pose set is well conditioned for
    calibration; val and test angles interleave the train ones. Rendered on
    ``device`` through ``rays_no_camera`` in ``[radius - 2, radius + 2]``."""
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    def render_view(c2w):
        with fp32_inference():
            c2w = torch.as_tensor(c2w[:3, :4], dtype=torch.float32, device=device)
            px, py = full_image_pixels(H, W, device=device)
            o, d = rays_no_camera(H, W, focal, c2w, px, py)
            rgb = render_gt_rays(o, d, radius - 2.0, radius + 2.0)
        return rgb.reshape(H, W, 3).cpu().numpy()

    splits = {
        "train": [(360.0 * i / n_train, -30.0 + 15.0 * np.sin(4 * np.pi * i / n_train))
                  for i in range(n_train)],
        "val": [(360.0 * (i + 0.5) / n_val, -25.0) for i in range(n_val)],
        "test": [(360.0 * (i + 0.25) / n_test, -35.0) for i in range(n_test)],
    }
    renders = {}
    for split, angles in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames, views = [], []
        for i, (theta, phi) in enumerate(angles):
            pose = np.array(pose_spherical(theta, phi, radius))
            rgb = render_view(pose)
            rgba = np.concatenate([np.clip(rgb, 0.0, 1.0), np.ones((H, W, 1))], -1)
            write_png(os.path.join(root, split, f"r_{i}.png"),
                      (rgba * 255.0).round().astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": pose.tolist()})
            views.append(rgb)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
        renders[split] = np.stack(views)
    return renders


def _look_at_c2w_opencv(pos: np.ndarray) -> np.ndarray:
    """OpenCV-convention c2w looking at the origin: z forward, y down."""
    z = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
    return c2w


def build_nerfpp_scene(datadir: str, n_train: int = 8, n_val: int = 2,
                       H: int = 120, W: int = 160,
                       dist_k: tuple | None = None,
                       scale: float = 0.2, cam_radius: float = 0.7,
                       focal_scale: float = 0.9,
                       texture: bool = False, *,
                       device: torch.device | str = "cuda") -> str:
    """Write the NeRF++ split layout of the analytic scene under
    ``datadir`` and return the scene's directory.

    Cameras ring the origin at radius ``cam_radius`` (inside the unit
    foreground sphere) with a slight elevation wobble; the field is the blob
    scene scaled by ``scale``. The GT rays follow the OpenCV path of
    ``camera/rays.py:pixels_to_rays``: ``u = px + 0.5``, the radial warp
    when ``dist_k`` is given, ``K^-1``, the rotation. A ``focal_scale``
    below 0.9 widens the field of view so that content reaches a high
    normalised radius, where the radial terms move it by whole pixels."""
    focal = focal_scale * W
    K = np.eye(4)
    K[0, 0], K[1, 1] = focal, focal
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    near = max(cam_radius - 2.5 * scale, 0.05)
    far = cam_radius + 2.5 * scale

    def render_view(c2w):
        with fp32_inference():
            c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
            px, py = full_image_pixels(H, W, device=device)
            u, v = px + 0.5, py + 0.5
            if dist_k is not None:
                u, v = apply_radial_distortion(u, v, K[0, 2], K[1, 2], dist_k[0], dist_k[1])
            pix = torch.stack([u, v, torch.ones_like(u)], -1)
            K_inv = K_inverse_3x3(torch.as_tensor(K, dtype=torch.float32, device=device))
            rays_d = pix @ K_inv.T @ c2w[:3, :3].T
            rays_o = c2w[:3, 3].expand(rays_d.shape)
            rgb = render_gt_rays(rays_o, rays_d, near, far, scale=scale, texture=texture)
        return rgb.reshape(H, W, 3).cpu().numpy()

    img_dir = os.path.join(datadir, "_src_images")
    os.makedirs(img_dir, exist_ok=True)
    scene_dir = os.path.join(datadir, "scene")

    def cam_pos(i, n_total):
        ang = 2 * np.pi * i / max(n_total, 3)
        return cam_radius * np.array([np.cos(ang), np.sin(ang), 0.35 + 0.1 * np.sin(2 * ang)])

    n_total = n_train + n_val
    for split, ids in (("train", range(n_train)), ("validation", range(n_train, n_total))):
        cam_dict = {}
        for i in ids:
            name = f"im_{i:02d}.png"
            c2w = _look_at_c2w_opencv(cam_pos(i + 0.5 * (i >= n_train), n_total))
            rgb = render_view(c2w)
            write_png(os.path.join(img_dir, name),
                      (np.clip(rgb, 0.0, 1.0) * 255.0).round().astype(np.uint8))
            cam_dict[name] = {"K": K.reshape(-1).tolist(),
                              "W2C": np.linalg.inv(c2w).reshape(-1).tolist(),
                              "img_size": [W, H]}
            if dist_k is not None:
                cam_dict[name]["k"] = list(dist_k)
        write_nerfpp_split(cam_dict, scene_dir, split=split, image_src_dir=img_dir)
    return scene_dir
