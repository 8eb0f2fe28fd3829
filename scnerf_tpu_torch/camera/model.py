"""The learnable generic camera.

Port of ``scnerf_tpu/camera/model.py``:

- pinhole intrinsics ``[fx, fy, cx, cy]`` = frozen initial + noise
  (optionally multiplicative),
- per-image extrinsics = frozen initial 9-vector (6D rotation + translation)
  + noise, decoded through Gram-Schmidt,
- radial distortion ``(k1, k2)`` = frozen initial + noise,
- ray-origin / ray-direction noise on a coarse ``(H//g, W//g, 3)`` grid,
  interpolated at the requested pixels;
- the logging helpers :func:`camera_log_dict` and :func:`camera_log_images`.

The state is a plain dataclass of tensors; the leaves have the JAX names and
shapes, so ``bridge.py`` copies them one to one. For training,
:func:`trainable_camera` makes the ``*_noise`` and ``*_grid`` leaves require
grad; the ``*_init`` leaves never do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scnerf_tpu_torch.geometry.so3 import (
    embed_rotation_44,
    intrinsic_param_to_K,
    ortho2rotation,
    rotation2orth,
)

OPENGL = "opengl"  # NeRF convention: K^-1 [x,y,1], then negate y and z
OPENCV = "opencv"  # NeRF++ convention: K^-1 [u+.5, v+.5, 1], no flips

CAMERA_LEAVES = (
    "intrinsics_init", "extrinsics_init", "distortion_init",
    "intrinsics_noise", "extrinsics_noise", "distortion_noise",
    "ray_o_grid", "ray_d_grid",
)
FROZEN_LEAVES = CAMERA_LEAVES[:3]
TRAINABLE_LEAVES = CAMERA_LEAVES[3:]


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    H: int = 0
    W: int = 0
    grid_size: int = 10
    convention: str = OPENGL
    use_distortion: bool = False
    multiplicative_noise: bool = False
    ray_o_noise_scale: float = 1e-3
    ray_d_noise_scale: float = 1e-3
    intrinsics_noise_scale: float = 1.0
    extrinsics_noise_scale: float = 1e-2
    distortion_noise_scale: float = 1e-2
    # Pixel-center offset added before K^-1 (0.0 for NeRF, 0.5 for NeRF++).
    pixel_offset: float = 0.0
    # Both ray paths read the sum of the two grids, each taking gradients
    # only into its own (see the JAX CameraConfig for why).
    tied_ray_noise: bool = False


@dataclasses.dataclass
class Camera:
    """Learnable camera state. ``*_noise`` and ``*_grid`` are the trainable
    leaves; ``*_init`` are frozen."""

    config: CameraConfig
    intrinsics_init: torch.Tensor  # (4,)  fx fy cx cy
    extrinsics_init: torch.Tensor  # (N, 9) 6D rot + t
    distortion_init: torch.Tensor  # (2,)  k1 k2
    intrinsics_noise: torch.Tensor  # (4,)
    extrinsics_noise: torch.Tensor  # (N, 9)
    distortion_noise: torch.Tensor  # (2,)
    ray_o_grid: torch.Tensor  # (H//g, W//g, 3)
    ray_d_grid: torch.Tensor  # (H//g, W//g, 3)

    @property
    def device(self) -> torch.device:
        return self.intrinsics_init.device


def init_camera(
    intrinsics: np.ndarray,
    extrinsics: np.ndarray,
    config: CameraConfig,
    k: np.ndarray | None = None,
    *,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Camera:
    """Build a :class:`Camera` from initial K (3x3/4x4) and c2w poses (N,4,4).

    Extrinsics are stored as [6D-rotation | translation]; all noises zero.
    """
    intrinsics = np.asarray(intrinsics)
    extrinsics = np.asarray(extrinsics)
    fx, fy, cx, cy = (intrinsics[0, 0], intrinsics[1, 1],
                      intrinsics[0, 2], intrinsics[1, 2])
    # The JAX package runs rotation2orth in float32 before storing.
    rot6 = rotation2orth(torch.as_tensor(extrinsics[:, :3, :3], dtype=torch.float32))
    ext9 = np.concatenate([rot6.numpy(), extrinsics[:, :3, 3]], axis=-1)
    gh = max(config.H // config.grid_size, 1)
    gw = max(config.W // config.grid_size, 1)
    n = extrinsics.shape[0]
    if k is None:
        k = np.zeros((2,), dtype=np.float32)

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Camera(
        config=config,
        intrinsics_init=tensor([fx, fy, cx, cy]),
        extrinsics_init=tensor(ext9),
        distortion_init=tensor(k),
        intrinsics_noise=zeros(4),
        extrinsics_noise=zeros(n, 9),
        distortion_noise=zeros(2),
        ray_o_grid=zeros(gh, gw, 3),
        ray_d_grid=zeros(gh, gw, 3),
    )


def camera_leaves(camera: Camera) -> dict[str, torch.Tensor]:
    """The camera's tensors by JAX leaf name, in :data:`CAMERA_LEAVES`
    order."""
    return {name: getattr(camera, name) for name in CAMERA_LEAVES}


def host_camera(camera: Camera) -> Camera:
    """A detached copy of ``camera`` on the CPU."""
    return dataclasses.replace(camera, **{
        name: x.detach().cpu() for name, x in camera_leaves(camera).items()})


def trainable_camera(camera: Camera) -> Camera:
    """A copy of ``camera`` to train: the ``*_noise`` and ``*_grid`` leaves
    are new leaf tensors that require grad, the ``*_init`` leaves copies that
    do not."""
    return dataclasses.replace(camera, **{
        name: x.detach().clone().requires_grad_(name in TRAINABLE_LEAVES)
        for name, x in camera_leaves(camera).items()})


def get_intrinsic(camera: Camera) -> torch.Tensor:
    """Current 4x4 K."""
    cfg = camera.config
    noise = camera.intrinsics_noise * cfg.intrinsics_noise_scale
    if cfg.multiplicative_noise:
        noise = noise * camera.intrinsics_init
    return intrinsic_param_to_K(camera.intrinsics_init + noise)


def _decode_extrinsics(vec: torch.Tensor) -> torch.Tensor:
    E = embed_rotation_44(ortho2rotation(vec[..., :6]))
    E[..., :3, 3] = vec[..., 6:]
    return E


def get_extrinsics(camera: Camera) -> torch.Tensor:
    """Current (N, 4, 4) c2w extrinsics."""
    cfg = camera.config
    return _decode_extrinsics(
        camera.extrinsics_init + cfg.extrinsics_noise_scale * camera.extrinsics_noise)


def take_rows(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[idx]`` for an int or an index tensor. A tensor goes through
    ``index_select``: its backward is one ``index_add`` (a plain ``x[t]``'s
    is a sort-based ``index_put``, dozens of launches), and a 0-d tensor is
    not read back to the host."""
    if not isinstance(idx, torch.Tensor):
        return x[idx]
    rows = x.index_select(0, idx.reshape(-1).to(device=x.device, dtype=torch.long))
    return rows.reshape(*idx.shape, *x.shape[1:])


def get_extrinsic(camera: Camera, idx) -> torch.Tensor:
    """Single (or gathered) c2w extrinsic(s) for image index/indices ``idx``."""
    cfg = camera.config
    return _decode_extrinsics(
        take_rows(camera.extrinsics_init, idx)
        + cfg.extrinsics_noise_scale * take_rows(camera.extrinsics_noise, idx))


def get_distortion(camera: Camera) -> torch.Tensor:
    """Current (k1, k2)."""
    return (camera.distortion_init
            + camera.distortion_noise * camera.config.distortion_noise_scale)


def sample_noise_grid(grid: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                      H: int, W: int) -> torch.Tensor:
    """Bilinearly sample a coarse ``(Gh, Gw, C)`` grid at pixels ``(px, py)``.

    Equal, at pixel centers, to upsampling the grid to ``(H, W)`` with
    ``F.interpolate(mode="bilinear", align_corners=False)`` and indexing, at
    O(#pixels) cost. The formula is written out (not ``F.grid_sample``, whose
    border rules differ): negative source coordinates clamp to 0.

    Returns ``(M, C)``.
    """
    gh, gw = grid.shape[0], grid.shape[1]
    sy = torch.clamp((py.to(torch.float32) + 0.5) * (gh / H) - 0.5, min=0.0)
    sx = torch.clamp((px.to(torch.float32) + 0.5) * (gw / W) - 0.5, min=0.0)
    y0f = torch.floor(sy)
    x0f = torch.floor(sx)
    wy = (sy - y0f)[..., None]
    wx = (sx - x0f)[..., None]
    y0 = torch.clamp(y0f.long(), 0, gh - 1)
    x0 = torch.clamp(x0f.long(), 0, gw - 1)
    y1 = torch.clamp(y0 + 1, max=gh - 1)
    x1 = torch.clamp(x0 + 1, max=gw - 1)
    flat = grid.reshape(gh * gw, grid.shape[-1])

    def at(y, x):
        return take_rows(flat, y * gw + x)

    top = at(y0, x0) * (1.0 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1.0 - wx) + at(y1, x1) * wx
    return top * (1.0 - wy) + bot * wy


def ray_o_noise_at(camera: Camera, px, py) -> torch.Tensor:
    cfg = camera.config
    grid = camera.ray_o_grid
    if cfg.tied_ray_noise:
        grid = grid + camera.ray_d_grid.detach()
    return sample_noise_grid(grid, px, py, cfg.H, cfg.W) * cfg.ray_o_noise_scale


def ray_d_noise_at(camera: Camera, px, py) -> torch.Tensor:
    cfg = camera.config
    grid = camera.ray_d_grid
    if cfg.tied_ray_noise:
        grid = camera.ray_o_grid.detach() + grid
    return sample_noise_grid(grid, px, py, cfg.H, cfg.W) * cfg.ray_d_noise_scale


# --------------------------------------------------------------------------
# Logging (the reference's CameraModel.log_noises, camera_model.py:54-117)
# --------------------------------------------------------------------------

def camera_log_images(camera: Camera) -> dict:
    """Image summaries of the reference's ``log_noises`` dashboard: the
    rayo/rayd noise grids as min-max-normalized RGB and, for distortion
    cameras, the radial warp magnitude field. numpy ``(h, w, 3)`` each;
    reads the device."""
    def normalize(g):
        g = np.asarray(g, np.float32)
        lo, hi = g.min(), g.max()
        return (g - lo) / (hi - lo) if hi > lo else np.zeros_like(g)

    o_grid, d_grid = camera.ray_o_grid.detach(), camera.ray_d_grid.detach()
    if camera.config.tied_ray_noise:
        o_grid = d_grid = o_grid + d_grid  # the shared effective value
    out = {
        "camera/ray_o_noise": normalize(o_grid.cpu().numpy()),
        "camera/ray_d_noise": normalize(d_grid.cpu().numpy()),
    }
    if camera.config.use_distortion:
        from scnerf_tpu_torch.tools.visualize import radial_distortion_field

        k = get_distortion(camera).detach().cpu().numpy()
        field = normalize(radial_distortion_field(
            k, max(camera.config.H, 2), max(camera.config.W, 2)))
        out["camera/radial_field"] = np.repeat(field[..., None], 3, axis=-1)
    return out


@torch.no_grad()
def camera_log_dict(camera: Camera, gt_K=None, gt_E=None) -> dict:
    """Scalar diagnostics of the reference's dashboard, as 0-d tensors on
    the camera's device (the logger reads them)."""
    K = get_intrinsic(camera)
    out = {
        "camera/fx": K[0, 0],
        "camera/fy": K[1, 1],
        "camera/cx": K[0, 2],
        "camera/cy": K[1, 2],
    }
    if gt_K is not None:
        gt_K = torch.as_tensor(gt_K, dtype=K.dtype, device=K.device)
        out["camera/fx_err"] = torch.abs(K[0, 0] - gt_K[0, 0])
        out["camera/fy_err"] = torch.abs(K[1, 1] - gt_K[1, 1])
        out["camera/cx_err"] = torch.abs(K[0, 2] - gt_K[0, 2])
        out["camera/cy_err"] = torch.abs(K[1, 2] - gt_K[1, 2])
    E = get_extrinsics(camera)
    out["camera/extrinsic_noise_mean"] = torch.mean(torch.abs(E))
    # ddof 0, as jnp.std
    out["camera/extrinsic_noise_std"] = torch.std(torch.abs(E), correction=0)
    if gt_E is not None:
        gt_E = torch.as_tensor(gt_E, dtype=E.dtype, device=E.device)
        out["camera/extrinsic_err"] = torch.mean(torch.abs(E - gt_E))
    cfg = camera.config
    out["camera/ray_o_noise_mean"] = torch.mean(torch.abs(camera.ray_o_grid)) * cfg.ray_o_noise_scale
    out["camera/ray_d_noise_mean"] = torch.mean(torch.abs(camera.ray_d_grid)) * cfg.ray_d_noise_scale
    if cfg.use_distortion:
        k = get_distortion(camera)
        out["camera/k1"] = k[0]
        out["camera/k2"] = k[1]
    return out
