"""LLFF forward-facing dataset loader.

Port of ``scnerf_tpu/data/llff.py``, a copy of that numpy module:
``poses_bounds.npy`` parsing, the axis-convention fix, bounds rescale, pose
recentering, the spherify or spiral render path, the ``llffhold`` split and
the self-calibration noise injection (``data/noise.py``).

Images: PNGs are read by ``core/imaging.read_png`` (the standard library
only), so a scene whose ``images_{factor}/`` holds PNGs (as the published
LLFF scenes ship) loads without ``imageio``; any other format is read with
``imageio``, imported where it is used, and without it the loader raises
and names it. An existing ``images_{factor}/`` is reused untouched.
Building one shells out to ImageMagick's ``mogrify -resize`` (the
reference's own tool) or, without it, uses PIL's Lanczos filter, imported
where it is used.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from scnerf_tpu_torch.core.imaging import read_png
from scnerf_tpu_torch.data.noise import NoiseConfig, inject_pose_noise

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".PNG", ".JPEG")


def _list_images(d: str) -> list[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(_IMG_EXTS)]


def _imread(path: str) -> np.ndarray:
    if path.lower().endswith(".png"):
        return read_png(path)[..., :3] / 255.0
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs imageio, which is not installed; PNGs "
            "(e.g. the scene's images_{factor}/) need nothing") from e
    return np.asarray(imageio.imread(path))[..., :3] / 255.0


def _minify(basedir: str, factor: int) -> str:
    """Create/reuse ``images_{factor}``: ``mogrify -resize {100/factor}%``
    when ImageMagick is available (reference-identical,
    ``load_llff.py:37-56``), else PIL Lanczos."""
    import shutil

    out = os.path.join(basedir, f"images_{factor}")
    src = _list_images(os.path.join(basedir, "images"))
    if os.path.exists(out) and len(_list_images(out)) == len(src):
        return out
    os.makedirs(out, exist_ok=True)
    if shutil.which("mogrify"):
        import subprocess

        for f in src:
            shutil.copy(f, out)
        ext = os.path.splitext(src[0])[1].lstrip(".")
        # the reference's exact invocation: percent resize, png output
        subprocess.check_output(
            ["mogrify", "-resize", f"{100.0 / factor}%", "-format", "png",
             f"*.{ext}"],
            cwd=out,
        )
        if ext.lower() != "png":
            for f in _list_images(out):
                if not f.endswith(".png"):
                    os.remove(f)
        return out
    from PIL import Image

    for f in src:
        img = Image.open(f)
        w, h = img.size
        img = img.resize((w // factor, h // factor), Image.LANCZOS)
        name = os.path.splitext(os.path.basename(f))[0] + ".png"
        img.save(os.path.join(out, name))
    return out


# ---------------------------------------------------------------------------
# Pose geometry: the behaviour of the LLFF pose pipeline the reference
# inherits from Fyusion/LLFF (the reference's NeRF/load_llff.py, cited per
# function), written batched, as in the JAX package.
# ---------------------------------------------------------------------------


def _unit(v, axis=-1):
    """Normalise vectors along ``axis`` (no epsilon — parity with upstream)."""
    v = np.asarray(v, float)
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def camera_frame(forward, up_hint, origin):
    """Right-handed c2w basis looking along ``forward``: columns [x|y|z|t].

    ``x = up_hint × ẑ`` (then unit), ``y = ẑ × x̂`` — i.e. a Gram–Schmidt
    frame where only the direction of ``up_hint`` matters. Batched over any
    leading dims; scalars broadcast. Behavior of ``load_llff.py:viewmatrix``.
    """
    fwd = _unit(np.asarray(forward, float))
    right = _unit(np.cross(up_hint, fwd))
    up = _unit(np.cross(fwd, right))
    origin = np.broadcast_to(np.asarray(origin, float), fwd.shape)
    return np.stack([right, up, fwd, origin], axis=-1)


def average_pose(poses):
    """The capture's mean c2w (3x5 with the hwf column of view 0).

    Origin = centroid of camera centres; viewing axis = renormalised sum of
    per-view z axes; up hint = sum of per-view y axes. Behavior of
    ``load_llff.py:poses_avg``.
    """
    frame = camera_frame(
        poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0), poses[:, :3, 3].mean(0)
    )
    return np.concatenate([frame, poses[0, :3, 4:]], axis=1)


def _to_homogeneous(p34):
    """(..., 3, 4) -> (..., 4, 4) by appending the [0,0,0,1] row."""
    bottom = np.broadcast_to(
        np.array([0.0, 0.0, 0.0, 1.0]), p34.shape[:-2] + (1, 4)
    )
    return np.concatenate([p34, bottom], axis=-2)


def recenter_poses(poses):
    """Rigidly transform all c2w poses so the average pose becomes identity.

    One batched matmul: ``inv(avg) @ poses``. hwf columns pass through.
    Behavior of ``load_llff.py:recenter_poses``.
    """
    avg = _to_homogeneous(average_pose(poses)[:3, :4])
    out = poses.copy()
    out[:, :3, :4] = (np.linalg.inv(avg) @ _to_homogeneous(poses[:, :3, :4]))[:, :3, :4]
    return out


def render_path_spiral(c2w, up, rads, focal, zrate, rots, N):
    """N c2w poses on a spiral around the average pose ``c2w`` (3x5).

    Camera centres trace an ellipse with semi-axes ``rads[:2]`` in the
    average pose's xy-plane plus a sinusoidal depth wobble (``rads[2]``,
    ``zrate`` cycles per revolution); every pose looks at the point ``focal``
    units in front of the average pose. Fully vectorised over the N angles.
    Behavior of ``load_llff.py:render_path_spiral``.
    """
    theta = np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]
    radii = np.append(np.asarray(rads, float), 1.0)
    local = radii * np.stack(
        [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), np.ones_like(theta)], -1
    )  # (N, 4) homogeneous centres in the avg-pose frame
    centers = local @ c2w[:3, :4].T  # (N, 3) world
    lookat = c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0])
    frames = camera_frame(centers - lookat, up, centers)  # (N, 3, 4)
    hwf = np.broadcast_to(c2w[:3, 4:5], frames[:, :3, :1].shape)
    return np.concatenate([frames, hwf], axis=-1)


def spherify_poses(poses, bds):
    """Re-frame an inward-facing (360°) capture onto the unit sphere.

    1. Find the point p* minimising summed squared distance to every
       camera's optical axis: each axis contributes the normal equation
       ``(I - d dᵀ) p = (I - d dᵀ) o`` — solved via the mean of the
       per-view normal matrices (one batched outer product + solve).
    2. Build a world frame at p* whose z is the mean camera-offset
       direction (an arbitrary fixed seed vector resolves the free in-plane
       rotation — kept identical to upstream LLFF for dataset parity) and
       rebase all poses into it.
    3. Scale so the RMS camera distance is exactly 1, scaling ``bds`` along.
    4. Emit a 120-pose circular render path at the cameras' mean height on
       the unit sphere, each pose looking through the origin.

    Behavior of ``load_llff.py:spherify_poses``. Returns
    (rebased 3x5 poses, 120 render poses 3x5, rescaled bds).
    """
    axes = poses[:, :3, 2]  # (N, 3) unit optical axes
    origins = poses[:, :3, 3]  # (N, 3) camera centres
    reject = np.eye(3) - axes[:, :, None] * axes[:, None, :]  # I - d dᵀ, (N,3,3)
    # mean normal matrix / mean rhs: reject is symmetric idempotent so
    # rejectᵀ·reject = reject, but keep the explicit product for exact
    # fp parity with upstream's formulation.
    lhs = np.mean(reject.transpose(0, 2, 1) @ reject, axis=0)
    rhs = np.mean((reject @ origins[:, :, None]), axis=0)[:, 0]
    center = np.linalg.solve(lhs, rhs)

    z_axis = _unit((origins - center).mean(0))
    # Upstream LLFF's arbitrary non-collinear seed; any fixed seed works,
    # this one is kept so converted datasets match the reference exactly.
    x_axis = _unit(np.cross([0.1, 0.2, 0.3], z_axis))
    y_axis = _unit(np.cross(z_axis, x_axis))
    world = np.stack([x_axis, y_axis, z_axis, center], axis=1)  # (3, 4)

    rebased = np.linalg.inv(_to_homogeneous(world[None]))[0] @ _to_homogeneous(
        poses[:, :3, :4]
    )
    scale = 1.0 / np.sqrt(np.square(rebased[:, :3, 3]).sum(-1).mean())
    rebased[:, :3, 3] *= scale
    bds = bds * scale

    # Circle at the mean camera height zh on the (now unit) sphere.
    zh = rebased[:, :3, 3].mean(0)[2]
    radius = np.sqrt(1.0 - zh * zh)
    theta = np.linspace(0.0, 2.0 * np.pi, 120)
    centers = np.stack(
        [radius * np.cos(theta), radius * np.sin(theta), np.full_like(theta, zh)], -1
    )
    fwd = _unit(centers)  # look outward along the centre ray
    right = _unit(np.cross(fwd, [0.0, 0.0, -1.0]))
    up = _unit(np.cross(fwd, right))
    circle = np.stack([right, up, fwd, centers], axis=-1)  # (120, 3, 4)

    hwf = poses[0, :3, 4:]
    circle = np.concatenate(
        [circle, np.broadcast_to(hwf, circle[:, :3, :1].shape)], -1
    )
    rebased = np.concatenate(
        [rebased[:, :3, :4], np.broadcast_to(hwf, rebased[:, :3, :1].shape)], -1
    )
    return rebased, circle, bds


@dataclass
class LLFFData:
    images: np.ndarray  # (N, H, W, 3) float
    noisy_poses: np.ndarray  # (N, 4, 4) train-perturbed c2w
    gt_poses: np.ndarray  # (N, 4, 4)
    bds: np.ndarray  # (N, 2)
    render_poses: np.ndarray  # (R, 3, 5)
    i_train: np.ndarray
    i_test: np.ndarray
    gt_intrinsic: np.ndarray  # (4, 4)
    noisy_focal: float
    H: int = 0
    W: int = 0


def load_llff(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    llffhold: int = 8,
    path_zflat: bool = False,
    noise: NoiseConfig | None = None,
    rng: np.random.RandomState | None = None,
) -> LLFFData:
    """Load an LLFF scene directory (``poses_bounds.npy`` + ``images/``)."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    imgdir = _minify(basedir, factor) if factor > 1 else os.path.join(basedir, "images")
    imgfiles = _list_images(imgdir)
    assert poses.shape[-1] == len(imgfiles), (poses.shape, len(imgfiles))
    imgs = np.stack([_imread(f) for f in imgfiles], 0).astype(np.float32)
    sh = imgs[0].shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    # down-up-right -> right-up-back convention fix (load_llff.py:248).
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc
    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = average_pose(poses)
        up = _unit(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal_path = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        n_rots, n_views = 2, 120
        if path_zflat:
            # flattened spiral (load_llff.py:289-295)
            zloc = -close_depth * 0.1
            c2w[:3, 3] = c2w[:3, 3] + zloc * c2w[:3, 2]
            rads[2] = 0.0
            n_rots, n_views = 1, 60
        render_poses = render_path_spiral(
            c2w, up, rads, focal_path, zrate=0.5, rots=n_rots, N=n_views
        )

    c2w = average_pose(poses)
    if llffhold > 0:
        i_test = np.arange(imgs.shape[0])[::llffhold]
    else:
        dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
        i_test = np.array([np.argmin(dists)])
    i_train = np.array([i for i in range(len(poses)) if i not in i_test])

    H, W = sh[:2]
    focal = float(poses[0, -1, -1])
    gt_poses = np.eye(4)[None].repeat(len(poses), 0).astype(np.float32)
    gt_poses[:, :3, :4] = poses[:, :3, :4]

    noise = noise or NoiseConfig()
    noisy_poses, noisy_focal = inject_pose_noise(
        poses[:, :3, :4], focal, i_train, noise, rng
    )
    gt_K = np.array(
        [[focal, 0, W // 2, 0], [0, focal, H // 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32,
    )
    return LLFFData(
        images=imgs,
        noisy_poses=noisy_poses.astype(np.float32),
        gt_poses=gt_poses,
        bds=bds,
        render_poses=render_poses.astype(np.float32),
        i_train=i_train,
        i_test=i_test,
        gt_intrinsic=gt_K,
        noisy_focal=float(noisy_focal),
        H=H,
        W=W,
    )
