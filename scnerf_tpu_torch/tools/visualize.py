"""Camera / calibration visualizers.

Port of ``scnerf_tpu/tools/visualize.py``, the rebuild of the reference's
debugging figures without the open3d dependency
(not in this image): matplotlib versions of

- camera frustum plots (``nerfplusplus/camera_visualizer/visualize_cameras.py``),
- epipolar-line inspection (``nerfplusplus/camera_inspector/
  inspect_epipolar_geometry.py``),
- the learned radial-distortion field image (``model/visualize_radial.py``),
- ray point clouds (``src/visualization.py``).

All functions return numpy images / write files. The plots import
``matplotlib`` where they draw, and raise ``ImportError`` without it.
"""
from __future__ import annotations

import numpy as np


def frustum_corners(K: np.ndarray, c2w: np.ndarray, W: int, H: int, depth: float = 0.3):
    """World-space corners of an image plane at ``depth`` (5 points: center +
    4 corners) for wireframe plotting."""
    Kinv = np.linalg.inv(K[:3, :3])
    corners_px = np.array([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], np.float64)
    rays = corners_px @ Kinv.T * depth
    world = rays @ c2w[:3, :3].T + c2w[:3, 3]
    return np.concatenate([c2w[:3, 3][None], world], axis=0)


def plot_cameras(
    poses: np.ndarray,
    K: np.ndarray,
    W: int,
    H: int,
    out_path: str | None = None,
    unit_sphere: bool = False,
    second_set: np.ndarray | None = None,
):
    """3D frustum wireframes (optionally two pose sets, e.g. GT vs learned)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")

    def draw(ps, color):
        for c2w in ps:
            pts = frustum_corners(K, c2w, W, H)
            for i in range(1, 5):
                ax.plot(*zip(pts[0], pts[i]), color=color, lw=0.6)
            loop = [1, 2, 3, 4, 1]
            ax.plot(pts[loop, 0], pts[loop, 1], pts[loop, 2], color=color, lw=0.6)

    draw(poses, "tab:blue")
    if second_set is not None:
        draw(second_set, "tab:red")
    if unit_sphere:
        u, v = np.mgrid[0 : 2 * np.pi : 24j, 0 : np.pi : 12j]
        ax.plot_wireframe(
            np.cos(u) * np.sin(v), np.sin(u) * np.sin(v), np.cos(v),
            color="gray", alpha=0.2, lw=0.3,
        )
    ax.set_box_aspect((1, 1, 1))
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def epipolar_lines(F: np.ndarray, pts0: np.ndarray, img1_shape) -> np.ndarray:
    """Lines ``l = F @ [x, y, 1]`` in image 1 for points in image 0, as
    (N, 2, 2) segment endpoints clipped to the image border."""
    H, W = img1_shape[:2]
    ph = np.concatenate([pts0, np.ones((len(pts0), 1))], axis=1)
    lines = ph @ F.T  # (N, 3): ax + by + c = 0
    segs = []
    for a, b, c in lines:
        if abs(b) > 1e-9:
            p0 = (0.0, -c / b)
            p1 = (W - 1.0, -(c + a * (W - 1)) / b)
        else:
            p0 = (-c / max(a, 1e-9), 0.0)
            p1 = (-c / max(a, 1e-9), H - 1.0)
        segs.append([p0, p1])
    return np.asarray(segs)


def inspect_epipolar_geometry(img0, img1, F, pts0, out_path=None):
    """Side-by-side figure: clicked points in image 0, epipolar lines in 1."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (a0, a1) = plt.subplots(1, 2, figsize=(12, 5))
    a0.imshow(img0)
    a0.scatter(pts0[:, 0], pts0[:, 1], c="r", s=12)
    a1.imshow(img1)
    for (p0, p1) in epipolar_lines(F, pts0, img1.shape):
        a1.plot([p0[0], p1[0]], [p0[1], p1[1]], "g-", lw=0.8)
    for a in (a0, a1):
        a.set_axis_off()
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def radial_distortion_field(k: np.ndarray, H: int, W: int, cx=None, cy=None) -> np.ndarray:
    """Per-pixel displacement magnitude of the learned radial model
    (``model/visualize_radial.py``): returns an (H, W) float field."""
    cx = W / 2 if cx is None else cx
    cy = H / 2 if cy is None else cy
    py, px = np.mgrid[0:H, 0:W].astype(np.float64)
    rx = (px - cx) / cx
    ry = (py - cy) / cy
    dx = (px - cx) * (rx**2 * k[0] + rx**4 * k[1])
    dy = (py - cy) * (ry**2 * k[0] + ry**4 * k[1])
    return np.sqrt(dx**2 + dy**2)


def rays_to_pointcloud(rays_o: np.ndarray, rays_d: np.ndarray, t_vals) -> np.ndarray:
    """Sample points along rays -> (N*T, 3) cloud (``src/visualization.py``)."""
    t = np.asarray(t_vals).reshape(1, -1, 1)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t
    return pts.reshape(-1, 3)


def visualize_matches(img0, img1, kps0, kps1, max_draw: int = 100, out_path=None):
    """Side-by-side correspondence visualization (rebuild of the reference's
    ``unit_test_matches`` debug dump, ``model/prd_evaluation.py:21-63``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h0, w0 = img0.shape[:2]
    h1, w1 = img1.shape[:2]
    canvas = np.ones((max(h0, h1), w0 + w1, 3), dtype=np.float64)
    canvas[:h0, :w0] = img0[..., :3]
    canvas[:h1, w0:] = img1[..., :3]
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.imshow(canvas)
    n = min(max_draw, len(kps0))
    for k in range(n):
        ax.plot(
            [kps0[k, 0], kps1[k, 0] + w0], [kps0[k, 1], kps1[k, 1]],
            "-", lw=0.5, alpha=0.7,
        )
    ax.scatter(kps0[:n, 0], kps0[:n, 1], c="lime", s=4)
    ax.scatter(kps1[:n, 0] + w0, kps1[:n, 1], c="lime", s=4)
    ax.set_axis_off()
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img
