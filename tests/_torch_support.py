"""Support for the port's test modules (``tests/test_torch_*.py``).

- :func:`hang_watchdog`, an autouse fixture each of those modules imports.
  If one test runs longer than ``TEST_TIMEOUT_S``, ``faulthandler`` prints
  every thread's stack to the worker's own stderr (copied once with
  pytest's capture suspended, so the dump reaches the terminal or log
  instead of the test's captured output) and ends the process. Under
  pytest-xdist the controller then reports ``worker 'gwN' crashed while
  running '<test id>'`` and goes on with the rest of the run, so a stuck
  test shows up by name as one failure instead of stalling the whole run
  until an outer time limit cuts it. No port test takes more than a few
  seconds alone.
- :func:`interpret`, the one way these modules run a JAX function that
  reaches a Pallas TPU kernel.
- :func:`jax_prd_distances_in_float64`, the JAX PRD evaluation with its
  distances in float64, as the port computes them.
- The train-step parity helpers shared by ``test_torch_train_step.py`` and
  ``test_torch_nerfpp_train.py``: batches as JAX arrays and as tensors
  (:func:`to_jax`, :func:`to_port`), the two gradient captures
  (:func:`gradient_tx`, :class:`GradientCapture`) and
  :func:`assert_gradients_close`.
- Seeded scenes for the driver tests, written by the port's ``write_png``:
  LLFF (:func:`write_llff_scene`), NeRF++ splits
  (:func:`write_nerfpp_scene`, with :func:`project_opencv` for matches) and
  blender (:func:`write_blender_scene`); and a reference ``.tar``
  checkpoint (:func:`write_reference_tar`).
"""
from __future__ import annotations

import faulthandler
import os
import sys

import numpy as np
import pytest

TEST_TIMEOUT_S = 300

_stderr = []


def _worker_stderr(config):
    if not _stderr:
        capman = config.pluginmanager.getplugin("capturemanager")
        if capman is None:
            _stderr.append(sys.stderr)
        else:
            with capman.global_and_fixture_disabled():
                _stderr.append(os.fdopen(os.dup(2), "w"))
    return _stderr[0]


@pytest.fixture(autouse=True)
def hang_watchdog(request):
    faulthandler.dump_traceback_later(TEST_TIMEOUT_S, exit=True,
                                      file=_worker_stderr(request.config))
    yield
    faulthandler.cancel_dump_traceback_later()


def interpret(fn):
    """``fn()``, JAX code that reaches a Pallas TPU kernel, run in TPU
    interpret mode as one jitted computation and waited for.

    Interpret mode runs the kernel through ordered ``io_callback``s, and
    those callbacks dispatch small JAX operations of their own
    (``jax/_src/pallas/mosaic/interpret/shared_memory.py:
    update_clocks_for_device_barrier`` multiplies a device id that arrives
    as a JAX array). JAX dispatches asynchronously: called eagerly, a
    function such as the NeRF++ renderer goes on dispatching operations on
    the kernel's output while the kernel's computation is still running.
    Now and then the two dispatches block each other for good: the hang
    caught had the test's thread inside the dispatch of a ``concatenate``
    on the renderer's samples and a callback thread inside its own
    multiply, both waiting. One jitted computation, waited for at once,
    leaves the test's thread nothing to dispatch while the callbacks run.
    """
    import jax
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return jax.block_until_ready(jax.jit(fn)())


def jax_prd_distances_in_float64(monkeypatch):
    """Make ``scnerf_tpu.losses.prd_eval.prd_evaluation`` compute its
    distances in float64 from its float32 rays and inputs, as the port's
    ``prd_evaluation`` does: its
    ``prd_loss`` and ``filter_matches_with_gt`` take their array arguments
    cast to float64 and run under ``jax.enable_x64``. The JAX package is
    not edited; the patch ends with the test."""
    import jax
    import jax.numpy as jnp

    from scnerf_tpu.losses import prd_eval

    def in_float64(fn):
        def cast(x):
            if isinstance(x, tuple):
                return tuple(cast(v) for v in x)
            return jnp.asarray(x, jnp.float64) if getattr(x, "dtype", None) == np.float32 else x

        def run(*args, **kwargs):
            with jax.enable_x64(True):
                return fn(*(cast(a) for a in args), **{k: cast(v) for k, v in kwargs.items()})
        return run

    monkeypatch.setattr(prd_eval, "prd_loss", in_float64(prd_eval.prd_loss))
    monkeypatch.setattr(prd_eval, "filter_matches_with_gt",
                        in_float64(prd_eval.filter_matches_with_gt))


def to_jax(batch):
    """Nested dicts/lists/tuples of numpy values -> JAX arrays, float64 as
    float32."""
    import jax.numpy as jnp

    if isinstance(batch, dict):
        return {k: to_jax(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_jax(v) for v in batch)
    v = np.asarray(batch)
    return jnp.asarray(v.astype(np.float32) if v.dtype == np.float64 else v)


def to_port(batch, device="cpu"):
    """Nested dicts/lists/tuples of numpy values -> tensors, float64 as
    float32."""
    import torch

    if isinstance(batch, dict):
        return {k: to_port(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_port(v, device) for v in batch)
    v = np.asarray(batch)
    return torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v).to(device)


def gradient_tx():
    """An optax transformation that moves nothing and keeps the gradients it
    is given (after the step's masks) as its state. (``optax.sgd(1.0)``'s
    delta ``p - (p - g)`` would lose the low bits of ``g`` where ``|g| <<
    |p|``.)"""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


class GradientCapture:
    """The port's counterpart of :func:`gradient_tx`: an optimizer that
    moves nothing and keeps the gradients the step hands it."""

    def init(self, params):
        from scnerf_tpu_torch.train.optim import OptState

        return OptState(count=0, mu={}, nu={})

    def update(self, grads, state, params):
        self.grads = {k: None if g is None else g.detach().clone() for k, g in grads.items()}
        state.count += 1
        return {}


def assert_gradients_close(t_grads, j_grads, rel_l2=1e-4, cosine=0.9999):
    """Per leaf: finite, and a relative L2 error <= ``rel_l2`` and a cosine
    >= ``cosine`` against JAX's (a missing port gradient counts as zeros;
    a zero JAX gradient must be zero here)."""
    assert set(t_grads) == set(j_grads)
    for path, want in j_grads.items():
        got = t_grads[path]
        got = np.zeros_like(want) if got is None else got.numpy()
        assert np.isfinite(got).all(), path
        norm = np.linalg.norm(want)
        if norm == 0.0:
            assert not np.abs(got).any(), path
            continue
        rel = np.linalg.norm(got - want) / norm
        cos = float((got * want).sum() / (np.linalg.norm(got) * norm))
        assert rel <= rel_l2 and cos >= cosine, (path, rel, cos)


def smooth_texture(rng, H, W, n_waves=4):
    """An (H, W, 3) float image in [0.05, 0.95]: a sum of ``n_waves`` seeded
    sinusoids per channel (smooth, so SSIM lies strictly between 0 and 1)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.zeros((H, W, 3))
    for c in range(3):
        for _ in range(n_waves):
            fx, fy = rng.uniform(0.5, 3.0, 2) * 2 * np.pi / np.array([W, H])
            img[..., c] += np.sin(fx * xx + fy * yy + rng.uniform(0, 2 * np.pi))
    return 0.5 + 0.45 * img / n_waves


def write_llff_scene(root, n_views=8, H=24, W=32, factor=8, seed=0, focal_full=260.0):
    """A seeded forward-facing LLFF scene: ``poses_bounds.npy`` (the hwf
    column at the full size, ``factor`` times ``(H, W)``) and ``n_views``
    ``(H, W)`` PNGs of smooth textures in both ``images/`` and
    ``images_{factor}/`` (the loader reads the latter), written by the
    port's ``write_png``. Cameras on a small patch of the plane z = 0
    looking down -z with a few degrees of rotation each."""
    from scnerf_tpu_torch.core.imaging import to8b, write_png

    rng = np.random.RandomState(seed)
    root = str(root)
    os.makedirs(root, exist_ok=True)
    rows = []
    for i in range(n_views):
        ang = np.deg2rad(rng.uniform(-3, 3, 3))
        cx, cy, cz = np.cos(ang)
        sx, sy, sz = np.sin(ang)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        R = Rz @ Ry @ Rx  # columns: right, up, back (OpenGL)
        t = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.4, 0.4), rng.uniform(-0.1, 0.1)])
        # LLFF stores [down, right, back, t, hwf]: the loader maps it to
        # [right, up, back].
        stored = np.stack([-R[:, 1], R[:, 0], R[:, 2], t,
                           [H * factor, W * factor, focal_full]], axis=1)
        rows.append(np.concatenate([stored.reshape(-1), [2.0, 12.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.asarray(rows))
    for i in range(n_views):
        img = to8b(smooth_texture(rng, H, W))
        for sub in ("images", f"images_{factor}"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            write_png(os.path.join(root, sub, f"img_{i:03d}.png"), img)
    return root


def look_at_opencv(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0)):
    """An OpenCV c2w (x right, y down, z forward) at ``eye`` looking at
    ``target``."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    c2w[:3, 3] = eye
    return c2w


def nerfpp_poses(n, seed=0, radius=0.5, arc=0.6):
    """``n`` OpenCV cameras on an ``arc`` (radians) of a ring of ``radius``
    (inside the unit sphere) around the origin, looking at it from a little
    above; neighbours are well within the 30-degree pairing angle."""
    rng = np.random.RandomState(seed)
    angles = np.linspace(-arc / 2, arc / 2, n) + rng.uniform(-0.1, 0.1)
    return np.stack([look_at_opencv([radius * np.cos(a), -0.1, radius * np.sin(a)])
                     for a in angles])


def project_opencv(pts, c2w, K):
    """Keypoints of world points in an OpenCV camera, in the convention of
    the NeRF++ matches (the pixel whose centre, ``kp + 0.5``, sees the
    point)."""
    cam = (pts - c2w[:3, 3]) @ c2w[:3, :3]
    pix = cam @ np.asarray(K)[:3, :3].T
    return (pix[:, :2] / pix[:, 2:3] - 0.5).astype(np.float32), cam[:, 2]


def write_nerfpp_scene(root, splits=(("train", 4), ("validation", 1)), H=16, W=16,
                       focal=14.0, seed=0, k=None, masks=False, min_depth=False):
    """A seeded NeRF++ scene under ``root``: per split ``rgb/`` (smooth
    textures as PNGs, by the port's ``write_png``), ``intrinsics/`` (16
    floats, or 18 with ``k``) and ``pose/`` text files, optionally
    ``mask/`` and ``min_depth/`` with ``max_depth.txt``. Cameras from
    :func:`nerfpp_poses`. Returns ``{split: (K, poses)}``."""
    from scnerf_tpu_torch.core.imaging import to8b, write_png

    rng = np.random.RandomState(seed)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = focal
    K[0, 2], K[1, 2] = W / 2, H / 2
    out = {}
    for s, (split, n) in enumerate(splits):
        d = os.path.join(str(root), split)
        poses = nerfpp_poses(n, seed=seed + s, radius=0.5 - 0.05 * s)
        for sub in ["rgb", "intrinsics", "pose"] + (["mask"] if masks else []) + (
                ["min_depth"] if min_depth else []):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i in range(n):
            write_png(os.path.join(d, "rgb", f"{i:05d}.png"), to8b(smooth_texture(rng, H, W)))
            vals = list(K.reshape(-1)) + (list(k) if k is not None else [])
            with open(os.path.join(d, "intrinsics", f"{i:05d}.txt"), "w") as f:
                f.write(" ".join(repr(float(v)) for v in vals))
            with open(os.path.join(d, "pose", f"{i:05d}.txt"), "w") as f:
                f.write(" ".join(repr(float(v)) for v in poses[i].reshape(-1)))
            if masks:
                write_png(os.path.join(d, "mask", f"{i:05d}.png"),
                          (rng.rand(H, W) > 0.3).astype(np.uint8) * 255)
            if min_depth:
                write_png(os.path.join(d, "min_depth", f"{i:05d}.png"),
                          rng.randint(0, 60, (H, W)).astype(np.uint8))
        if min_depth:
            with open(os.path.join(d, "max_depth.txt"), "w") as f:
                f.write("0.8\n")
        out[split] = (K, poses)
    return out


def write_blender_scene(root, splits=(("train", 3), ("val", 1), ("test", 2)), H=16, W=16,
                        seed=0):
    """A seeded blender scene under ``root``: ``transforms_{split}.json``
    (``camera_angle_x`` 0.69, spherical poses) and RGBA PNGs of smooth
    textures with a seeded alpha."""
    import json

    from scnerf_tpu_torch.core.imaging import to8b, write_png
    from scnerf_tpu_torch.data.blender import pose_spherical

    rng = np.random.RandomState(seed)
    for split, n in splits:
        os.makedirs(os.path.join(str(root), split), exist_ok=True)
        frames = []
        for i in range(n):
            rgba = np.concatenate([smooth_texture(rng, H, W), rng.uniform(0.2, 1.0, (H, W, 1))],
                                  -1)
            write_png(os.path.join(str(root), split, f"r_{i}.png"), to8b(rgba))
            pose = pose_spherical(rng.uniform(-180, 180), rng.uniform(-40, -20), 4.0)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": pose.tolist()})
        with open(os.path.join(str(root), f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return str(root)


def write_reference_tar(path, coarse, fine=None, camera=None, step=1234, seed=0):
    """A checkpoint in the reference's ``.tar`` layout (``global_step``, the
    coarse and fine ``NeRF`` state dicts, an Adam ``optimizer_state_dict``
    of dicts, lists and floats, and ``camera_model``), written by
    ``torch.save``; ``coarse``/``fine`` are state dicts of numpy arrays,
    ``camera`` a camera state dict."""
    import torch

    rng = np.random.RandomState(seed)

    def tensors(sd):
        return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}

    n_params = len(coarse) + len(fine or {})
    ckpt = {
        "global_step": step,
        "network_fn_state_dict": tensors(coarse),
        "network_fine_state_dict": tensors(fine) if fine else None,
        "optimizer_state_dict": {
            "state": {i: {"step": torch.tensor(float(step)),
                          "exp_avg": torch.from_numpy(rng.randn(3).astype(np.float32)),
                          "exp_avg_sq": torch.from_numpy(rng.rand(3).astype(np.float32))}
                      for i in range(2)},
            "param_groups": [{"lr": 5e-4, "betas": (0.9, 0.999), "eps": 1e-8,
                              "weight_decay": 0.0, "amsgrad": False,
                              "params": list(range(n_params))}],
        },
    }
    if camera is not None:
        ckpt["camera_model"] = tensors(camera)
    torch.save(ckpt, str(path))
    return str(path)
