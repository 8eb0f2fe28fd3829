"""The port's NeRF++ train step against the JAX package, at a small size:
fg and bg MLPNets 4x32 with a skip at 2, multires 4/2, cascade (8, 8), 64
rays, a learnable OpenCV camera at 32x24 (focal 30, 4-px noise grids,
multiplicative intrinsics noise) over three images inside the unit sphere,
every learnable leaf non-zero. Every random draw is injected on both sides
(``rands``: the level-0 jitter and the level-1 uniforms of fg and bg), so
the JAX step takes its XLA sampler under ``"xla"`` and ``"pallas_stopgrad"``
and its Pallas K2 under ``"pallas_vjp"`` (run through
``_torch_support.interpret``), and the port's K2 wrapper its plain twin.

Tolerances, each with its reason:

- the distortion lookup (``lookup_axis``, ``undistort_pixels``): the same
  indices and validity, exactly, on a monotone and on a folded table, with
  queries outside the table; the table within 1e-6 relative (the same
  float32 polynomial); the undistorted pixels within 1e-6 relative and their
  gradients in ``x`` and ``k`` within relative L2 1e-5 on the monotone
  table, 1e-4 on the folded one, where the bracket is not within 1e-3 px of
  degenerate (the interpolation divides by the bracket's width, which the
  fold brings down to a few 1e-3 px: ``k``'s gradient sums such quotients);
- ``prd_pointwise`` with ``distortion_k``: values within relative 1e-5,
  gradients into every argument within relative L2 1e-5, as
  ``tests/test_torch_losses.py``;
- one step: loss and metrics within relative 1e-5 (``prd_matches``
  equal), per leaf a relative L2 error <= 1e-4 and a cosine >= 0.9999
  against the raw masked gradients the JAX step hands its optimizer
  (``_torch_support.gradient_tx``);
- one full step with the optimizer: parameters within relative 1e-5 plus
  1e-4 of the step size where the gradient is not near zero (Adam's first
  step is ``lr * g / (|g| + 1e-8)``, which moves by ``1e-8 / |g|`` times the
  gradient's elementwise error), at most a flipped step elsewhere;
- the optimizer chain over a NeRF++ tree, the lr floor active: updates
  within relative L2 1e-6, as ``tests/test_torch_optim.py``;
- a 100-step trajectory: every loss within 1%, final PSNR within 0.1 dB.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from _torch_support import (  # noqa: E402
    GradientCapture, assert_gradients_close, gradient_tx, interpret, to_jax, to_port,
)
from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu.camera import distortion as jdist  # noqa: E402
from scnerf_tpu.camera.model import OPENCV  # noqa: E402
from scnerf_tpu.camera.model import CameraConfig as JCameraConfig  # noqa: E402
from scnerf_tpu.camera.model import init_camera as j_init_camera  # noqa: E402
from scnerf_tpu.camera.rays import rays_opencv as j_rays_opencv  # noqa: E402
from scnerf_tpu.fields import nerfpp as jfield  # noqa: E402
from scnerf_tpu.losses import prd as jprd  # noqa: E402
from scnerf_tpu.render import nerfpp_renderer as jrend  # noqa: E402
from scnerf_tpu.sampling.pdf import sample_pdf as j_sample_pdf  # noqa: E402
from scnerf_tpu.train import curriculum as jcur  # noqa: E402
from scnerf_tpu.train import nerfpp_step as jnstep  # noqa: E402
from scnerf_tpu.train import optim as joptim  # noqa: E402
from scnerf_tpu.train import step as jstep  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera import distortion as tdist  # noqa: E402
from scnerf_tpu_torch.camera.model import FROZEN_LEAVES, TRAINABLE_LEAVES, Camera  # noqa: E402
from scnerf_tpu_torch.camera.rays import rays_opencv  # noqa: E402
from scnerf_tpu_torch.fields import nerfpp as tfield  # noqa: E402
from scnerf_tpu_torch.kernels import pdf_cuda  # noqa: E402
from scnerf_tpu_torch.losses import prd as tprd  # noqa: E402
from scnerf_tpu_torch.render import nerfpp_renderer as trend  # noqa: E402
from scnerf_tpu_torch.train import curriculum as tcur  # noqa: E402
from scnerf_tpu_torch.train import device_sampling  # noqa: E402
from scnerf_tpu_torch.train import nerfpp_step as tnstep  # noqa: E402
from scnerf_tpu_torch.train import optim as toptim  # noqa: E402
from scnerf_tpu_torch.train import step as tstep  # noqa: E402

J_MODEL = jfield.NerfPPConfig(depth=4, width=32, skips=(2,), max_freq_log2=4,
                              max_freq_log2_viewdirs=2)
J_RENDER = jrend.NerfPPRenderConfig(cascade_samples=(8, 8), perturb=True, remat_chunk=0)
T_MODEL = bridge.convert_config(J_MODEL, tfield.NerfPPConfig)
H, W = 24, 32
FOCAL = 30.0
K = np.array([[FOCAL, 0, W / 2, 0], [0, FOCAL, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
FISHEYE_K = np.array([-0.1, 0.03], np.float32)
N_IMAGES = 3
N_RAND = 64
N_MATCH = 16
METRIC_RTOL = 1e-5


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def _poses():
    """Three c2w poses inside the unit sphere, looking down +z (OpenCV)."""
    E = np.tile(np.eye(4), (N_IMAGES, 1, 1))
    E[0, :3, :3] = _rotation([0.0, 1.0, 0.1], 0.1)
    E[0, :3, 3] = [-0.35, -0.02, 0.0]
    E[1, :3, :3] = _rotation([0.1, 1.0, 0.0], -0.15)
    E[1, :3, 3] = [0.4, 0.0, 0.05]
    E[2, :3, :3] = _rotation([1.0, 0.2, 0.0], -0.15)
    E[2, :3, 3] = [-0.1, 0.2, -0.1]
    return E


def _forward(c, L, k):
    """The forward radial distortion along one axis, as the camera applies
    it (the table of ``camera/distortion.py``)."""
    d = (c - L / 2) / (L / 2)
    return (1.0 + k[0] * d**2 + k[1] * d**4) * (c - L / 2) + L / 2


def jax_params(seed=0, camera="opencv", autoexpo=False):
    """Two cascade levels of fg/bg nets (with autoexpo rows off their init)
    and, unless ``camera`` is None, the learnable camera ("opencv" or the
    "fisheye" variant: radial k, tied ray noise) with every learnable leaf
    non-zero."""
    rng = np.random.default_rng(seed)
    k = jax.random.key(seed)
    levels = [jfield.init_nerfpp_net(jax.random.fold_in(k, m), J_MODEL, n_images=N_IMAGES,
                                     autoexpo=autoexpo) for m in range(2)]
    for lv in levels:
        if autoexpo:
            lv["autoexpo"] = lv["autoexpo"] + jnp.asarray(
                rng.normal(size=(N_IMAGES, 2)) * 0.1, jnp.float32)
    params = {"levels": levels}
    if camera is not None:
        fisheye = camera == "fisheye"
        cfg = JCameraConfig(H=H, W=W, grid_size=4, convention=OPENCV, pixel_offset=0.5,
                            multiplicative_noise=True, use_distortion=fisheye,
                            tied_ray_noise=fisheye)
        cam = j_init_camera(K, _poses(), cfg, k=FISHEYE_K if fisheye else None)
        scale = dict(intrinsics_noise=0.01, extrinsics_noise=0.5, distortion_noise=1.0,
                     ray_o_grid=1.0, ray_d_grid=1.0)
        params["camera"] = cam.replace(**{
            name: jnp.asarray(rng.normal(size=getattr(cam, name).shape) * s, jnp.float32)
            for name, s in scale.items()})
    return params


def rands(rng, n=N_RAND):
    """One ``(fg, bg)`` pair a level: the jitter, then the uniforms."""
    return [tuple(rng.random((n, s)) for _ in range(2)) for s in J_RENDER.cascade_samples]


def _images(rng):
    y, x = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    base = np.stack([np.sin(3 * x + 1), np.cos(2 * y), np.sin(2 * x * y + 0.5)], -1)
    return np.clip(0.5 + 0.4 * base[None] + 0.05 * rng.normal(size=(N_IMAGES, H, W, 3)), 0, 1)


def pixel_batch(rng, images=None, per_ray=False, mask=False):
    """Pixels of one image (a 0-d index, as the sampler draws) or of one
    image a ray, with per-ray min depths."""
    images = _images(rng) if images is None else images
    px = rng.integers(0, W, N_RAND)
    py = rng.integers(0, H, N_RAND)
    img = rng.integers(0, N_IMAGES, N_RAND if per_ray else ()).astype(np.int32)
    batch = {"px": px.astype(np.float32), "py": py.astype(np.float32), "img_idx": img,
             "target": images[img, py, px], "min_depth": rng.uniform(1e-4, 0.2, N_RAND),
             "rands": rands(rng)}
    if mask:
        batch["mask"] = (rng.random(N_RAND) < 0.7).astype(np.float32)
    return batch


def ray_batch(rng):
    rays_d = rng.normal(size=(N_RAND, 3))
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
    return {"rays_o": rng.normal(size=(N_RAND, 3)) * 0.1, "rays_d": rays_d,
            "target": rng.random((N_RAND, 3)), "min_depth": np.full(N_RAND, 1e-4),
            "rands": rands(rng)}


def keypoints(pts, c2w, k=None):
    """The keypoints of world points in one camera: the camera casts a
    keypoint's ray through pixel ``kp + 0.5`` (warped by ``k`` if given), so
    ``kp + 0.5`` is the pinhole projection (unwarped by ``k``)."""
    n = len(pts)
    cam = (np.linalg.inv(c2w) @ np.concatenate([pts, np.ones((n, 1))], -1).T).T
    uv = np.stack([FOCAL * cam[:, 0] / cam[:, 2] + W / 2,
                   FOCAL * cam[:, 1] / cam[:, 2] + H / 2], -1)
    if k is not None:
        for axis, L in ((0, W), (1, H)):
            grid = np.linspace(-L, 2 * L, 20001)
            uv[:, axis] = np.interp(uv[:, axis], _forward(grid, L, k), grid)
    return uv - 0.5


def scene_points(rng, n=N_MATCH):
    """Seeded world points in front of images 0 and 1."""
    # A baseline of 0.75 at about twice that depth: the triangulation is
    # conditioned well enough that the PRD agrees with JAX's to 1e-5 (at a
    # 0.3 baseline and depth 3 XLA's fusion alone moved it by 2e-5).
    return np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.3, 0.3, n),
                     rng.uniform(1.8, 2.6, n)], -1)


def correspondences(rng, k=None, n=N_MATCH):
    """Keypoints of seeded points in images 0 and 1, about a third of a
    pixel of noise."""
    pts = scene_points(rng, n)
    E = _poses()
    return tuple(keypoints(pts, E[i], k) + rng.normal(size=(n, 2)) * 0.3 for i in (0, 1))


def prd_batch(rng, k=None, **kwargs):
    """A pixel batch plus N_MATCH correspondences between images 0 and 1,
    the last one padded."""
    batch = pixel_batch(rng, **kwargs)
    batch["kps0"], batch["kps1"] = correspondences(rng, k)
    mask = np.ones(N_MATCH, bool)
    mask[-1] = False
    batch["kp_mask"] = mask
    batch["pair_idx"] = np.array([0, 1], np.int32)
    return batch


def jax_leaves(tree):
    """A JAX train tree's trainable leaves by the port's paths, as numpy."""
    out = toptim.named_leaves({k: v for k, v in tree.items() if k != "camera"})
    if tree.get("camera") is not None:
        out.update({f"camera/{name}": getattr(tree["camera"], name) for name in TRAINABLE_LEAVES})
    return {k: np.asarray(v) for k, v in out.items()}


def run_jax_step(jp, batch, train_cfg, cur, tx, with_prd=False, render=J_RENDER):
    state = jstep.create_train_state(jp, tx)
    fn = jnstep.make_nerfpp_train_step(J_MODEL, render, train_cfg, cur, tx, with_prd=with_prd,
                                       donate=False)
    jbatch = to_jax(batch)

    def call():
        return fn(state, jbatch, jax.random.key(0))

    return interpret(call) if render.pdf_impl == "pallas_vjp" else jax.block_until_ready(call())


def port_step(train_cfg, cur, optimizer, with_prd=False, render=J_RENDER):
    return tnstep.make_nerfpp_train_step(
        T_MODEL, bridge.convert_config(render, trend.NerfPPRenderConfig),
        bridge.convert_config(train_cfg, tnstep.NerfPPTrainConfig),
        bridge.convert_config(cur, tcur.Curriculum), optimizer, with_prd=with_prd)


def run_port_step(jp, batch, train_cfg, cur, optimizer, with_prd=False, render=J_RENDER):
    tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    state = tstep.create_train_state(tp, optimizer)
    return port_step(train_cfg, cur, optimizer, with_prd, render)(state, to_port(batch))


def one_step_gradients(jp, batch, train_cfg, cur, with_prd=False, render=J_RENDER):
    j_state, j_metrics = run_jax_step(jp, batch, train_cfg, cur, gradient_tx(), with_prd, render)
    capture = GradientCapture()
    _, t_metrics = run_port_step(jp, batch, train_cfg, cur, capture, with_prd, render)
    return j_metrics, jax_leaves(j_state.opt_state), t_metrics, capture.grads


def assert_metrics_close(t_metrics, j_metrics):
    assert set(t_metrics) == set(j_metrics)
    for k, v in t_metrics.items():
        assert v.ndim == 0 and not v.requires_grad, k
        if k == "prd_matches":
            assert float(v) == float(j_metrics[k])
        else:
            np.testing.assert_allclose(float(v), float(j_metrics[k]), rtol=METRIC_RTOL,
                                       err_msg=k)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------- lookup

TABLES = {"monotone": FISHEYE_K, "folded": np.array([-0.5, 0.0], np.float32)}


def _queries(L, rng, n=200):
    """Queries over the axis and past both ends of the table."""
    return np.concatenate([rng.uniform(0, L, n), [-3.0, -0.5, L + 0.5, L + 3.0]]).astype(
        np.float32)


class TestLookup:
    @pytest.mark.parametrize("table", list(TABLES))
    def test_lookup_axis(self, table):
        """The count and the validity equal JAX's, exactly; on the folded
        table torch.searchsorted (a binary search) would not."""
        k = TABLES[table]
        loc = _queries(W, np.random.default_rng(1))
        want = [np.asarray(x)
                for x in jdist.lookup_axis(float(W), jnp.asarray(k), jnp.asarray(loc))]
        got = [x.numpy() for x in tdist.lookup_axis(float(W), _t(k), _t(loc))]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[3], want[3])
        assert not got[0][-4:].any()  # past both ends
        val = got[2]
        binary = torch.searchsorted(torch.from_numpy(val), torch.from_numpy(loc)).numpy()
        sorted_table = bool((np.diff(val) > 0).all())
        assert sorted_table == (table == "monotone")
        if not sorted_table:
            assert (np.clip(binary, 1, len(val) - 1) != got[1]).any()

    @pytest.mark.parametrize("table", list(TABLES))
    def test_undistort_pixels_and_gradients(self, table):
        k = TABLES[table]
        rng = np.random.default_rng(2)
        x, y = _queries(W, rng), _queries(H, rng)
        cot = rng.normal(size=(len(x), 2)).astype(np.float32)
        # Away from a degenerate bracket (the folded table divides by it).
        _, ix, val_x, _ = (np.asarray(a) for a in jdist.lookup_axis(float(W), jnp.asarray(k),
                                                                   jnp.asarray(x)))
        _, iy, val_y, _ = (np.asarray(a) for a in jdist.lookup_axis(float(H), jnp.asarray(k),
                                                                   jnp.asarray(y)))
        keep = ((np.abs(val_x[ix] - val_x[ix - 1]) > 1e-3)
                & (np.abs(val_y[iy] - val_y[iy - 1]) > 1e-3))
        x, y, cot = x[keep], y[keep], cot[keep]

        def jfn(k_, x_, y_):
            valid, xy = jdist.undistort_pixels(W, H, k_, x_, y_)
            return jnp.sum(xy * cot), (valid, xy)

        (_, (j_valid, j_xy)), j_grads = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(k), jnp.asarray(x), jnp.asarray(y))
        args = [_t(a, grad=True) for a in (k, x, y)]
        t_valid, t_xy = tdist.undistort_pixels(W, H, *args)
        t_grads = torch.autograd.grad(torch.sum(t_xy * _t(cot)), args)
        np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
        np.testing.assert_allclose(t_xy.detach().numpy(), np.asarray(j_xy), rtol=1e-6,
                                   atol=1e-5)
        for name, gt, gj in zip(("k", "x", "y"), t_grads, j_grads):
            assert np.isfinite(gt.numpy()).all(), name
            limit = 1e-5 if table == "monotone" else 1e-4
            assert _rel_l2(gt.numpy(), gj) <= limit, (name, _rel_l2(gt.numpy(), gj))


class TestDistortionAwarePRD:
    def test_prd_pointwise_values_and_gradients(self):
        """Rays from the two cameras through seeded points (a little off
        them), keypoints the unwarped projections: rows 0-1 project off the
        table (invalid), row 2 lies behind camera 0, the rest are valid."""
        rng = np.random.default_rng(3)
        pts = scene_points(rng)
        pts[:2, 0] = [1.8, -1.8]
        E = _poses()[:2]
        kps0, kps1 = (keypoints(pts, E[i], FISHEYE_K) + rng.normal(size=(N_MATCH, 2)) * 0.3
                      for i in (0, 1))
        rays = []
        for c2w in E:
            o = np.broadcast_to(c2w[:3, 3], pts.shape)
            rays += [o, pts - o + rng.normal(size=pts.shape) * 0.01]
        rays[1][2] *= -1.0
        args = [*(a.astype(np.float32) for a in rays), K.astype(np.float32),
                E.astype(np.float32), FISHEYE_K]

        def jfn(o0, d0, o1, d1, K_, E_, k_):
            l0, l1, ch = jprd.prd_pointwise(jnp.asarray(kps0 + 0.5, jnp.float32),
                                            jnp.asarray(kps1 + 0.5, jnp.float32), (o0, d0),
                                            (o1, d1), K_, E_, method="NeRF++", distortion_k=k_,
                                            image_wh=(W, H))
            return jnp.sum(jnp.minimum(l0, 50.0) * ch) + jnp.sum(jnp.minimum(l1, 50.0) * ch), (
                l0, l1, ch)

        (_, j_out), j_grads = jax.value_and_grad(jfn, argnums=tuple(range(7)), has_aux=True)(
            *(jnp.asarray(a) for a in args))
        leaves = [_t(a, grad=True) for a in args]
        l0, l1, ch = tprd.prd_pointwise(_t(kps0 + 0.5), _t(kps1 + 0.5), tuple(leaves[:2]),
                                        tuple(leaves[2:4]), leaves[4], leaves[5],
                                        method="NeRF++", distortion_k=leaves[6], image_wh=(W, H))
        value = (torch.sum(torch.clamp(l0, max=50.0) * ch)
                 + torch.sum(torch.clamp(l1, max=50.0) * ch))
        t_grads = torch.autograd.grad(value, leaves)
        j_l0, j_l1, j_ch = (np.asarray(a) for a in j_out)
        np.testing.assert_array_equal(ch.numpy(), j_ch)
        assert 0 < j_ch.sum() < N_MATCH - 2  # some matches off the table or behind
        for got, want in ((l0, j_l0), (l1, j_l1)):
            ok = j_ch > 0
            np.testing.assert_allclose(got.detach().numpy()[ok], want[ok], rtol=1e-5, atol=1e-6)
        for name, gt, gj in zip(("o0", "d0", "o1", "d1", "K", "E", "k"), t_grads, j_grads):
            assert np.isfinite(gt.numpy()).all(), name
            assert _rel_l2(gt.numpy(), gj) <= 1e-5, (name, _rel_l2(gt.numpy(), gj))
        assert np.abs(t_grads[6].numpy()).min() > 0  # k is observable through the lookup


# ---------------------------------------------------------------- the step

def _stopped_sample_pdf(key, bins, weights, n_samples, det=False, u=None, variant="nerf"):
    """The JAX package's XLA sampler with the bins' gradient stopped: the
    intent of its TPU ``"pallas_stopgrad"`` branch, in the NeRF++ variant."""
    return j_sample_pdf(key, jax.lax.stop_gradient(bins), weights, n_samples, det=det, u=u,
                        variant=variant)


STEP_CASES = {
    "pixels_full_camera": dict(),
    "rays_given": dict(camera=None),
    "autoexpo": dict(autoexpo=True),
    "autoexpo_mask_per_ray": dict(autoexpo=True, mask=True, per_ray=True),
    "prd": dict(with_prd=True),
    "prd_undistort": dict(with_prd=True, camera="fisheye",
                          train_cfg=jnstep.NerfPPTrainConfig(prd_undistort=True)),
    "locked_camera": dict(cur=jcur.Curriculum(add_ie=2, add_od=5, add_radial=3)),
    "pallas_vjp": dict(render=dataclasses.replace(J_RENDER, pdf_impl="pallas_vjp")),
}


def _case_inputs(spec, seed=10):
    rng = np.random.default_rng(seed)
    camera = spec.get("camera", "opencv")
    autoexpo = spec.get("autoexpo", False)
    jp = jax_params(camera=camera, autoexpo=autoexpo)
    kw = dict(per_ray=spec.get("per_ray", False), mask=spec.get("mask", False))
    if spec.get("with_prd"):
        batch = prd_batch(rng, FISHEYE_K if camera == "fisheye" else None, **kw)
    elif camera is None:
        batch = ray_batch(rng)
    else:
        batch = pixel_batch(rng, **kw)
    train_cfg = spec.get("train_cfg", jnstep.NerfPPTrainConfig())
    if autoexpo:
        train_cfg = dataclasses.replace(train_cfg, autoexpo=True, lambda_autoexpo=0.5)
    cur = spec.get("cur", jcur.Curriculum(ray_dist_loss_weight=0.1))
    return jp, batch, train_cfg, cur


class TestOneStep:
    @pytest.mark.parametrize("case", list(STEP_CASES))
    def test_gradients_match_jax(self, case):
        spec = STEP_CASES[case]
        jp, batch, train_cfg, cur = _case_inputs(spec)
        with_prd = spec.get("with_prd", False)
        render = spec.get("render", J_RENDER)
        j_metrics, j_grads, t_metrics, t_grads = one_step_gradients(
            jp, batch, train_cfg, cur, with_prd=with_prd, render=render)
        assert_metrics_close(t_metrics, j_metrics)
        assert_gradients_close(t_grads, j_grads)
        assert {f"mse_{m}" for m in range(2)} <= set(t_metrics)
        camera = spec.get("camera", "opencv")
        if camera is not None and case != "locked_camera":
            # Every camera leaf learns; distortion only on the fisheye camera.
            for name in TRAINABLE_LEAVES:
                g = t_grads[f"camera/{name}"]
                assert (g is not None and bool(g.abs().any())) == (
                    name != "distortion_noise" or camera == "fisheye"), name
        if spec.get("autoexpo"):
            for m in range(2):
                g = t_grads[f"levels/{m}/autoexpo"].numpy()
                used = np.unique(batch["img_idx"])
                assert np.abs(g[used]).all() and not np.abs(np.delete(g, used, 0)).any()
        if with_prd:
            assert float(t_metrics["prd_matches"]) >= 4
            assert float(t_metrics["prd"]) > 0
        if case == "locked_camera":
            for name in TRAINABLE_LEAVES:
                g = t_grads[f"camera/{name}"]
                assert g is None or not g.abs().any(), name

    def test_pallas_stopgrad_detaches_the_bins(self, monkeypatch):
        """Under ``"pallas_stopgrad"`` the port detaches the fg bins, the
        intent of the JAX package's TPU branch for that name. That branch
        runs only on a TPU without ``rands``; here JAX falls through to the
        differentiable sampler, so its camera also gets the gradient of the
        bins, and the port's camera gradient differs from it. The MLP
        leaves (which the bins do not reach) match that JAX step; every leaf,
        the camera's included, matches a JAX step whose sampler stops the
        bins' gradient."""
        render = dataclasses.replace(J_RENDER, pdf_impl="pallas_stopgrad")
        jp, batch, train_cfg, cur = _case_inputs({})
        j_metrics, j_grads, t_metrics, t_grads = one_step_gradients(jp, batch, train_cfg, cur,
                                                                    render=render)
        assert_metrics_close(t_metrics, j_metrics)
        mlp = [p for p in j_grads if p.startswith("levels/")]
        assert_gradients_close({p: t_grads[p] for p in mlp}, {p: j_grads[p] for p in mlp})
        moved = [_rel_l2(t_grads[p].numpy(), j_grads[p]) for p in j_grads
                 if p.startswith("camera/") and np.abs(j_grads[p]).any()]
        assert max(moved) > 1e-3  # the bins' share of the camera's gradient

        monkeypatch.setattr(jrend, "sample_pdf", _stopped_sample_pdf)
        j_state, _ = run_jax_step(jp, batch, train_cfg, cur, gradient_tx(), render=render)
        assert_gradients_close(t_grads, jax_leaves(j_state.opt_state))

    def test_k2_calls_a_step(self, monkeypatch):
        """Two K2 calls a step, the fg's through the autograd function (its
        bins require grad), the bg's forward only; under
        ``"pallas_stopgrad"`` neither takes the autograd function."""
        forward = pdf_cuda.sample_pdf_fwd
        for pdf_impl, want in (("xla", [True, False]), ("pallas_stopgrad", [False, False])):
            seen = []

            def recording(bins, weights, u, variant="nerfpp", *, with_cdf=False):
                seen.append(with_cdf)
                return forward(bins, weights, u, variant, with_cdf=with_cdf)

            monkeypatch.setattr(pdf_cuda, "sample_pdf_fwd", recording)
            jp, batch, train_cfg, cur = _case_inputs({})
            run_port_step(jp, batch, train_cfg, cur, GradientCapture(),
                          render=dataclasses.replace(J_RENDER, pdf_impl=pdf_impl))
            assert seen == want, pdf_impl

    def test_prd_pair_without_matches_adds_nothing(self):
        jp, batch, train_cfg, cur = _case_inputs({"with_prd": True}, seed=11)
        batch["kp_mask"][:] = False
        j_metrics, j_grads, t_metrics, t_grads = one_step_gradients(jp, batch, train_cfg, cur,
                                                                    with_prd=True)
        assert float(t_metrics["prd"]) == float(j_metrics["prd"]) == 0.0
        assert float(t_metrics["prd_matches"]) == 0.0
        assert_gradients_close(t_grads, j_grads)

    def test_autoexpo_reads_no_host_value(self, monkeypatch):
        """A 0-d image index reaches the autoexpo table through
        ``index_select`` (no read-back, no sort-based ``index_put`` in the
        backward): the same scale and shift as JAX's."""
        jp = jax_params(autoexpo=True)
        table = np.asarray(jp["levels"][0]["autoexpo"])
        tp = bridge.tree_to_torch(jax.tree.map(np.asarray, jp["levels"][0]), device="cpu")
        calls = []
        index_select = torch.Tensor.index_select
        monkeypatch.setattr(torch.Tensor, "index_select",
                            lambda self, *a: calls.append(a) or index_select(self, *a))
        for idx in (torch.tensor(2), torch.tensor([0, 2, 2]), 1):
            scale, shift = tfield.autoexpo_params(tp, idx)
            j_scale, j_shift = jfield.autoexpo_params({"autoexpo": table}, np.asarray(idx))
            np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
            np.testing.assert_array_equal(shift.numpy(), np.asarray(j_shift))
        assert len(calls) == 2  # the two tensors; an int indexes directly

    def test_runs_in_float32(self, monkeypatch):
        seen = []
        forward = trend.nerfpp_forward

        def recording(*args, **kwargs):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return forward(*args, **kwargs)

        monkeypatch.setattr(trend, "nerfpp_forward", recording)
        old = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            jp, batch, train_cfg, cur = _case_inputs({})
            run_port_step(jp, batch, train_cfg, cur, GradientCapture())
            assert seen == [False, False] and torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


def jax_optimizer(train_cfg, jp):
    """``make_optimizer`` as ``build_nerfpp_experiment`` builds it."""
    return joptim.make_optimizer(train_cfg.lr_init, train_cfg.lr_decay_steps,
                                 decay_factor=train_cfg.lr_decay_factor,
                                 weight_decay=train_cfg.weight_decay, params_example=jp,
                                 lr_floor=0.01 * train_cfg.lr_init)


def port_optimizer(train_cfg):
    return toptim.Optimizer.from_config(
        bridge.convert_config(train_cfg, tnstep.NerfPPTrainConfig),
        lr_floor=0.01 * train_cfg.lr_init)


class TestOptimizer:
    def test_chain_matches_make_optimizer_over_a_nerfpp_tree(self):
        """Five steps of seeded gradients through both chains over the
        NeRF++ tree (the autoexpo tables and the fisheye camera included),
        the decay past the floor from the third step: updates within
        relative L2 1e-6, frozen leaves never moved."""
        train_cfg = jnstep.NerfPPTrainConfig(lr_init=1e-2, lr_decay_steps=0.5,
                                             weight_decay=0.1)
        opt = port_optimizer(train_cfg)
        assert opt.lr_floor == pytest.approx(1e-4) and opt.learning_rate(2) == pytest.approx(1e-4)
        jp = jax_params(camera="fisheye", autoexpo=True)
        tx = jax_optimizer(train_cfg, jp)
        opt_state = tx.init(jp)
        tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu")
        state = opt.init(tp)
        leaves = toptim.trainable_leaves(tp)
        assert "levels/1/autoexpo" in leaves
        rng = np.random.default_rng(4)
        for step in range(5):
            grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), jp)
            updates, opt_state = tx.update(grads, opt_state, jp)
            jp = optax.apply_updates(jp, updates)
            want = jax_leaves(updates)
            by_path = jax_leaves(grads)
            got = opt.update({k: torch.tensor(by_path[k]) for k in leaves}, state, leaves)
            toptim.apply_updates(leaves, got)
            assert set(got) == set(want)
            for path, u in got.items():
                assert _rel_l2(u.numpy(), want[path]) <= 1e-6, (step, path)
        for name in FROZEN_LEAVES:
            np.testing.assert_array_equal(getattr(tp["camera"], name).numpy(),
                                          np.asarray(getattr(jp["camera"], name)))


class TestFullStep:
    @pytest.mark.parametrize("case", ["autoexpo", "prd_undistort"])
    def test_params_after_one_step_match_jax(self, case):
        spec = STEP_CASES[case]
        jp, batch, train_cfg, cur = _case_inputs(spec, seed=13)
        train_cfg = dataclasses.replace(train_cfg, weight_decay=0.1)
        with_prd = spec.get("with_prd", False)
        _, j_grads, _, _ = one_step_gradients(jp, batch, train_cfg, cur, with_prd=with_prd)
        j_state, j_metrics = run_jax_step(jp, batch, train_cfg, cur,
                                          jax_optimizer(train_cfg, jp), with_prd)
        t_state, t_metrics = run_port_step(jp, batch, train_cfg, cur, port_optimizer(train_cfg),
                                           with_prd)
        assert t_state.step == 1 and t_state.opt_state.count == 1
        assert_metrics_close(t_metrics, j_metrics)
        want = jax_leaves(j_state.params)
        got = toptim.named_leaves(t_state.params)
        lr = train_cfg.lr_init
        for path, g in j_grads.items():
            settled = (np.abs(g) > 1e-4 * np.abs(g).max() if np.abs(g).any()
                       else np.ones_like(g, bool))
            p = got[path].detach().numpy()
            np.testing.assert_allclose(p[settled], want[path][settled], rtol=1e-5,
                                       atol=1e-4 * lr, err_msg=path)
            assert np.abs(p - want[path]).max() <= 2 * lr * 1.001, path
        for name in FROZEN_LEAVES:
            np.testing.assert_array_equal(getattr(t_state.params["camera"], name).numpy(),
                                          np.asarray(getattr(jp["camera"], name)))


class TestTrajectory:
    def test_100_steps_track_jax(self):
        """The same batches and randoms each step on both sides, the full
        camera, autoexpo, the NeRF++ optimizer chain: every loss within 1%,
        final PSNR within 0.1 dB, and the loss comes down."""
        rng = np.random.default_rng(14)
        images = _images(rng)
        batches = [pixel_batch(rng, images) for _ in range(100)]
        train_cfg = jnstep.NerfPPTrainConfig(lr_init=2e-3, lr_decay_steps=500.0,
                                             weight_decay=0.1, autoexpo=True)
        cur = jcur.Curriculum()
        jp = jax_params(autoexpo=True)
        tx = jax_optimizer(train_cfg, jp)
        j_state = jstep.create_train_state(jp, tx)
        j_fn = jnstep.make_nerfpp_train_step(J_MODEL, J_RENDER, train_cfg, cur, tx, donate=False)
        optimizer = port_optimizer(train_cfg)
        t_state = tstep.create_train_state(
            bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu"), optimizer)
        t_fn = port_step(train_cfg, cur, optimizer)
        j_loss, t_loss = [], []
        key = jax.random.key(0)
        for batch in batches:
            j_state, jm = jax.block_until_ready(j_fn(j_state, to_jax(batch), key))
            t_state, tm = t_fn(t_state, to_port(batch))
            j_loss.append(float(jm["loss"]))
            t_loss.append(float(tm["loss"]))
        j_loss, t_loss = np.array(j_loss), np.array(t_loss)
        np.testing.assert_allclose(t_loss, j_loss, rtol=1e-2)
        assert abs(float(tm["psnr"]) - float(jm["psnr"])) < 0.1
        assert t_loss[-10:].mean() < t_loss[:10].mean()
        assert t_state.step == 100


class TestDeviceSampling:
    def _data(self):
        rng = np.random.default_rng(15)
        images = torch.from_numpy(rng.random((N_IMAGES, H, W, 3)).astype(np.float32))
        masks = torch.from_numpy(rng.random((N_IMAGES, H, W)) < 0.5)
        min_depths = torch.from_numpy(rng.uniform(0.01, 0.1, (N_IMAGES, H, W)).astype(np.float32))
        return images, masks, min_depths

    @pytest.mark.parametrize("extras", [False, True])
    def test_batch(self, extras):
        images, masks, min_depths = self._data()
        seen = []
        poses = torch.from_numpy(_poses().astype(np.float32))
        intrinsics = torch.from_numpy(np.tile(K, (N_IMAGES, 1, 1)).astype(np.float32))
        kw = dict(masks=masks, min_depths=min_depths, intrinsics=intrinsics,
                  poses=poses) if extras else {}
        step = device_sampling.make_nerfpp_device_sampling_step(
            lambda state, batch, gen: (state, seen.append(batch) or {}), images, 500, **kw)
        step(None, torch.Generator().manual_seed(0))
        batch = seen[0]
        img, px, py = batch["img_idx"], batch["px"], batch["py"]
        assert img.shape == () and 0 <= int(img) < N_IMAGES
        assert px.shape == py.shape == (500,) and px.dtype == torch.float32
        assert int(px.min()) >= 0 and int(px.max()) < W and int(py.max()) < H
        pxl, pyl = px.long(), py.long()
        torch.testing.assert_close(batch["target"], images[int(img)][pyl, pxl], rtol=0, atol=0)
        if not extras:
            assert set(batch) == {"px", "py", "img_idx", "target", "min_depth"}
            assert bool((batch["min_depth"] == 1e-4).all())
            return
        torch.testing.assert_close(batch["min_depth"], min_depths[int(img)][pyl, pxl],
                                   rtol=0, atol=0)
        torch.testing.assert_close(batch["mask"], masks[int(img)][pyl, pxl].float(), rtol=0,
                                   atol=0)
        want = j_rays_opencv(jnp.asarray(K, jnp.float32),
                             jnp.asarray(_poses()[int(img)], jnp.float32),
                             jnp.asarray(px.numpy()), jnp.asarray(py.numpy()))
        for got, w in zip((batch["rays_o"], batch["rays_d"]), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)

    def test_rays_opencv_matches_jax(self):
        rng = np.random.default_rng(16)
        px, py = rng.integers(0, W, 50).astype(np.float32), rng.integers(0, H, 50).astype(
            np.float32)
        Kn = K.astype(np.float32).copy()
        Kn[0, 1] = 0.3  # skew
        c2w = _poses()[1].astype(np.float32)
        want = j_rays_opencv(jnp.asarray(Kn), jnp.asarray(c2w), jnp.asarray(px), jnp.asarray(py))
        got = rays_opencv(_t(Kn), _t(c2w), _t(px), _t(py))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)

    def test_sampling_step_trains_from_a_generator(self):
        """Around the port's NeRF++ step: each call draws its batch and its
        randoms from the one generator; the same seed gives the same run."""
        images, masks, _ = self._data()
        losses = []
        for _ in range(2):
            jp = jax_params(autoexpo=True)
            train_cfg = jnstep.NerfPPTrainConfig(autoexpo=True, weight_decay=0.1)
            optimizer = port_optimizer(train_cfg)
            state = tstep.create_train_state(
                bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu"),
                optimizer)
            step = device_sampling.make_nerfpp_device_sampling_step(
                port_step(train_cfg, jcur.Curriculum(), optimizer), images, 32, masks=masks)
            gen = torch.Generator().manual_seed(7)
            run = []
            for _ in range(3):
                state, metrics = step(state, gen)
                assert set(metrics) == {"loss", "mse_0", "mse_1", "psnr"}
                run.append(float(metrics["loss"]))
            assert state.step == 3 and np.isfinite(run).all()
            losses.append(run)
        assert losses[0] == losses[1]


class TestBridge:
    def test_nerfpp_train_tree(self):
        """``{"levels": [{"fg", "bg", "autoexpo"}, ...], "camera"}``: every
        leaf requires grad but the camera's ``*_init``; back to numpy by
        the JAX names, unchanged."""
        jp = jax_params(camera="fisheye", autoexpo=True)
        tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu")
        assert isinstance(tp["camera"], Camera) and tp["camera"].config.use_distortion
        leaves = toptim.named_leaves(tp)
        for path, x in leaves.items():
            assert x.requires_grad == (toptim.leaf_name(path) not in FROZEN_LEAVES), path
            assert x.is_leaf and x.dtype == torch.float32, path
        assert {"levels/0/autoexpo", "levels/1/fg/base/0/w", "levels/1/bg/rgb1/b"} <= set(leaves)
        back = bridge.train_params_to_numpy(tp)
        assert jax.tree.structure(back["levels"]) == jax.tree.structure(
            jax.tree.map(np.asarray, jp["levels"]))
        for got, want in zip(jax.tree.leaves(back["levels"]), jax.tree.leaves(jp["levels"])):
            np.testing.assert_array_equal(got, np.asarray(want))
        for name, x in back["camera"].items():
            np.testing.assert_array_equal(x, np.asarray(getattr(jp["camera"], name)))

    def test_configs(self):
        """The NeRF++ train config converts field for field; the JAX
        render config's ``remat_chunk`` and the field config's
        ``compute_dtype`` (float32) are accepted and dropped."""
        cfg = jnstep.NerfPPTrainConfig(lr_init=1e-3, autoexpo=True, lambda_autoexpo=0.3,
                                       prd_undistort=True)
        got = bridge.convert_config(cfg, tnstep.NerfPPTrainConfig)
        assert bridge.config_to_dict(got) == {
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(tnstep.NerfPPTrainConfig)}
        render = bridge.convert_config(dataclasses.replace(J_RENDER, remat_chunk=8),
                                       trend.NerfPPRenderConfig)
        assert not hasattr(render, "remat_chunk")
        model = bridge.convert_config(dataclasses.replace(J_MODEL, compute_dtype="float32"),
                                      tfield.NerfPPConfig)
        assert not hasattr(model, "compute_dtype")
