"""The port's evaluation and checkpoint modules against the JAX package's,
on seeded inputs on the CPU:

- ``geometry/alignment.py`` (Umeyama, trajectory alignment, Sim(3), ATE)
  within 1e-5, including centres whose best fit is a reflection;
- ``metrics/ssim.py`` within 1e-6 on random pairs and on a
  near-identical pair (the variance-cancellation case), and both sides at
  the closed form on flat images;
- ``losses/prd_eval.py`` in train, val and test modes within relative 1e-5;
- ``train/checkpoint.py``: an exact round trip of parameters, camera,
  moments, count and step, the step after a restore equal to the step
  without one, ``keep`` pruning, ``None`` for an empty directory,
  ``ValueError`` on mismatched optimizer knobs, ``merge_states``'s shape
  guard and ``restore_camera_partial``, as the JAX package's own tests.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu.camera import model as jcam  # noqa: E402
from scnerf_tpu.camera import rays as jrays  # noqa: E402
from scnerf_tpu.geometry import alignment as jalign  # noqa: E402
from scnerf_tpu.losses import prd_eval as jprd_eval  # noqa: E402
from scnerf_tpu.matching import provider as jprovider  # noqa: E402
from scnerf_tpu.metrics.ssim import ssim as j_ssim  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera import model as tcam  # noqa: E402
from scnerf_tpu_torch.camera import rays as trays  # noqa: E402
from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp  # noqa: E402
from scnerf_tpu_torch.geometry import alignment as talign  # noqa: E402
from scnerf_tpu_torch.losses import prd_eval as tprd_eval  # noqa: E402
from scnerf_tpu_torch.matching import provider as tprovider  # noqa: E402
from scnerf_tpu_torch.metrics.ssim import ssim as t_ssim  # noqa: E402
from scnerf_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from scnerf_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from scnerf_tpu_torch.train.curriculum import Curriculum  # noqa: E402
from scnerf_tpu_torch.train.optim import Optimizer, named_leaves  # noqa: E402
from scnerf_tpu_torch.train.step import TrainConfig, create_train_state, make_train_step  # noqa: E402


def _rotations(rng, n, max_angle):
    from scnerf_tpu_torch.data.noise import axis_angle_matrices, random_axes

    return axis_angle_matrices(random_axes(rng, n), rng.rand(n) * max_angle)


def _poses(rng, n):
    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, :3, :3] = _rotations(rng, n, np.pi)
    P[:, :3, 3] = rng.randn(n, 3)
    return P.astype(np.float32)


class TestAlignment:
    @pytest.mark.parametrize("case", ["similar", "noisy", "reflected"])
    def test_alignment_alike(self, case):
        rng = np.random.RandomState({"similar": 0, "noisy": 1, "reflected": 2}[case])
        a = _poses(rng, 9)
        R = _rotations(rng, 1, np.pi)[0]
        b = a.copy()
        b[:, :3, :3] = R @ a[:, :3, :3]
        b[:, :3, 3] = 1.7 * a[:, :3, 3] @ R.T + rng.randn(3)
        if case == "noisy":
            b[:, :3, 3] += rng.randn(9, 3) * 0.05
        if case == "reflected":  # the best orthogonal fit has det -1
            b[:, :3, 3] *= np.array([1.0, 1.0, -1.0])
        b = b.astype(np.float32)
        j_al, (js, jR, jt) = jalign.align_c2w_trajectories(jnp.asarray(a), jnp.asarray(b))
        t_al, (ts, tR, tt) = talign.align_c2w_trajectories(torch.from_numpy(a),
                                                          torch.from_numpy(b))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
        np.testing.assert_allclose(t_al.numpy(), np.asarray(j_al), atol=1e-5)
        assert np.linalg.det(tR.numpy()) == pytest.approx(1.0, abs=1e-5)
        np.testing.assert_allclose(
            float(talign.ate_rmse(torch.from_numpy(a), torch.from_numpy(b))),
            float(jalign.ate_rmse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5)

    def test_umeyama_without_scale(self):
        rng = np.random.RandomState(3)
        src, dst = rng.randn(12, 3).astype(np.float32), rng.randn(12, 3).astype(np.float32)
        js, jR, jt = jalign.umeyama(jnp.asarray(src), jnp.asarray(dst), with_scale=False)
        ts, tR, tt = talign.umeyama(torch.from_numpy(src), torch.from_numpy(dst),
                                    with_scale=False)
        assert float(ts) == float(js) == 1.0
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def _blobs():
    """tests/test_checkpoint_metrics.py's near-identical pair: smooth blobs
    on black and the same with 3e-3 noise."""
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    img = np.zeros((48, 64, 3), np.float32)
    for cx, cy, ch in ((16, 20, 0), (40, 30, 1), (30, 12, 2)):
        img[..., ch] += 0.8 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 40.0)
    img = np.clip(img, 0.0, 1.0)
    noisy = np.clip(img + np.random.RandomState(0).randn(*img.shape).astype(np.float32) * 3e-3,
                    0.0, 1.0)
    return img, noisy


class TestSSIM:
    @pytest.mark.parametrize("case", ["random", "noisy", "near_identical", "identical"])
    def test_ssim_alike(self, case):
        rng = np.random.RandomState(5)
        if case == "near_identical":
            x, y = _blobs()
        else:
            x = rng.rand(40, 52, 3).astype(np.float32)
            y = {"random": rng.rand(40, 52, 3).astype(np.float32),
                 "noisy": np.clip(x + rng.randn(*x.shape).astype(np.float32) * 0.2, 0, 1),
                 "identical": x}[case]
        want = float(j_ssim(jnp.asarray(x), jnp.asarray(y)))
        got = float(t_ssim(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(got - want) <= 1e-6, (got, want)
        if case == "near_identical":
            assert 0.98 < got <= 1.0 + 1e-5

    def test_constant_shift(self):
        """Flat images: only the luminance term is left, and the variances
        are pure cancellation (sums of 121 equal float32 terms, rounded in
        each side's own order), so both sides are held to the closed form
        at 1e-5, as tests/test_checkpoint_metrics.py holds JAX's at 1e-4."""
        x, y = np.full((24, 24, 3), 0.5, np.float32), np.full((24, 24, 3), 0.6, np.float32)
        expect = (2 * 0.5 * 0.6 + 1e-4) / (0.25 + 0.36 + 1e-4)
        got = float(t_ssim(torch.from_numpy(x), torch.from_numpy(y)))
        want = float(j_ssim(jnp.asarray(x), jnp.asarray(y)))
        assert abs(got - expect) <= 1e-5 and abs(want - expect) <= 1e-5, (got, want, expect)


def _prd_scene():
    """Two OpenGL cameras 5 degrees apart looking at points near z = -4, the
    keypoints projected through the GT camera; the evaluated camera has
    intrinsic, extrinsic and ray noise."""
    rng = np.random.RandomState(7)
    H, W, f = 96, 128, 110.0
    K = np.array([[f, 0, W / 2, 0], [0, f, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    E = np.tile(np.eye(4), (3, 1, 1)).astype(np.float32)
    for i in (1, 2):
        E[i, :3, :3] = _rotations(np.random.RandomState(i), 1, np.deg2rad(5))[0]
        E[i, :3, 3] = [0.3 * i, 0.05, 0.0]
    pts = rng.randn(40, 3) * [0.6, 0.5, 0.3] + [0.0, 0.0, -4.0]

    def project(c2w):
        cam = (pts - c2w[:3, 3]) @ c2w[:3, :3]
        return np.stack([K[0, 2] + f * cam[:, 0] / -cam[:, 2],
                         K[1, 2] - f * cam[:, 1] / -cam[:, 2]], -1).astype(np.float32)

    cache = jprovider.PrecomputedMatches()
    t_cache = tprovider.PrecomputedMatches()
    for i, j in ((0, 1), (1, 2)):
        k1 = project(E[j])
        k1[:6] += 25.0  # bad matches
        cache.put(i, j, jprovider.PairMatches(project(E[i]), k1))
        t_cache.put(i, j, tprovider.PairMatches(project(E[i]), k1))
    cfg = jcam.CameraConfig(H=H, W=W, convention=jcam.OPENGL, ray_o_noise_scale=1e-3,
                            ray_d_noise_scale=1e-3, extrinsics_noise_scale=1e-2)
    cam = jcam.init_camera(jnp.asarray(K), jnp.asarray(E), cfg)
    cam = cam.replace(intrinsics_noise=jnp.asarray(rng.randn(4) * 0.5, jnp.float32),
                      extrinsics_noise=jnp.asarray(rng.randn(3, 9) * 0.05, jnp.float32),
                      ray_o_grid=jnp.asarray(rng.randn(*cam.ray_o_grid.shape), jnp.float32),
                      ray_d_grid=jnp.asarray(rng.randn(*cam.ray_d_grid.shape), jnp.float32))
    t_cam = bridge.camera_from_numpy(jax.tree.map(np.asarray, cam), device="cpu")
    return K, E, cache, t_cache, cam, t_cam, (H, W, f)


class TestPrdEvaluation:
    @pytest.mark.parametrize("mode", ["train", "val", "test"])
    def test_prd_evaluation_alike(self, mode):
        K, E, cache, t_cache, cam, t_cam, (H, W, f) = _prd_scene()
        pairs = np.array([[0, 1], [1, 2], [0, 2]])  # (0, 2) has no matches
        kw = dict(mode=mode, method="NeRF", max_matches=64, threshold=5.0)
        if mode == "train":
            j_val = jprd_eval.prd_evaluation(
                pairs, cache, lambda k, i: jrays.pixels_to_rays(cam, k[:, 0], k[:, 1],
                                                                 image_idx=i),
                jcam.get_intrinsic(cam), jcam.get_extrinsics(cam), **kw)
            t_val = tprd_eval.prd_evaluation(
                pairs, t_cache, lambda k, i: trays.pixels_to_rays(t_cam, k[:, 0], k[:, 1],
                                                                   image_idx=i),
                tcam.get_intrinsic(t_cam), tcam.get_extrinsics(t_cam), device="cpu", **kw)
        else:
            tE = torch.from_numpy(E)
            j_val = jprd_eval.prd_evaluation(
                pairs, cache,
                lambda k, i: jrays.pixels_to_rays(cam, k[:, 0], k[:, 1], c2w=jnp.asarray(E[i])),
                jcam.get_intrinsic(cam), E,
                rays_gt=lambda k, i: jrays.rays_no_camera(H, W, f, jnp.asarray(E[i]),
                                                          k[:, 0], k[:, 1]),
                gt_K=K, gt_E=E, **kw)
            t_val = tprd_eval.prd_evaluation(
                pairs, t_cache,
                lambda k, i: trays.pixels_to_rays(t_cam, k[:, 0], k[:, 1], c2w=tE[i]),
                tcam.get_intrinsic(t_cam), E,
                rays_gt=lambda k, i: trays.rays_no_camera(H, W, f, tE[i], k[:, 0], k[:, 1]),
                gt_K=K, gt_E=E, device="cpu", **kw)
        assert np.isfinite(j_val) and j_val > 0
        np.testing.assert_allclose(t_val, j_val, rtol=1e-5)

    def test_gt_filter_alike(self):
        K, E, cache, t_cache, cam, t_cam, (H, W, f) = _prd_scene()
        m = cache.get(0, 1)
        jr = [jrays.rays_no_camera(H, W, f, jnp.asarray(E[i]), k[:, 0], k[:, 1])
              for i, k in ((0, m.kps0), (1, m.kps1))]
        tr = [trays.rays_no_camera(H, W, f, torch.from_numpy(E[i]), k[:, 0], k[:, 1])
              for i, k in ((0, m.kps0), (1, m.kps1))]
        j_keep = jprd_eval.filter_matches_with_gt(m.kps0, m.kps1, *jr, jnp.asarray(K),
                                                  jnp.asarray(E[:2]), "NeRF")
        t_keep = tprd_eval.filter_matches_with_gt(torch.from_numpy(m.kps0),
                                                  torch.from_numpy(m.kps1), *tr,
                                                  torch.from_numpy(K), torch.from_numpy(E[:2]),
                                                  "NeRF")
        np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))
        assert not t_keep[:6].any() and t_keep[6:].all()

    def test_val_needs_gt(self):
        _, E, _, t_cache, _, t_cam, _ = _prd_scene()
        with pytest.raises(ValueError, match="rays_gt"):
            tprd_eval.prd_evaluation(np.array([[0, 1]]), t_cache, None,
                                     tcam.get_intrinsic(t_cam), E, "val", "NeRF", device="cpu")


H = W = 16


def _build(seed=0):
    """A small train state (depth 2, width 16, 4+4 samples, a 16x16 camera
    over three images), its step and one fixed batch."""
    gen = torch.Generator().manual_seed(seed)
    model_cfg = NeRFConfig(depth=2, width=16, skips=(), multires=2, multires_views=2)
    render_cfg = RenderConfig(n_samples=4, n_importance=4, raw_noise_std=1.0)
    params = {"coarse": init_nerf_mlp(model_cfg, generator=gen, device="cpu"),
              "fine": init_nerf_mlp(model_cfg, generator=gen, device="cpu")}
    for x in named_leaves(params).values():
        x.requires_grad_(True)
    K = np.array([[20.0, 0, 8, 0], [0, 20.0, 8, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    E = np.tile(np.eye(4), (3, 1, 1))
    E[:, 2, 3] = [0.0, 0.1, 0.2]
    params["camera"] = tcam.trainable_camera(tcam.init_camera(
        K, E, tcam.CameraConfig(H=H, W=W, grid_size=4), device="cpu"))
    train_cfg = TrainConfig(weight_decay=0.1, near=2.0, far=6.0)
    optimizer = Optimizer.from_config(train_cfg)
    step = make_train_step(model_cfg, render_cfg, train_cfg, Curriculum(), optimizer)
    rng = np.random.RandomState(seed)
    batch = {"px": torch.from_numpy(rng.randint(0, W, 32).astype(np.float32)),
             "py": torch.from_numpy(rng.randint(0, H, 32).astype(np.float32)),
             "img_idx": torch.from_numpy(rng.randint(0, 3, 32)),
             "target": torch.from_numpy(rng.rand(32, 3).astype(np.float32))}
    return create_train_state(params, optimizer), step, batch


def _run(state, step, batch, n, first=0):
    for i in range(first, first + n):
        state, m = step(state, batch, torch.Generator().manual_seed(i))
    return state, m


def _assert_states_equal(a, b):
    la, lb = named_leaves(a.params), named_leaves(b.params)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k
        assert la[k].requires_grad == lb[k].requires_grad, k
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for moments in ("mu", "nu"):
        ma, mb = getattr(a.opt_state, moments), getattr(b.opt_state, moments)
        assert ma.keys() == mb.keys()
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (moments, k)


class TestCheckpoint:
    def test_round_trip_and_resume(self, tmp_path):
        state, step, batch = _build()
        state, _ = _run(state, step, batch, 3)
        path = tckpt.save_checkpoint(str(tmp_path), state)
        assert path.endswith("ckpt_000000003.pt")
        assert tckpt.list_checkpoint_steps(str(tmp_path)) == [3]
        template, _, _ = _build(seed=1)  # other weights, same shapes
        restored = tckpt.restore_checkpoint(str(tmp_path), template)
        _assert_states_equal(restored, state)
        assert restored.params["camera"].config == state.params["camera"].config
        # Training goes on identically from the restored state.
        s1, m1 = _run(state, step, batch, 1, first=99)
        s2, m2 = _run(restored, step, batch, 1, first=99)
        assert float(m1["loss"]) == float(m2["loss"])
        _assert_states_equal(s1, s2)

    def test_keep_prunes_old(self, tmp_path):
        state, step, batch = _build()
        for i in range(4):
            state, _ = _run(state, step, batch, 1, first=i)
            tckpt.save_checkpoint(str(tmp_path), state, keep=2)
        assert tckpt.list_checkpoint_steps(str(tmp_path)) == [3, 4]
        assert int(tckpt.restore_checkpoint(str(tmp_path), state, step=3).step) == 3

    def test_restore_none_when_empty(self, tmp_path):
        state, _, _ = _build()
        assert tckpt.restore_checkpoint(str(tmp_path / "nope"), state) is None

    def test_optim_meta_validated_on_restore(self, tmp_path):
        state, step, batch = _build()
        state, _ = _run(state, step, batch, 1)
        meta = {"camera_lrate_mult": 8.0, "camera_lrate_mult_until": 5000,
                "distortion_lrate_mult": 1.0, "distortion_lrate_mult_until": 0}
        tckpt.save_checkpoint(str(tmp_path), state, optim_meta=meta)
        assert tckpt.restore_checkpoint(str(tmp_path), state, optim_meta=dict(meta)).step == 1
        assert tckpt.restore_checkpoint(str(tmp_path), state) is not None
        with pytest.raises(ValueError, match="optimizer knobs"):
            tckpt.restore_checkpoint(str(tmp_path), state,
                                     optim_meta=dict(meta, camera_lrate_mult=1.0))

    def test_restore_rejects_other_shapes(self, tmp_path):
        state, _, _ = _build()
        tckpt.save_checkpoint(str(tmp_path), state)
        other, _, _ = _build()
        other.params["coarse"]["pts"][0]["w"] = torch.zeros(3, 3, requires_grad=True)
        with pytest.raises(ValueError, match="does not fit"):
            tckpt.restore_checkpoint(str(tmp_path), other)

    def test_merge_states_shape_guard(self):
        state, step, batch = _build()
        other, _ = _run(_build(seed=2)[0], step, batch, 2)
        merged = tckpt.merge_states(state, other)
        _assert_states_equal(merged, other)
        # A leaf of another shape keeps the template's.
        w = other.params["coarse"]["pts"][0]["w"]
        other.params["coarse"]["pts"][0]["w"] = torch.zeros(w.shape[0] + 1, w.shape[1])
        merged = tckpt.merge_states(state, other)
        assert merged.params["coarse"]["pts"][0]["w"] is state.params["coarse"]["pts"][0]["w"]
        assert merged.params["fine"]["pts"][0]["w"] is other.params["fine"]["pts"][0]["w"]
        # Different leaves altogether: the template as it is.
        del other.params["camera"]
        assert tckpt.merge_states(state, other) is state

    def test_partial_camera_restore(self):
        state, _, _ = _build()
        cam = state.params["camera"]
        trained = dataclasses.replace(cam, intrinsics_noise=torch.ones(4),
                                      extrinsics_noise=torch.ones_like(cam.extrinsics_noise),
                                      config=dataclasses.replace(cam.config, grid_size=8))
        merged = tckpt.restore_camera_partial(cam, trained, skip_extrinsics=True)
        assert torch.equal(merged.intrinsics_noise, torch.ones(4))
        assert merged.extrinsics_noise is cam.extrinsics_noise
        assert merged.config == cam.config
        merged = tckpt.restore_camera_partial(cam, trained, skip_extrinsics=False)
        assert torch.equal(merged.extrinsics_noise, torch.ones_like(cam.extrinsics_noise))
