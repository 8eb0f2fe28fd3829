"""The port's four examples (``scnerf_tpu_torch/examples/``) on the CPU.

Each ``main`` runs a few steps at a tiny size (``small``: 20x20 images, 64
rays a step; the distortion rig as it is) and returns finite outcomes; the
scenes they train on are held to the JAX functions
they come from: the calibration ablation's GT images to JAX's
``raw2outputs`` over the same field, its noise and matches to JAX's
``inject_pose_noise`` and the example's projection, the from-scratch rig's
poses to JAX's ``axis_angle_to_rotation``, and the distortion rig's
correspondences to ``examples/distortion_discovery.py:build_rig``.
Tolerances: GT renders 1e-5 (float32, the field's terms summed in the same
order, the rays' products in another); poses 1e-6; keypoints 1e-3 pixels
(the inverse-distortion lookup divides by table gaps of ~2.5 pixels).
"""
import importlib.util
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from _torch_support import one_thread  # noqa: E402,F401
from scnerf_tpu.camera.rays import rays_no_camera as j_rays_no_camera  # noqa: E402
from scnerf_tpu.data.noise import NoiseConfig, inject_pose_noise  # noqa: E402
from scnerf_tpu.geometry.so3 import axis_angle_to_rotation as j_axis_angle  # noqa: E402
from scnerf_tpu.render.composite import raw2outputs as j_raw2outputs  # noqa: E402
from scnerf_tpu.sampling.stratified import stratified_z_vals as j_stratified  # noqa: E402
from scnerf_tpu_torch.examples import (  # noqa: E402
    _common,
    calibration_ablation,
    distortion_discovery,
    from_scratch_calibration,
    self_calibration_demo,
)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = [calibration_ablation, self_calibration_demo, from_scratch_calibration,
            distortion_discovery]


def _jax_field(pts):
    """``examples/calibration_ablation.py``'s field, as it is written there."""
    c1 = jnp.array([0.5, 0.2, -0.1])
    c2 = jnp.array([-0.6, -0.3, 0.3])
    c3 = jnp.array([0.0, 0.6, 0.5])
    d1 = jnp.sum((pts - c1) ** 2, -1)
    d2 = jnp.sum((pts - c2) ** 2, -1)
    d3 = jnp.sum((pts - c3) ** 2, -1)
    sigma = 40 * jnp.exp(-d1 / 0.08) + 35 * jnp.exp(-d2 / 0.1) + 30 * jnp.exp(-d3 / 0.05)
    rgb = (jnp.exp(-d1 / 0.08)[..., None] * jnp.array([4., -4, -4])
           + jnp.exp(-d2 / 0.1)[..., None] * jnp.array([-4., 4, -4])
           + jnp.exp(-d3 / 0.05)[..., None] * jnp.array([-4., -4, 4.]))
    return jnp.concatenate([rgb, sigma[..., None]], -1)


def _jax_gt_image(rig, c2w, near, far):
    """The examples' ``render_gt_image``, through JAX's rays, stratified
    depths and ``raw2outputs``."""
    H, W, F = rig.H, rig.W, rig.F
    py, px = np.mgrid[0:H, 0:W]
    px = jnp.asarray(px.reshape(-1), jnp.float32)
    py = jnp.asarray(py.reshape(-1), jnp.float32)
    o, d = j_rays_no_camera(H, W, F, jnp.asarray(c2w, jnp.float32), px, py)
    z = j_stratified(None, jnp.full((H * W,), near), jnp.full((H * W,), far), 128,
                     perturb=False)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    return np.asarray(j_raw2outputs(_jax_field(pts), z, d, white_bkgd=False)["rgb"]
                      ).reshape(H, W, 3)



@pytest.fixture(scope="module")
def ablation_scene():
    return calibration_ablation.build_scene(_common.SMALL, "cpu")


class TestScenes:
    def test_calibration_ablation_gt_images(self, ablation_scene):
        images = ablation_scene["images"]
        assert images.shape == (14, 20, 20, 3) and images.dtype == np.float32
        for i in (0, 5, 11):
            np.testing.assert_allclose(
                images[i], _jax_gt_image(_common.SMALL, ablation_scene["gt_poses"][i], 2.0, 5.5),
                rtol=1e-5, atol=1e-5)

    def test_calibration_ablation_noise_and_matches(self, ablation_scene):
        """The noise and the exact matches of the JAX example: its
        ``RandomState(0)`` drawn in the same order."""
        rng = np.random.RandomState(0)
        gt = ablation_scene["gt_poses"]
        i_train = ablation_scene["i_train"]
        assert ablation_scene["i_test"].tolist() == [0, 7] and len(i_train) == 12
        noise = NoiseConfig(intrinsic_scale=0.10, rotation_deg=3.0, translation=0.10)
        noisy, focal = inject_pose_noise(gt[:, :3, :4], 18.0, i_train, noise, rng)
        np.testing.assert_array_equal(ablation_scene["noisy_poses"], noisy)
        assert ablation_scene["noisy_focal"] == focal == pytest.approx(19.8)
        pts3d = rng.randn(400, 3) * 0.5
        H, W, F = 20, 20, 18.0

        def project(E):  # the JAX example's
            cam = (pts3d - E[:3, 3]) @ E[:3, :3]
            zc = -cam[:, 2]
            u = W / 2 + F * cam[:, 0] / zc
            v = H / 2 - F * cam[:, 1] / zc
            ok = (zc > 0.5) & (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
            return np.stack([u, v], -1), ok

        pairs = []
        for a in range(len(i_train)):
            b = (a + 1) % len(i_train)
            pa, oka = project(gt[i_train[a]])
            pb, okb = project(gt[i_train[b]])
            ok = oka & okb
            if ok.sum() >= 16:
                pairs.append((min(a, b), max(a, b)))
                got = ablation_scene["cache"].get(a, b)
                np.testing.assert_array_equal(got.kps0, pa[ok].astype(np.float32))
                np.testing.assert_array_equal(got.kps1, pb[ok].astype(np.float32))
        assert ablation_scene["pair_list"] == pairs and len(pairs) == 12

    def test_from_scratch_poses(self):
        rng = np.random.RandomState(0)
        got = from_scratch_calibration.forward_facing_poses(np.random.RandomState(0))
        for i in range(from_scratch_calibration.N_IMG):
            ax = rng.randn(3)
            ax /= np.linalg.norm(ax)
            R = np.asarray(j_axis_angle(jnp.asarray(ax[None]),
                                        jnp.asarray([rng.uniform(-0.06, 0.06)])))[0]
            t = [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), 4.0 + rng.uniform(-0.3, 0.3)]
            np.testing.assert_allclose(got[i, :3, :3], R, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(got[i, :3, 3], t)

    def test_distortion_rig(self):
        spec = importlib.util.spec_from_file_location(
            "jax_distortion_discovery", REPO / "examples" / "distortion_discovery.py")
        j_example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(j_example)
        K, E, pairs = distortion_discovery.build_rig()
        jK, jE, j_pairs = j_example.build_rig()
        np.testing.assert_array_equal(K, jK)
        np.testing.assert_allclose(E, jE, rtol=0, atol=1e-6)
        assert [(i, j) for i, j, _, _ in pairs] == [(i, j) for i, j, _, _ in j_pairs]
        assert len(pairs) == 6
        for (_, _, k0, k1), (_, _, jk0, jk1) in zip(pairs, j_pairs):
            assert k0.shape == jk0.shape == (128, 2)
            np.testing.assert_allclose(k0, jk0, rtol=0, atol=1e-3)
            np.testing.assert_allclose(k1, jk1, rtol=0, atol=1e-3)




class TestMains:
    def test_calibration_ablation(self):
        out = calibration_ablation.main(steps=3, device="cpu", small=True)
        assert _common.all_finite(out) and out["steps"] == 3
        for arm in ("with_camera", "without_camera"):
            assert len(out[arm]["per_view_psnr"]) == 2
            assert out[arm]["loss_last"] < out[arm]["loss_first"]
        assert out["gain_db"] == out["with_camera"]["psnr"] - out["without_camera"]["psnr"]

    def test_self_calibration_demo(self):
        out = self_calibration_demo.main(steps=3, device="cpu", small=True)
        assert _common.all_finite(out) and out["loss_last"] < out["loss_first"]
        # The focal starts 10% off: 1.8 pixels of 18.
        assert out["prd_first"] > 0 and out["focal_err_initial"] == pytest.approx(1.8)
        assert [row["it"] for row in out["curve"]] == [0]

    def test_from_scratch_calibration(self):
        out = from_scratch_calibration.main(steps=3, device="cpu", small=True)
        assert _common.all_finite(out) and out["loss_last"] < out["loss_first"]
        # From identity the cameras start some 100 degrees off.
        assert out["rot_err_initial"] > 90.0

    def test_distortion_discovery(self):
        out = distortion_discovery.main(steps=3, device="cpu")
        assert _common.all_finite(out) and out["k_initial"] == [0.0, 0.0]
        assert out["k_err_initial"] == pytest.approx(0.08)
        assert out["k_err_final"] < out["k_err_initial"]
        assert out["prd_final"] < out["prd_initial"]
        # The JAX example's PRD at k = 0 (its docstring: 1.60 px^2).
        assert out["prd_initial"] == pytest.approx(1.598, abs=1e-3)


@pytest.mark.parametrize("module", EXAMPLES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_defaults_to_the_card(module):
    params = inspect.signature(module.main).parameters
    assert params["device"].default == "cuda" and params["steps"].default is None
    assert module is distortion_discovery or params["small"].default is False


@pytest.mark.parametrize("module", EXAMPLES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cli_needs_the_card_or_device_cpu(module, monkeypatch, capsys):
    """Without a card the examples exit 2 unless given ``--device cpu``."""
    import runpy
    import warnings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [module.__name__])
    with warnings.catch_warnings(), pytest.raises(SystemExit) as exit_:
        warnings.simplefilter("ignore", RuntimeWarning)  # the module is imported already
        runpy.run_module(module.__name__, run_name="__main__")
    assert exit_.value.code == 2
    assert "pass --device cpu" in capsys.readouterr().err
