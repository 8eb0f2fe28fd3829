"""The port's blender loader, LPIPS and reference-checkpoint conversion
against the JAX package's, on the CPU at small sizes.

- ``load_blender``: every field array-equal (6 RGBA views of 16x16, with
  and without the train-split noise); ``half_res`` (the 2x2 block mean)
  array-equal to the JAX loader's cv2 ``INTER_AREA`` resize on RGBA, odd
  sizes refused; ``pose_spherical`` within 1e-12; the NeRF driver's blender
  branch builds what JAX's builds (white compositing, near/far 2/6, the
  spherical path) and trains a step.
- LPIPS with seeded random VGG16 weights written to an ``.npz`` (no weights
  ship, none are downloaded): within relative 1e-5 of JAX's on 32x32 image
  pairs, 0 on equal images; the evaluations report it when
  ``SCNERF_LPIPS_WEIGHTS`` names the file.
- Every converter array-equal to JAX's, both ways; ``load_reference_checkpoint``
  on a ``.tar`` in the reference's layout (``torch.load(weights_only=True)``
  takes its optimizer state's dicts, lists and floats), anything else
  refused by name; the NeRF driver's ``.tar`` warm start equal to JAX's.
"""
import importlib
import os
import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from _torch_support import smooth_texture, write_blender_scene, write_llff_scene  # noqa: E402
from _torch_support import write_reference_tar  # noqa: E402
from scnerf_tpu.camera import model as jcam  # noqa: E402
from scnerf_tpu.core.config import experiment_from_flags as j_flags  # noqa: E402
from scnerf_tpu.core.config import load_experiment as j_load  # noqa: E402
from scnerf_tpu.data import blender as jblender  # noqa: E402
from scnerf_tpu.data.noise import NoiseConfig as JNoise  # noqa: E402
jlpips = importlib.import_module("scnerf_tpu.metrics.lpips")  # the package exports a function
from scnerf_tpu.tools import convert as jconv  # noqa: E402
from scnerf_tpu.train import driver as jdriver  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera import model as tcam  # noqa: E402
from scnerf_tpu_torch.core.config import experiment_from_flags as t_flags  # noqa: E402
from scnerf_tpu_torch.core.config import load_experiment as t_load  # noqa: E402
from scnerf_tpu_torch.data import blender as tblender  # noqa: E402
from scnerf_tpu_torch.data.noise import NoiseConfig  # noqa: E402
from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp  # noqa: E402
from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, init_nerfpp_net  # noqa: E402
from scnerf_tpu_torch.metrics import lpips as tlpips  # noqa: E402
from scnerf_tpu_torch.tools import convert as tconv  # noqa: E402
from scnerf_tpu_torch.train import driver as tdriver  # noqa: E402
from scnerf_tpu_torch.train.optim import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FERN = os.path.join(REPO, "configs", "llff", "fern_ours.txt")
BLENDER_FLAGS = {"dataset_type": "blender", "white_bkgd": True, "N_rand": 32, "N_samples": 4,
                 "N_importance": 4, "netdepth": 2, "netwidth": 16, "multires": 2,
                 "multires_views": 2, "camera_model": "pinhole_rot_noise_10k_rayo_rayd",
                 "ray_loss_type": "none", "testskip": 1, "i_print": 1, "i_weights": 10**6}
LLFF_SMALL = {"netdepth": 2, "netwidth": 16, "multires": 2, "multires_views": 2,
              "N_samples": 4, "N_importance": 4, "N_rand": 32, "llffhold": 4,
              "ray_loss_type": "none"}


def _quiet(*_):
    pass


def _tree_equal(got, want, path=""):
    """A port tree (tensors) equals a JAX one (arrays), leaf for leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _tree_equal(a, b, f"{path}/{i}")
    else:
        a = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(a, np.asarray(want), err_msg=path)
        assert a.dtype == np.asarray(want).dtype, path


def _dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


class TestBlender:
    @pytest.fixture(scope="class")
    def scene(self, tmp_path_factory):
        return write_blender_scene(tmp_path_factory.mktemp("blender") / "scene")

    @pytest.mark.parametrize("half_res", [False, True])
    @pytest.mark.parametrize("noisy", [False, True])
    def test_load_alike(self, scene, half_res, noisy):
        if half_res:
            pytest.importorskip("cv2")  # the JAX loader's resize
        kw = dict(intrinsic_scale=0.1, rotation_deg=3.0, translation=0.05) if noisy else {}
        t = tblender.load_blender(scene, half_res=half_res, noise=NoiseConfig(**kw),
                                  rng=np.random.RandomState(7))
        j = jblender.load_blender(scene, half_res=half_res, noise=JNoise(**kw),
                                  rng=np.random.RandomState(7))
        for name in ("images", "noisy_poses", "gt_poses", "render_poses", "gt_intrinsic"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        for a, b in zip(t.i_split, j.i_split):
            np.testing.assert_array_equal(a, b)
        assert (t.noisy_focal, t.H, t.W) == (j.noisy_focal, j.H, j.W)
        assert t.images.shape == (6,) + ((8, 8) if half_res else (16, 16)) + (4,)
        assert (t.noisy_poses[:, :3, :4] != t.gt_poses[:, :3, :4]).any() == noisy

    def test_half_res_refuses_odd_sizes(self):
        with pytest.raises(ValueError, match="even"):
            tblender.half_resolution(np.zeros((1, 15, 16, 4), np.float32))

    def test_pose_spherical_alike(self):
        for theta, phi, radius in ((-180.0, -30.0, 4.0), (37.5, -12.0, 3.2), (171.0, 45.0, 1.0)):
            np.testing.assert_allclose(tblender.pose_spherical(theta, phi, radius),
                                       jblender.pose_spherical(theta, phi, radius),
                                       rtol=0, atol=1e-12)
        assert tblender.spherical_render_poses().shape == (40, 4, 4)

    def test_driver_branch_alike_and_trains(self, scene, tmp_path):
        flags = dict(BLENDER_FLAGS, datadir=scene, basedir=str(tmp_path), expname="b")
        j = jdriver.build_experiment(j_flags(dict(flags), warn=_quiet))
        t = tdriver.build_experiment(t_flags(dict(flags), warn=_quiet), device="cpu")
        for name in ("images", "i_train", "i_test", "gt_intrinsic", "gt_poses", "noisy_poses",
                     "render_poses"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert (t.near, t.far, t.H, t.W, t.noisy_focal) == (j.near, j.far, j.H, j.W,
                                                             j.noisy_focal)
        assert t.images.shape[-1] == 3 and t.images.max() <= 1.0
        state, metrics = tdriver.train_loop(t, 1)
        assert state.step == 1 and np.isfinite(float(metrics["loss"]))


def lpips_weights(seed=0, path=None):
    """Seeded random VGG16 + head weights in the file layout of
    ``metrics/lpips.py`` (He-scaled convs, so activations stay O(1))."""
    rng = np.random.RandomState(seed)
    w, cin, ci, tap = {}, 3, 0, 0
    for item in tlpips._VGG16_PLAN:
        if item == "tap":
            w[f"lin{tap}_w"] = rng.uniform(0.0, 1.0, cin).astype(np.float32)
            tap += 1
        elif item != "M":
            w[f"conv{ci}_w"] = (rng.randn(3, 3, cin, item) * np.sqrt(2.0 / (9 * cin))).astype(
                np.float32)
            w[f"conv{ci}_b"] = (rng.randn(item) * 0.01).astype(np.float32)
            cin, ci = item, ci + 1
    w["shift"] = np.array([-0.030, -0.088, -0.188], np.float32)
    w["scale"] = np.array([0.458, 0.448, 0.450], np.float32)
    if path is not None:
        np.savez(path, **w)
    return w


class TestLpips:
    @pytest.fixture(scope="class")
    def weights(self, tmp_path_factory):
        path = str(tmp_path_factory.mktemp("lpips") / "vgg.npz")
        lpips_weights(path=path)
        return path

    @pytest.mark.parametrize("seed", [0, 1])
    def test_lpips_alike(self, weights, seed):
        rng = np.random.RandomState(seed)
        a = smooth_texture(rng, 32, 32).astype(np.float32)
        b = np.clip(a + rng.randn(32, 32, 3).astype(np.float32) * 0.1, 0, 1)
        tw = tlpips.load_weights(weights, device="cpu")
        jw = jlpips.load_weights(weights)
        got = float(tlpips.lpips(torch.from_numpy(a), torch.from_numpy(b), tw))
        want = float(jlpips.lpips(jnp.asarray(a), jnp.asarray(b), jw))
        assert got > 0 and np.isclose(got, want, rtol=1e-5, atol=0), (got, want)
        assert float(tlpips.lpips(torch.from_numpy(a), torch.from_numpy(a), tw)) == 0.0

    def test_available_and_reported(self, weights, tmp_path, monkeypatch):
        monkeypatch.delenv("SCNERF_LPIPS_WEIGHTS", raising=False)
        assert not tlpips.lpips_available() and tlpips.lpips_available(weights)
        scene = write_llff_scene(tmp_path / "scene", n_views=5, seed=2)
        cfg = t_load(FERN, dict(LLFF_SMALL, datadir=scene), warn=_quiet)
        exp = tdriver.build_experiment(cfg, device="cpu")
        assert "lpips" not in tdriver.evaluate_test_views(exp)
        monkeypatch.setenv("SCNERF_LPIPS_WEIGHTS", weights)
        res = tdriver.evaluate_test_views(exp, max_views=1)
        idx = int(exp.i_test[0])
        rgb = tdriver.render_image(exp, tdriver.aligned_eval_extrinsic(exp, idx))["rgb"]
        want = tlpips.lpips(torch.from_numpy(rgb), torch.from_numpy(exp.images[idx]),
                            tlpips.load_weights(device="cpu"))
        assert res["lpips"] == pytest.approx(float(want), rel=1e-6)


class Opaque:
    """An object ``torch.load(weights_only=True)`` refuses."""


def _nerf_state_dict(viewdirs=True, seed=0):
    cfg = NeRFConfig(depth=3, width=16, multires=2, multires_views=2, use_viewdirs=viewdirs)
    tree = init_nerf_mlp(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return tconv.params_to_torch_nerf(tree)


class TestConvert:
    @pytest.mark.parametrize("viewdirs", [True, False])
    def test_nerf_alike_both_ways(self, viewdirs):
        sd = _nerf_state_dict(viewdirs)
        t = tconv.torch_nerf_to_params(sd, depth=3)
        j = jconv.torch_nerf_to_params(sd, depth=3)
        _tree_equal(t, j)
        assert ("views" in t) == viewdirs
        _dicts_equal(tconv.params_to_torch_nerf(t), jconv.params_to_torch_nerf(j))
        _dicts_equal(tconv.params_to_torch_nerf(t, prefix=""),
                     jconv.params_to_torch_nerf(j, prefix=""))
        # Tensor values in, as torch.load gives them.
        _tree_equal(tconv.torch_nerf_to_params({k: torch.from_numpy(v) for k, v in sd.items()},
                                               depth=3), j)

    def test_nerfpp_alike_both_ways(self):
        cfg = NerfPPConfig(depth=3, width=16, skips=(1,), max_freq_log2=2,
                           max_freq_log2_viewdirs=2)
        level = init_nerfpp_net(cfg, n_images=3, autoexpo=True,
                                generator=torch.Generator().manual_seed(1), device="cpu")
        with torch.no_grad():
            level["autoexpo"].add_(torch.randn(3, 2, generator=torch.Generator().manual_seed(2)))
        paths = ["data/scene/train/rgb/000.png", "a.b/c/rgb/001.jpg", "x/y/z/002.png/"]
        sd = tconv.params_to_torch_nerfnet(level, img_paths=paths)
        jlevel = jax.tree.map(np.asarray, bridge.tree_to_numpy(level))
        _dicts_equal(sd, jconv.params_to_torch_nerfnet(jlevel, img_paths=paths))
        t = tconv.torch_nerfnet_to_params(sd, depth=3)
        j = jconv.torch_nerfnet_to_params(sd, depth=3)
        _tree_equal(t, j)
        _tree_equal(t, {k: jlevel[k] for k in ("fg", "bg")})
        _dicts_equal(tconv.params_to_torch_mlpnet(t["fg"], prefix="p."),
                     jconv.params_to_torch_mlpnet(j["fg"], prefix="p."))
        _tree_equal(tconv.torch_mlpnet_to_params(tconv.params_to_torch_mlpnet(t["bg"]), 3),
                    jconv.torch_mlpnet_to_params(jconv.params_to_torch_mlpnet(j["bg"]), 3))
        for p in paths + ["img.png", "/abs/one/two/three/four.PNG"]:
            assert tconv.remap_autoexpo_name(p) == jconv.remap_autoexpo_name(p), p
        with pytest.raises(ValueError, match="image paths"):
            tconv.params_to_torch_nerfnet(level)

    @pytest.mark.parametrize("distortion", [False, True])
    def test_camera_alike_both_ways(self, distortion):
        rng = np.random.RandomState(3)
        K = np.array([[30.0, 0, 16, 0], [0, 30.0, 12, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        poses = np.tile(np.eye(4), (2, 1, 1))
        poses[:, :3, 3] = rng.uniform(-0.3, 0.3, (2, 3))
        kw = dict(H=24, W=32, grid_size=8, use_distortion=distortion,
                  tied_ray_noise=distortion)
        j_cam = jcam.init_camera(K, poses, jcam.CameraConfig(**kw))
        j_cam = j_cam.replace(**{name: jnp.asarray(rng.randn(*getattr(j_cam, name).shape),
                                                   jnp.float32)
                                 for name in tcam.TRAINABLE_LEAVES})
        t_cam = bridge.camera_from_numpy(jax.tree.map(np.asarray, j_cam), device="cpu")
        sd = tconv.camera_fields_to_torch(t_cam)
        _dicts_equal(sd, jconv.camera_fields_to_torch(j_cam))
        assert ("distortion_noise" in sd) == distortion
        got = tconv.torch_camera_to_fields(sd)
        want = jconv.torch_camera_to_fields(sd)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)

    def test_load_reference_checkpoint_alike(self, tmp_path):
        cam = {"intrinsics_initial": np.array([30.0, 30.0, 16.0, 12.0], np.float32),
               "intrinsics_noise": np.array([0.1, -0.2, 0.0, 0.3], np.float32)}
        path = write_reference_tar(tmp_path / "ref.tar", _nerf_state_dict(seed=0),
                                   _nerf_state_dict(seed=1), camera=cam, step=4321)
        t = tconv.load_reference_checkpoint(path, depth=3, device="cpu")
        j = jconv.load_reference_checkpoint(path, depth=3)
        assert t["step"] == j["step"] == 4321
        _tree_equal(t["coarse"], j["coarse"])
        _tree_equal(t["fine"], j["fine"])
        _tree_equal(t["camera_fields"], j["camera_fields"])

    def test_refuses_other_files(self, tmp_path):
        bad = tmp_path / "bad.tar"
        with open(bad, "wb") as f:
            pickle.dump({"global_step": 1, "network_fn_state_dict": {}, "args": Opaque()}, f)
        with pytest.raises(ValueError, match="bad.tar"):
            tconv.load_reference_checkpoint(str(bad), device="cpu")
        other = tmp_path / "other.tar"
        torch.save({"model": {"w": torch.zeros(2)}}, str(other))
        with pytest.raises(ValueError, match="other.tar"):
            tconv.load_reference_checkpoint(str(other), device="cpu")


def test_tar_warm_start_alike(tmp_path, capsys):
    """``ft_path`` naming a reference ``.tar``: the converted weights and
    camera fields, a fresh optimizer state, the reference's step, on both
    packages alike; training goes on from there."""
    scene = write_llff_scene(tmp_path / "scene", n_views=5, seed=4)
    flags = dict(LLFF_SMALL, datadir=scene, netdepth=2, netwidth=16)
    base = tdriver.build_experiment(t_load(FERN, flags, warn=_quiet), device="cpu")
    cam = tconv.camera_fields_to_torch(base.state.params["camera"])
    cam["intrinsics_noise"] = np.array([0.5, -0.5, 0.2, 0.1], np.float32)
    cfg = NeRFConfig(depth=2, width=16, multires=2, multires_views=2)
    sds = [tconv.params_to_torch_nerf(init_nerf_mlp(
        cfg, generator=torch.Generator().manual_seed(s), device="cpu")) for s in (5, 6)]
    tar = write_reference_tar(tmp_path / "ref.tar", *sds, camera=cam, step=777)
    flags["ft_path"] = tar
    j = jdriver.build_experiment(j_load(FERN, flags, warn=_quiet))
    t = tdriver.build_experiment(t_load(FERN, flags, warn=_quiet), device="cpu")
    assert "[resume] converted reference checkpoint" in capsys.readouterr().out
    assert t.state.step == int(j.state.step) == 777 and t.state.opt_state.count == 0
    jp = jax.tree.map(np.asarray, j.state.params)
    _tree_equal(t.state.params["coarse"], jp["coarse"])
    _tree_equal(t.state.params["fine"], jp["fine"])
    for name, x in tcam.camera_leaves(t.state.params["camera"]).items():
        np.testing.assert_array_equal(x.detach().numpy(), getattr(jp["camera"], name),
                                      err_msg=name)
    assert float(t.state.params["camera"].intrinsics_noise[0].detach()) == 0.5
    for path, x in named_leaves(t.state.params).items():
        assert x.requires_grad == (tcam.FROZEN_LEAVES.count(path.rsplit("/", 1)[-1]) == 0), path
    state, metrics = tdriver.train_loop(t, 779)
    assert state.step == 779 and np.isfinite(float(metrics["loss"]))
