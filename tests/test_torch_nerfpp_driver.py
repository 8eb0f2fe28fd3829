"""The port's NeRF++ training driver against the JAX package's, on a seeded
NeRF++ scene (5 train views and 2 validation views of 16x20, OpenCV cameras
on an arc of a ring of radius 0.5, focal 14) with the Tanks&Temples Truck
config cut to small sizes: fg and bg nets 3x32, multires 4/2, cascade 8,8,
64 rays, eval chunks of 128 (so K2's plain twin runs in every step and
every render), the whole camera and PRD from step 0 on ``matches.npz``
projected from seeded points.

- ``load_nerfpp_split``: every field array-equal (16- and 18-float
  intrinsics, masks, min depth, ``testskip``, ``normalize_factor``, a split
  without ``rgb/``); ``check_cameras_in_unit_sphere`` raises alike.
- ``build_nerfpp_experiment``: the same data, camera, configs, curriculum,
  PRD switch, pairs and matches (exact); the ``prd_on_fisheye`` error; the
  ``load_camera_path`` transfer moves the same camera leaves.
- ``nerfpp_sample_batch``: five draws exactly equal (rays within 1e-6),
  with and without a camera, with mask and min depth; the batches the loop
  hands its step functions over 8 steps (PRD every second step, one pair
  without matches) exactly equal.
- From the JAX experiment's parameters carried across (a noisy camera):
  ``render_nerfpp_image`` on its three ray paths, median |err| < 1e-6, 99th
  percentile < 1e-5, max < 1e-3 (the last deterministic u is exactly 1.0,
  so a few samples flip between the packages); ``evaluate_nerfpp`` PSNR
  within 1e-4 dB and SSIM within 1e-5; ``evaluate_nerfpp_prd`` within
  relative 1e-5, with and without a camera.
- ``run_nerfpp_training`` on the CPU with every hook, K2 counted; two
  device-sampling runs from one seed.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from _torch_support import jax_prd_distances_in_float64  # noqa: E402
from _torch_support import project_opencv, write_nerfpp_scene  # noqa: E402
from scnerf_tpu.core.config import load_experiment as j_load  # noqa: E402
from scnerf_tpu.data import nerfpp_split as jsplit  # noqa: E402
from scnerf_tpu.matching import provider as jprovider  # noqa: E402
from scnerf_tpu.train import checkpoint as jckpt  # noqa: E402
from scnerf_tpu.train import nerfpp_driver as jpp  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera.model import camera_leaves  # noqa: E402
from scnerf_tpu_torch.core.config import load_experiment as t_load  # noqa: E402
from scnerf_tpu_torch.core.imaging import read_png  # noqa: E402
from scnerf_tpu_torch.data import nerfpp_split as tsplit  # noqa: E402
from scnerf_tpu_torch.matching import provider as tprovider  # noqa: E402
from scnerf_tpu_torch.render import nerfpp_renderer as trend  # noqa: E402
from scnerf_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from scnerf_tpu_torch.train import nerfpp_driver as tpp  # noqa: E402
from scnerf_tpu_torch.train.optim import Optimizer, named_leaves  # noqa: E402
from scnerf_tpu_torch.train.step import create_train_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUCK = os.path.join(REPO, "configs", "tanks_and_temples", "tat_training_Truck_ours.txt")
H, W = 16, 20
SMALL = {"scene": "", "netdepth": 3, "netwidth": 32, "max_freq_log2": 4,
         "max_freq_log2_viewdirs": 2, "cascade_samples": [8, 8], "N_rand": 64,
         "chunk_size": 128, "match_num": 32, "ray_loss_type": "proj_ray_dist", "add_ie": 0,
         "add_od": 0, "add_prd": 0, "matcher": "precomputed"}
SPLIT_FIELDS = ("images", "intrinsics", "poses", "k", "masks", "min_depths")


def _quiet(*_):
    pass


def projected_matches(K, poses, cache_cls, pair_cls, n_pts=40, seed=0):
    """Matches between every pair of ``poses``: seeded points near the
    origin projected into both cameras, those inside both images kept."""
    pts = np.random.RandomState(seed).uniform(-0.15, 0.15, (n_pts, 3))
    kps = [project_opencv(pts, c2w, K)[0] for c2w in poses]
    inside = [(k[:, 0] >= 0) & (k[:, 0] < W - 1) & (k[:, 1] >= 0) & (k[:, 1] < H - 1)
              for k in kps]
    cache = cache_cls()
    for i in range(len(poses)):
        for j in range(i + 1, len(poses)):
            keep = inside[i] & inside[j]
            cache.put(i, j, pair_cls(kps[i][keep], kps[j][keep]))
    return cache


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("nerfpp")
    cams = write_nerfpp_scene(root / "scene", splits=(("train", 5), ("validation", 2)),
                              H=H, W=W, seed=3)
    K, poses = cams["train"]
    projected_matches(K, poses, tprovider.PrecomputedMatches, tprovider.PairMatches).save(
        str(root / "matches.npz"))
    return str(root / "scene"), str(root / "matches.npz")


def _flags(scene, **extra):
    return dict(SMALL, datadir=scene[0], **extra)


def _expdir(tmp_path, name, scene):
    d = tmp_path / name
    d.mkdir()
    shutil.copy(scene[1], d / "matches.npz")
    return str(d)


def build_pair(tmp_path, scene, **extra):
    """The JAX and the port experiment of the Truck config with ``extra``
    flags, each in an experiment directory holding the scene's matches."""
    flags = _flags(scene, **extra)
    j = jpp.build_nerfpp_experiment(j_load(TRUCK, flags, warn=_quiet),
                                    _expdir(tmp_path, "jax", scene))
    t = tpp.build_nerfpp_experiment(t_load(TRUCK, flags, warn=_quiet),
                                    _expdir(tmp_path, "port", scene), device="cpu")
    return j, t


def assert_splits_equal(t, j):
    for name in SPLIT_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (t.img_names, t.H, t.W) == (j.img_names, j.H, j.W)


class TestSplit:
    @pytest.mark.parametrize("case", ["plain", "fisheye_masks_depth", "testskip", "normalize"])
    def test_load_alike(self, tmp_path, case):
        extra = {"fisheye_masks_depth": dict(k=(-0.12, 0.04), masks=True, min_depth=True)}
        write_nerfpp_scene(tmp_path, splits=(("train", 3), ("validation", 3)), H=H, W=W,
                           seed=1, **extra.get(case, {}))
        split, kwargs = {"testskip": ("validation", {"testskip": 2}),
                         "normalize": ("train", {"normalize_factor": 3.0})}.get(
                             case, ("train", {}))
        t = tsplit.load_nerfpp_split(str(tmp_path), split, **kwargs)
        j = jsplit.load_nerfpp_split(str(tmp_path), split, **kwargs)
        assert_splits_equal(t, j)
        assert t.images.shape == ((2 if case == "testskip" else 3), H, W, 3)
        assert (t.k is not None) == (case == "fisheye_masks_depth")
        assert (t.masks is not None) == (t.min_depths is not None) == (t.k is not None)

    def test_split_without_rgb(self, tmp_path):
        write_nerfpp_scene(tmp_path, splits=(("test", 2),), H=H, W=W)
        shutil.rmtree(tmp_path / "test" / "rgb")
        t = tsplit.load_nerfpp_split(str(tmp_path), "test")
        assert_splits_equal(t, jsplit.load_nerfpp_split(str(tmp_path), "test"))
        assert t.images is None and (t.H, t.W) == (0, 0)

    @pytest.mark.parametrize("radius", [0.9, 1.0, 1.5])
    def test_unit_sphere_check_alike(self, radius):
        poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        poses[1, :3, 3] = [0.0, radius, 0.0]
        if radius < 1.0:
            tsplit.check_cameras_in_unit_sphere(poses)
            jsplit.check_cameras_in_unit_sphere(poses)
            return
        with pytest.raises(ValueError) as t_err:
            tsplit.check_cameras_in_unit_sphere(poses)
        with pytest.raises(ValueError) as j_err:
            jsplit.check_cameras_in_unit_sphere(poses)
        assert str(t_err.value) == str(j_err.value)


class TestBuild:
    @pytest.mark.parametrize("camera", ["pinhole", "fisheye"])
    def test_experiment_alike(self, tmp_path, scene, camera, monkeypatch):
        extra = {} if camera == "pinhole" else {
            "camera_model": "fisheye", "run_fisheye": True, "prd_on_fisheye": True,
            "prd_undistort": True}
        seen = {}
        make_step, make_opt = jpp.make_nerfpp_train_step, jpp.make_optimizer

        def step_spy(model_cfg, render_cfg, train_cfg, *args, **kwargs):
            seen["train_cfg"] = train_cfg
            return make_step(model_cfg, render_cfg, train_cfg, *args, **kwargs)

        def opt_spy(*args, **kwargs):
            seen["optimizer"] = (args, kwargs)
            return make_opt(*args, **kwargs)

        monkeypatch.setattr(jpp, "make_nerfpp_train_step", step_spy)
        monkeypatch.setattr(jpp, "make_optimizer", opt_spy)
        j, t = build_pair(tmp_path, scene, **extra)
        assert_splits_equal(t.train_data, j.train_data)
        j_cam = jax.tree.map(np.asarray, j.state.params["camera"])
        t_cam = t.state.params["camera"]
        assert t_cam.config == bridge.convert_config(j_cam.config, type(t_cam.config))
        assert t_cam.config.tied_ray_noise == (camera == "fisheye")
        for name, x in camera_leaves(t_cam).items():
            np.testing.assert_array_equal(x.detach().numpy(), getattr(j_cam, name), err_msg=name)
        for name in ("model_cfg", "render_cfg", "curriculum"):
            port = getattr(t, name)
            assert port == bridge.convert_config(getattr(j, name), type(port)), name
        assert t.train_cfg == bridge.convert_config(seen["train_cfg"], type(t.train_cfg))
        (lr, decay_steps), knobs = seen["optimizer"]
        knobs.pop("params_example")
        assert t.optimizer == Optimizer(lr, decay_steps, **knobs)
        np.testing.assert_array_equal(t.pair_list, j.pair_list)
        assert len(t.pair_list) > 0 and t.match_cache.pairs() == j.match_cache.pairs() != []
        assert (t.step_prd_fn is None) == (j.step_prd_fn is None) is False
        assert t.device_step is None and j.device_step is None
        assert [x.shape for x in t.state.params["levels"][0]["fg"]["base"][0].values()] == [
            tuple(np.shape(x)) for x in j.state.params["levels"][0]["fg"]["base"][0].values()]

    def test_prd_on_fisheye_needs_the_distortion_aware_prd(self, tmp_path, scene):
        flags = _flags(scene, camera_model="fisheye", run_fisheye=True, prd_on_fisheye=True)
        with pytest.raises(ValueError) as t_err:
            tpp.build_nerfpp_experiment(t_load(TRUCK, flags, warn=_quiet), None, device="cpu")
        with pytest.raises(ValueError) as j_err:
            jpp.build_nerfpp_experiment(j_load(TRUCK, flags, warn=_quiet), None)
        assert str(t_err.value) == str(j_err.value)

    @pytest.mark.parametrize("load_test", [False, True])
    def test_load_camera_path_transfer_alike(self, tmp_path, scene, load_test):
        """A calibrated camera saved by each package moves into a new
        experiment: every field but the extrinsics, which follow only with
        ``load_test``."""
        j, t = build_pair(tmp_path, scene)
        rng = np.random.RandomState(4)
        noisy = {name: rng.randn(*getattr(t.state.params["camera"], name).shape).astype(
            np.float32) for name in ("intrinsics_noise", "extrinsics_noise", "ray_o_grid")}
        cam = j.state.params["camera"].replace(**{k: jnp.asarray(v) for k, v in noisy.items()})
        j.state = j.state.replace(params=dict(j.state.params, camera=cam))
        jckpt.save_checkpoint(str(tmp_path / "jax_ck"), j.state)
        with torch.no_grad():
            for name, v in noisy.items():
                getattr(t.state.params["camera"], name).copy_(torch.from_numpy(v))
        tckpt.save_checkpoint(str(tmp_path / "port_ck"), t.state)
        flags = _flags(scene, load_test=load_test)
        j2 = jpp.build_nerfpp_experiment(
            j_load(TRUCK, dict(flags, load_camera_path=str(tmp_path / "jax_ck")), warn=_quiet))
        t2 = tpp.build_nerfpp_experiment(
            t_load(TRUCK, dict(flags, load_camera_path=str(tmp_path / "port_ck")), warn=_quiet),
            device="cpu")
        got = camera_leaves(t2.state.params["camera"])
        for name, x in got.items():
            want = np.asarray(getattr(j2.state.params["camera"], name))
            np.testing.assert_array_equal(x.detach().numpy(), want, err_msg=name)
            moved = name in noisy and (load_test or name != "extrinsics_noise")
            assert moved == bool(x.abs().sum() > 0) or name.endswith("init"), name
        assert t2.state.opt_state.count == 0 and got["extrinsics_noise"].requires_grad


def _assert_batches_equal(t, j):
    assert t.keys() == j.keys()
    for k in j:
        a, b = t[k].numpy(), np.asarray(j[k])
        assert a.shape == b.shape, k
        if k.startswith("rays"):
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)


class TestSampling:
    @pytest.mark.parametrize("mode", ["camera", "no_camera", "mask_min_depth"])
    def test_first_draws_alike(self, tmp_path, mode):
        write_nerfpp_scene(tmp_path / "s", splits=(("train", 4),), H=H, W=W, seed=2,
                           masks=True, min_depth=True)
        extra = {"camera": {}, "no_camera": {"camera_model": "none"},
                 "mask_min_depth": {"mask_train_loss": True}}[mode]
        flags = dict(SMALL, datadir=str(tmp_path / "s"), ray_loss_type="none", **extra)
        j = jpp.build_nerfpp_experiment(j_load(TRUCK, flags, warn=_quiet))
        t = tpp.build_nerfpp_experiment(t_load(TRUCK, flags, warn=_quiet), device="cpu")
        for _ in range(5):
            got, want = tpp.nerfpp_sample_batch(t), jpp.nerfpp_sample_batch(j)
            _assert_batches_equal(got, want)
            assert got["img_idx"].ndim == 0
        assert ("rays_o" in got) == (mode == "no_camera")
        assert ("mask" in got) == (mode == "mask_min_depth")
        assert (got["min_depth"] != np.float32(1e-4)).any()

    def test_loop_hands_the_steps_alike(self, tmp_path, scene):
        """The batches (and which step gets them) over 8 steps, PRD every
        second step, the pair (0, 1) without matches: the image, pixel and
        pair draws come from one RandomState in the JAX order."""
        j, t = build_pair(tmp_path, scene, i_ray_dist_loss=2, i_print=10**6,
                          i_weights=10**6, i_testset=10**6, i_img=10**6, camera_log=10**6)
        for exp, pair_cls in ((j, jprovider.PairMatches), (t, tprovider.PairMatches)):
            exp.match_cache.put(0, 1, pair_cls(np.zeros((0, 2), np.float32),
                                               np.zeros((0, 2), np.float32)))
        seen = {"jax": [], "port": []}

        def recorder(log, kind, to_np):
            def step(state, batch, key):
                log.append((kind, {k: to_np(v) for k, v in batch.items()}))
                return state, {}
            return step

        for exp, name, to_np in ((j, "jax", np.asarray), (t, "port", lambda v: v.numpy())):
            exp.step_fn = recorder(seen[name], "plain", to_np)
            exp.step_prd_fn = recorder(seen[name], "prd", to_np)
        jpp.run_nerfpp_training(j.cfg, str(tmp_path / "jax"), n_steps=8, exp=j)
        tpp.run_nerfpp_training(t.cfg, str(tmp_path / "port"), n_steps=8, exp=t)
        kinds = [kind for kind, _ in seen["port"]]
        assert kinds == [kind for kind, _ in seen["jax"]]
        # PRD on even steps; step 6 draws the pair without matches.
        assert kinds == ["prd", "plain"] * 3 + ["plain", "plain"]
        assert "kps0" not in seen["port"][6][1] and seen["port"][6][1]["px"].shape == (64,)
        for (_, got), (_, want) in zip(seen["port"], seen["jax"]):
            _assert_batches_equal({k: torch.from_numpy(np.asarray(v)) for k, v in got.items()},
                                  want)


def assert_eval_maps_close(got, want, key):
    """Eval-mode limits: median 1e-6, 99th percentile 1e-5, max 1e-3."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).ravel()
    assert np.median(err) < 1e-6, (key, np.median(err))
    assert np.percentile(err, 99.0) < 1e-5, (key, np.percentile(err, 99.0))
    assert err.max() < 1e-3, (key, err.max())


def _carried(j, t, seed=3):
    """A noisy camera on the JAX side, and the port's experiment on the same
    parameters with a fresh optimizer state."""
    rng = np.random.RandomState(seed)
    cam = j.state.params["camera"]
    noisy = {name: jnp.asarray(rng.randn(*getattr(cam, name).shape) * scale, jnp.float32)
             for name, scale in (("intrinsics_noise", 0.02), ("extrinsics_noise", 0.01),
                                 ("ray_o_grid", 1.0), ("ray_d_grid", 1.0))}
    j.state = j.state.replace(params=dict(j.state.params, camera=cam.replace(**noisy)))
    params = bridge.train_params_to_torch(jax.tree.map(np.asarray, j.state.params),
                                          device="cpu")
    t.state = create_train_state(params, t.optimizer)


class TestEvaluation:
    @pytest.fixture(scope="class")
    def pair(self, tmp_path_factory, scene):
        j, t = build_pair(tmp_path_factory.mktemp("eval"), scene)
        _carried(j, t)
        return j, t

    @pytest.mark.parametrize("path", ["index", "c2w", "fixed"])
    def test_render_image_alike(self, pair, path):
        j, t = pair
        held = jpp._held_out_data(j)
        kwargs = {"index": dict(img_idx=2),
                  "c2w": dict(c2w=held.poses[1], K=held.intrinsics[1], hw=(H, W)),
                  "fixed": dict(c2w=held.poses[0], K=held.intrinsics[0], resolution_level=2)}[path]
        assert tpp._ray_path(t, kwargs.get("img_idx"), kwargs.get("c2w"),
                             kwargs.get("resolution_level", 1), kwargs.get("hw"))[0] == path
        want = jpp.render_nerfpp_image(j, **kwargs)
        got = tpp.render_nerfpp_image(t, **kwargs)
        assert got.keys() == want.keys() == set(trend.LAST_LEVEL_MAPS)
        size = (H // 2, W // 2) if path == "fixed" else (H, W)
        for k in want:
            assert got[k].shape == want[k].shape == size + want[k].shape[2:], k
            assert_eval_maps_close(got[k], want[k], k)

    def test_render_pixels_is_the_image(self, pair):
        _, t = pair
        img = tpp.render_nerfpp_image(t, img_idx=1)
        pick = np.random.RandomState(0).choice(H * W, 37, replace=False)
        px = torch.from_numpy((pick % W).astype(np.float32))
        py = torch.from_numpy((pick // W).astype(np.float32))
        flat = tpp.render_nerfpp_pixels(t, px, py, img_idx=1)
        np.testing.assert_allclose(flat["rgb"].numpy(), img["rgb"].reshape(-1, 3)[pick],
                                   atol=1e-6)

    @pytest.mark.parametrize("data", ["heldout", "train"])
    def test_evaluate_nerfpp_alike(self, pair, data):
        j, t = pair
        want = jpp.evaluate_nerfpp(j, max_views=2, data=j.train_data if data == "train" else None)
        got = tpp.evaluate_nerfpp(t, max_views=2, data=t.train_data if data == "train" else None)
        assert got.keys() == want.keys() == {"psnr", "ssim", "n_views", "split"}
        assert (got["split"], got["n_views"]) == (want["split"], want["n_views"]) == (data, 2)
        assert abs(got["psnr"] - want["psnr"]) < 1e-4
        assert abs(got["ssim"] - want["ssim"]) < 1e-5

    @pytest.mark.parametrize("camera", [True, False])
    def test_evaluate_nerfpp_prd_alike(self, tmp_path, scene, pair, camera, monkeypatch):
        # Distances in float64 on both sides, as the port's driver computes them.
        jax_prd_distances_in_float64(monkeypatch)
        if camera:
            j, t = pair
        else:
            j, t = build_pair(tmp_path, scene, camera_model="none")
            assert t.match_cache is None
            K, poses = t.train_data.intrinsics[0], t.train_data.poses
            for exp, mod in ((j, jprovider), (t, tprovider)):
                exp.match_cache = projected_matches(K, poses, mod.PrecomputedMatches,
                                                    mod.PairMatches)
                exp.pair_list = np.array(exp.match_cache.pairs())
        want, got = jpp.evaluate_nerfpp_prd(j), tpp.evaluate_nerfpp_prd(t)
        assert want.keys() == got.keys() == {"prd"}
        np.testing.assert_allclose(got["prd"], want["prd"], rtol=1e-5)


class TestLoop:
    def test_run_with_every_hook(self, tmp_path, scene, monkeypatch):
        flags = _flags(scene, i_print=1, i_weights=3, i_testset=6, i_img=6, camera_log=3,
                       i_ray_dist_loss=2)
        expdir = _expdir(tmp_path, "hooks", scene)
        exp = tpp.build_nerfpp_experiment(t_load(TRUCK, flags, warn=_quiet), expdir,
                                          device="cpu")
        calls = []
        diff = trend.sample_pdf_diff

        def counting(bins, *args, **kwargs):
            calls.append(bins.shape[0])
            return diff(bins, *args, **kwargs)

        monkeypatch.setattr(trend, "sample_pdf_diff", counting)
        state, metrics = tpp.run_nerfpp_training(exp.cfg, expdir, n_steps=6, exp=exp)
        assert state.step == 6 and np.isfinite(float(metrics["loss"]))
        # K2 (its plain twin on the CPU): fg and bg at level 1 of each step,
        # and of each chunk of the three renders at step 6 (two held-out
        # views for i_testset, one for i_img).
        chunks = -(-H * W // 128)
        assert calls == [64] * 12 + [128] * (3 * chunks * 2), calls
        assert tckpt.list_checkpoint_steps(os.path.join(expdir, "ckpts")) == [3, 6]
        rows = [json.loads(line) for line in open(os.path.join(expdir, "metrics.jsonl"))]
        keys = set().union(*rows)
        for k in ("loss", "psnr", "mse_0", "mse_1", "prd", "prd_matches", "test/psnr",
                  "test/ssim", "test/prd", "test/n_views", "test/split", "camera/fx",
                  "camera/fx_err", "camera/ray_o_noise_mean"):
            assert k in keys, k
        for row in rows:
            assert all(np.isfinite(v) for v in row.values() if isinstance(v, float)), row
        assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4, 5, 6]
        prd_rows = [r for r in rows if "prd" in r]
        assert [r["step"] for r in prd_rows] == [1, 3, 5] and prd_rows[0]["prd_matches"] > 0
        assert [r["test/split"] for r in rows if "test/split" in r] == ["heldout"]
        images = os.path.join(expdir, "images")
        for name in ("val_rgb", "val_fg_rgb", "val_bg_rgb", "val_fg_depth"):
            assert read_png(os.path.join(images, f"{name}_00000006.png")).shape == (H, W, 3)
        assert os.path.exists(os.path.join(images, "camera_ray_o_noise_00000003.png"))

    def test_device_sampling_runs_alike(self, tmp_path, scene):
        """Batches drawn by the step's own generator: two runs from one seed
        end on equal parameters."""
        flags = _flags(scene, device_sampling=True, ray_loss_type="none", i_print=10**6,
                       i_weights=10**6, i_testset=10**6, i_img=10**6, camera_log=10**6)
        runs = []
        for name in ("a", "b"):
            exp = tpp.build_nerfpp_experiment(t_load(TRUCK, flags, warn=_quiet), device="cpu")
            assert exp.device_step is not None
            tpp.run_nerfpp_training(exp.cfg, str(tmp_path / name), n_steps=3, exp=exp)
            runs.append(named_leaves(exp.state.params))
        for k in runs[0]:
            assert torch.equal(runs[0][k], runs[1][k]), k
        assert not torch.equal(runs[0]["camera/extrinsics_noise"],
                               torch.zeros_like(runs[0]["camera/extrinsics_noise"]))


def test_nerfpp_train_config_alike(scene):
    """The driver's configs equal those of a JAX experiment built from the
    same flags, the lr floor and the weight decay included."""
    flags = _flags(scene, use_custom_optim=True, non_linear_weight_decay=0.1)
    t = tpp.build_nerfpp_experiment(t_load(TRUCK, flags, warn=_quiet), device="cpu")
    assert t.train_cfg.weight_decay == 0.1 and t.optimizer.weight_decay == 0.1
    assert t.optimizer.lr_floor == pytest.approx(0.01 * t.train_cfg.lr_init)
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j_load(TRUCK, flags, warn=_quiet))
