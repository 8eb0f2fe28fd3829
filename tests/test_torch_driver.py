"""The port's NeRF training driver and CLI against the JAX package's, on a
seeded LLFF scene (9 views at 24x32, every fourth held out) at small sizes:
NeRF depth 2, width 16, multires 2/2, 4+4 samples (so K1's plain twin runs
in every step and every render), with ``matches.npz`` projected through the
ground-truth poses.

- ``build_experiment`` on the same flags: the same images, poses, splits,
  near/far, size, camera initialisation, pairs and configs (exact: numpy on
  both sides, float32 camera leaves built by the same arithmetic).
- The first five ``sample_batch`` and ``sample_prd_batch`` draws in the
  ``PixelPool``, single-image and no-camera modes: exactly equal, rays
  within 1e-6.
- From the JAX experiment's parameters carried across (a noisy camera):
  ``render_image`` with the eval-mode limits of
  ``tests/test_torch_render_serve.py`` (median |err| < 1e-6, 99th
  percentile < 1e-4, max < 1e-2), ``evaluate_test_views`` (PSNR within
  1e-3 dB, SSIM within 1e-5), ``aligned_eval_extrinsic`` within 1e-5,
  ``evaluate_prd`` and ``evaluate_prd_split`` on injected matches within
  relative 1e-5.
- ``train_loop`` with every hook, the CLI with a resume, the per-step
  generator, and the parts of later slices that must raise.
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
from _torch_support import write_llff_scene  # noqa: E402
from scnerf_tpu.core.config import experiment_from_flags as j_flags  # noqa: E402
from scnerf_tpu.matching import provider as jprovider  # noqa: E402
from scnerf_tpu.train import driver as jdriver  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera.model import camera_leaves  # noqa: E402
from scnerf_tpu_torch.cli import train as tcli  # noqa: E402
from scnerf_tpu_torch.core.config import experiment_from_flags as t_flags  # noqa: E402
from scnerf_tpu_torch.core.imaging import read_png  # noqa: E402
from scnerf_tpu_torch.data.llff import load_llff  # noqa: E402
from scnerf_tpu_torch.matching import provider as tprovider  # noqa: E402
from scnerf_tpu_torch.render import renderer as trend  # noqa: E402
from scnerf_tpu_torch.train import driver as tdriver  # noqa: E402
from scnerf_tpu_torch.train.checkpoint import list_checkpoint_steps  # noqa: E402
from scnerf_tpu_torch.train.optim import named_leaves  # noqa: E402
from scnerf_tpu_torch.train.step import create_train_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FERN = os.path.join(REPO, "configs", "llff", "fern_ours.txt")
SMALL = {"netdepth": 2, "netwidth": 16, "multires": 2, "multires_views": 2,
         "N_samples": 4, "N_importance": 4, "N_rand": 64, "llffhold": 4, "match_num": 32,
         "add_ie": 0, "add_od": 0, "add_prd": 0, "i_ray_dist_loss": 2, "matcher": "precomputed"}


def _quiet(*_):
    pass


def project_opengl(pts, c2w, K):
    """Pixel coordinates of world points through an OpenGL camera (the
    inverse of ``pixels_to_rays`` with pixel offset 0)."""
    cam = (pts - c2w[:3, 3]) @ c2w[:3, :3]
    u = K[0, 2] + K[0, 0] * cam[:, 0] / (-cam[:, 2])
    v = K[1, 2] - K[1, 1] * cam[:, 1] / (-cam[:, 2])
    return np.stack([u, v], -1).astype(np.float32)


def projected_matches(poses, K, H, W, n_pts=40, seed=0):
    """Matches between every pair of ``poses``: seeded points in front of
    the cameras projected into both, those inside both images kept."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform([-0.8, -0.6, -3.5], [0.8, 0.6, -2.0], (n_pts, 3))
    kps = [project_opengl(pts, c2w, K) for c2w in poses]
    inside = [(k[:, 0] >= 0) & (k[:, 0] < W) & (k[:, 1] >= 0) & (k[:, 1] < H) for k in kps]
    cache = tprovider.PrecomputedMatches()
    for i in range(len(poses)):
        for j in range(i + 1, len(poses)):
            keep = inside[i] & inside[j]
            cache.put(i, j, tprovider.PairMatches(kps[i][keep], kps[j][keep]))
    return cache


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver")
    scene = write_llff_scene(root / "scene", n_views=9, seed=5)
    d = load_llff(scene, factor=8, llffhold=4)
    cache = projected_matches(d.gt_poses[d.i_train], d.gt_intrinsic, d.H, d.W)
    cache.save(str(root / "matches.npz"))
    return scene, str(root / "matches.npz")


def _flags(scene, **extra):
    return dict(SMALL, datadir=scene[0], **extra)


def _expdir(tmp_path, name, scene):
    d = tmp_path / name
    d.mkdir()
    shutil.copy(scene[1], d / "matches.npz")
    return str(d)


def build_pair(tmp_path, scene, **extra):
    """The JAX and the port experiment of the fern config with ``extra``
    flags, each in an experiment directory holding the scene's matches."""
    from scnerf_tpu.core.config import load_experiment as j_load

    from scnerf_tpu_torch.core.config import load_experiment as t_load

    flags = _flags(scene, **extra)
    j = jdriver.build_experiment(j_load(FERN, flags, warn=_quiet),
                                 _expdir(tmp_path, "jax", scene))
    t = tdriver.build_experiment(t_load(FERN, flags, warn=_quiet),
                                 _expdir(tmp_path, "port", scene), device="cpu")
    return j, t


class TestBuild:
    @pytest.mark.parametrize("noise", [False, True])
    def test_experiment_alike(self, tmp_path, scene, noise):
        extra = ({"initial_noise_size_intrinsic": 0.05, "initial_noise_size_rotation": 2.0,
                  "initial_noise_size_translation": 0.02} if noise else {})
        j, t = build_pair(tmp_path, scene, **extra)
        for name in ("images", "i_train", "i_test", "gt_intrinsic", "gt_poses", "noisy_poses",
                     "render_poses", "pair_list"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        for name in ("noisy_focal", "near", "far", "H", "W"):
            assert getattr(t, name) == getattr(j, name), name
        assert (t.H, t.W, list(t.i_test)) == (24, 32, [0, 4, 8])
        j_cam = jax.tree.map(np.asarray, j.state.params["camera"])
        t_cam = t.state.params["camera"]
        assert t_cam.config == bridge.convert_config(j_cam.config, type(t_cam.config))
        for name, x in camera_leaves(t_cam).items():
            np.testing.assert_array_equal(x.detach().numpy(), getattr(j_cam, name), err_msg=name)
        assert t.match_cache.pairs() == j.match_cache.pairs() != []
        for name in ("model_cfg", "render_cfg", "curriculum"):
            port = getattr(t, name)
            assert port == bridge.convert_config(getattr(j, name), type(port)), name
        # The port's TrainConfig carries the optimizer's decay, which the JAX
        # driver hands to make_optimizer apart.
        want = bridge.convert_config(j.train_cfg, type(t.train_cfg))
        assert t.train_cfg == dataclasses.replace(want, weight_decay=0.1)
        assert t.optimizer.weight_decay == 0.1 and t.pixel_pool is not None
        assert t.step_prd_fn is not None and t.device_step is None


def _assert_batches_equal(t, j):
    assert t.keys() == j.keys()
    for k in j:
        if isinstance(j[k], (int, float)):
            assert t[k] == j[k], k
            continue
        a, b = t[k].numpy(), np.asarray(j[k])
        assert a.shape == b.shape, k
        if k.startswith("rays"):
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)


class TestSampling:
    @pytest.mark.parametrize("mode", ["pixel_pool", "single_image", "no_camera"])
    def test_first_draws_alike(self, tmp_path, scene, mode):
        extra = {"pixel_pool": {}, "single_image": {"no_batching": True},
                 "no_camera": {"no_batching": True, "camera_model": "none"}}[mode]
        j, t = build_pair(tmp_path, scene, **extra)
        assert (t.pixel_pool is not None) == (mode == "pixel_pool")
        for it in range(5):
            _assert_batches_equal(tdriver.sample_batch(t, it), jdriver.sample_batch(j, it))
            jp, tp = jdriver.sample_prd_batch(j), tdriver.sample_prd_batch(t)
            if mode == "no_camera":
                assert jp is None and tp is None
            else:
                _assert_batches_equal(tp, jp)

    def test_step_generator_depends_on_seed_and_step_only(self):
        def draw(seed, it):
            return torch.rand(8, generator=tdriver.step_generator(seed, it, "cpu"))

        assert torch.equal(draw(777, 3), draw(777, 3))
        assert not torch.equal(draw(777, 3), draw(777, 4))
        assert not torch.equal(draw(777, 3), draw(778, 3))

    def test_resumed_run_draws_as_uninterrupted(self, tmp_path, scene):
        """Batches drawn on the device from the step generator: 2 + 2 steps
        across a checkpoint give the parameters of 4 steps in one go."""
        from scnerf_tpu_torch.core.config import load_experiment

        flags = _flags(scene, no_batching=True, device_sampling=True, ray_loss_type="none",
                       i_weights=2, i_print=100)
        cfg = load_experiment(FERN, flags, warn=_quiet)
        once = tdriver.build_experiment(cfg, None, device="cpu")
        assert once.device_step is not None
        tdriver.train_loop(once, 4)
        expdir = str(tmp_path / "resume")
        first = tdriver.build_experiment(cfg, expdir, device="cpu")
        tdriver.train_loop(first, 2, ckpt_dir=os.path.join(expdir, "ckpts"))
        second = tdriver.build_experiment(cfg, expdir, device="cpu")
        assert second.state.step == 2
        tdriver.train_loop(second, 4)
        a, b = named_leaves(once.state.params), named_leaves(second.state.params)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _carried(j, t, seed=3):
    """A noisy camera on the JAX side, and the port's experiment on the same
    parameters with a fresh optimizer state."""
    rng = np.random.RandomState(seed)
    cam = j.state.params["camera"]
    noisy = {name: jnp.asarray(rng.randn(*getattr(cam, name).shape) * scale, jnp.float32)
             for name, scale in (("intrinsics_noise", 0.3), ("extrinsics_noise", 0.01),
                                 ("ray_o_grid", 1.0), ("ray_d_grid", 1.0))}
    j.state = j.state.replace(params=dict(j.state.params, camera=cam.replace(**noisy)))
    params = bridge.train_params_to_torch(jax.tree.map(np.asarray, j.state.params),
                                          device="cpu")
    t.state = create_train_state(params, t.optimizer)


def assert_eval_maps_close(got, want, key):
    """tests/test_torch_render_serve.py's eval-mode limits."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).ravel()
    if key.startswith("disp"):
        err = err / np.maximum(np.abs(np.asarray(want, np.float64)).ravel(), 1.0)
    assert np.median(err) < 1e-6, key
    assert np.percentile(err, 99.0) < 1e-4, key
    assert err.max() < 1e-2, key


def _inject_eval_matches(exp, cache_cls, pair_cls):
    """Matches between the test views projected through their GT poses,
    the first eight of each pair corrupted (the GT filter drops them), as
    tests/test_driver.py's PRD-split test."""
    base = projected_matches(exp.gt_poses[exp.i_test], exp.gt_intrinsic, exp.H, exp.W, seed=9)
    cache = cache_cls()
    for i, j in base.pairs():
        m = base.get(i, j)
        k1 = m.kps1.copy()
        k1[:8] += 6.0
        cache.put(i, j, pair_cls(m.kps0, k1))
    exp.eval_pair_list, exp.eval_match_cache = np.array(base.pairs()), cache


class TestEvaluation:
    @pytest.fixture(scope="class")
    def pair(self, tmp_path_factory, scene):
        j, t = build_pair(tmp_path_factory.mktemp("eval"), scene)
        _carried(j, t)
        _inject_eval_matches(j, jprovider.PrecomputedMatches, jprovider.PairMatches)
        _inject_eval_matches(t, tprovider.PrecomputedMatches, tprovider.PairMatches)
        return j, t

    def test_aligned_eval_extrinsic_alike(self, pair):
        j, t = pair
        for idx in t.i_test:
            np.testing.assert_allclose(tdriver.aligned_eval_extrinsic(t, int(idx)).numpy(),
                                       np.asarray(jdriver.aligned_eval_extrinsic(j, int(idx))),
                                       atol=1e-5)

    def test_render_image_alike(self, pair):
        j, t = pair
        c2w = np.asarray(jdriver.aligned_eval_extrinsic(j, int(j.i_test[1])))
        want = jdriver.render_image(j, c2w)
        got = tdriver.render_image(t, c2w)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape == (24, 32) + want[k].shape[2:], k
            assert_eval_maps_close(got[k], want[k], k)
        assert got["rgb"].max() <= 1.0

    def test_evaluate_test_views_alike(self, pair):
        j, t = pair
        want, got = jdriver.evaluate_test_views(j), tdriver.evaluate_test_views(t)
        assert got.keys() == {"psnr", "ssim", "n_views"} and got["n_views"] == 3
        assert abs(got["psnr"] - want["psnr"]) < 1e-3
        assert abs(got["ssim"] - want["ssim"]) < 1e-5

    def test_evaluate_prd_alike(self, pair):
        j, t = pair
        want, got = jdriver.evaluate_prd(j), tdriver.evaluate_prd(t)
        assert want.keys() == got.keys() == {"prd"}
        np.testing.assert_allclose(got["prd"], want["prd"], rtol=1e-5)
        for mode in ("val", "test"):
            want = jdriver.evaluate_prd_split(j, mode=mode)
            got = tdriver.evaluate_prd_split(t, mode=mode)
            assert want.keys() == got.keys() == {f"prd_{mode}"}
            np.testing.assert_allclose(got[f"prd_{mode}"], want[f"prd_{mode}"], rtol=1e-5)
        assert tdriver.evaluate_prd_split(t, split=t.i_test[:1]) == {}


class TestLoop:
    def test_train_loop_with_every_hook(self, tmp_path, scene, monkeypatch):
        from scnerf_tpu_torch.core.config import load_experiment

        flags = _flags(scene, i_print=1, i_weights=3, i_testset=4, i_img=4, camera_log=4,
                       i_video=0, expname="hooks", basedir=str(tmp_path))
        exp = tdriver.build_experiment(load_experiment(FERN, flags, warn=_quiet),
                                       _expdir(tmp_path, "hooks", scene), device="cpu")
        _inject_eval_matches(exp, tprovider.PrecomputedMatches, tprovider.PairMatches)
        calls = []
        core = trend.sample_pdf_core

        def counting(*args):
            calls.append(args[0].shape[0])
            return core(*args)

        monkeypatch.setattr(trend, "sample_pdf_core", counting)
        ckpts = os.path.join(exp.logger.expdir, "ckpts")
        state, metrics = tdriver.train_loop(exp, 4, ckpt_dir=ckpts, eval_hooks=True)
        assert state.step == 4 and np.isfinite(float(metrics["loss"]))
        # K1 (its plain twin on the CPU): once a step, once per chunk of the
        # three renders at step 4 (two test views, one validation view).
        chunks = -(-exp.H * exp.W // exp.render_cfg.chunk)
        assert calls == [64] * 4 + [min(exp.render_cfg.chunk, exp.H * exp.W)] * 3 * chunks
        assert list_checkpoint_steps(ckpts) == [3]
        rows = [json.loads(line) for line in open(os.path.join(exp.logger.expdir,
                                                                "metrics.jsonl"))]
        keys = set().union(*rows)
        for k in ("loss", "psnr", "prd", "prd_matches", "p50_ms", "test/psnr", "test/ssim",
                  "test/prd", "test/prd_val", "test/n_views", "val/psnr", "camera/fx",
                  "camera/fx_err", "camera/ray_o_noise_mean"):
            assert k in keys, k
        for row in rows:
            assert all(np.isfinite(v) for v in row.values() if isinstance(v, float)), row
        assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4]
        assert [r["step"] for r in rows if "prd" in r] == [1, 3]
        assert all(r["prd_matches"] > 0 for r in rows if "prd" in r)
        png = read_png(os.path.join(exp.logger.expdir, "val_00000004.png"))
        assert png.shape == (24, 32, 3)
        grid = read_png(os.path.join(exp.logger.expdir, "images",
                                     "camera_ray_o_noise_00000004.png"))
        assert grid.shape == tuple(exp.state.params["camera"].ray_o_grid.shape)


class TestCli:
    def test_train_resume_and_eval(self, tmp_path, scene, capsys):
        expdir = tmp_path / "logs" / "fern_ours"
        expdir.mkdir(parents=True)
        shutil.copy(scene[1], expdir / "matches.npz")
        argv = ["--config", FERN, "--device", "cpu", "--basedir", str(tmp_path / "logs"),
                "--i_print", "1", "--i_weights", "3"]
        for k, v in _flags(scene).items():
            argv += [f"--{k}", str(v)]
        assert tcli.main(argv + ["--steps", "3"]) == 0
        out = capsys.readouterr().out
        assert "[eval] psnr=" in out and "ssim=" in out and "[resume]" not in out
        assert list_checkpoint_steps(str(expdir / "ckpts")) == [3]
        assert tcli.main(argv + ["--steps", "5"]) == 0
        out = capsys.readouterr().out
        assert "[resume] restored step 3" in out and "[eval] psnr=" in out
        assert list_checkpoint_steps(str(expdir / "ckpts")) == [3, 5]  # and the last step
        rows = [json.loads(line) for line in open(expdir / "metrics.jsonl")]
        assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4, 5]
        finals = [r for r in rows if "final_psnr" in r]
        assert [r["step"] for r in finals] == [3, 5] and finals[-1]["final_n_views"] == 3
        assert json.load(open(expdir / "config.json"))["sampling"]["N_rand"] == 64

    def test_cuda_without_a_card_exits_nonzero(self, scene, capsys):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        assert tcli.main(["--config", FERN, "--datadir", scene[0]]) == 2
        assert "no CUDA device" in capsys.readouterr().err


class TestLaterSlices:
    @pytest.mark.parametrize("what", ["render_only", "blender", "nerfpp", "tar", "i_video"])
    def test_raises_not_implemented(self, tmp_path, scene, what):
        from scnerf_tpu_torch.core.config import load_experiment

        if what in ("render_only", "nerfpp"):
            argv = ["--config", FERN, "--device", "cpu", "--datadir", scene[0]]
            argv += ["--render_only", "True"] if what == "render_only" else [
                "--dataset_type", "nerfpp"]
            with pytest.raises(NotImplementedError, match="later slice"):
                tcli.main(argv)
            return
        flags = _flags(scene, **{"blender": {"dataset_type": "blender"},
                                 "tar": {"ft_path": "ref.tar"},
                                 "i_video": {}}[what])
        cfg = load_experiment(FERN, flags, warn=_quiet)
        with pytest.raises(NotImplementedError, match="later slice"):
            exp = tdriver.build_experiment(cfg, None, device="cpu")
            tdriver.train_loop(exp, 1, eval_hooks=True)


def test_flags_to_port_config_alike(scene):
    """The CLI's override parsing builds the config the JAX CLI builds."""
    from scnerf_tpu.cli.train import parse_cli as j_parse

    argv = ["--config", FERN, "--steps", "7", "--N_rand", "32", "--no_ndc", "--lrate", "1e-3"]
    j_args, j_over = j_parse(argv)
    t_args, t_over = tcli.parse_cli(argv + ["--device", "cpu"])
    assert (t_args.config, t_args.steps, t_args.device) == (FERN, 7, "cpu")
    assert t_over == j_over
    assert dataclasses.asdict(t_flags(dict(t_over), warn=_quiet)) == dataclasses.asdict(
        j_flags(dict(j_over), warn=_quiet))
