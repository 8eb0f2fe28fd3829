"""The port's self-calibration experiments (``scnerf_tpu_torch/scripts/``)
against the JAX package's scripts (``scripts/``).

JAX runs on the CPU; the JAX scripts are imported from ``scripts/`` (put on
``sys.path`` here, as they put it themselves), the port's from its package.
Tolerances: the analytic field and its renders 1e-5 (relative and absolute:
float32 sums of a few terms in two orders); the PNGs within one 8-bit
level (a render on either side of a rounding boundary); the match caches
and configs exactly; the camera errors 1e-6 relative against the JAX
script with its alignment in float64, as the port aligns (and 1e-5
against it unpatched: its float32 alignment parts from the port's by
1.6e-6 of the translation error through the SVD's rounding alone); the
polish's PRD curve 1e-5 relative.
"""
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from _torch_support import one_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import _analytic_scene as j_scene  # noqa: E402
import ablation_curriculum as j_ablation  # noqa: E402
import polish_calibration as j_polish  # noqa: E402
import soak_nerf as j_soak  # noqa: E402
from scnerf_tpu.camera import model as j_camera  # noqa: E402
from scnerf_tpu.core.config import experiment_from_flags as j_flags  # noqa: E402
from scnerf_tpu.data.noise import NoiseConfig, inject_pose_noise  # noqa: E402
from scnerf_tpu.matching.provider import PrecomputedMatches as JMatches  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera import model as t_camera  # noqa: E402
from scnerf_tpu_torch.core.imaging import read_png  # noqa: E402
from scnerf_tpu_torch.matching.provider import PrecomputedMatches  # noqa: E402
from scnerf_tpu_torch.scripts import _analytic_scene as t_scene  # noqa: E402
from scnerf_tpu_torch.scripts import ablation_curriculum as t_ablation  # noqa: E402
from scnerf_tpu_torch.scripts import polish_calibration as t_polish  # noqa: E402
from scnerf_tpu_torch.scripts import soak_nerf as t_soak  # noqa: E402

H, W = 40, 56


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)



@pytest.fixture(scope="module")
def blender_scenes(tmp_path_factory):
    """The analytic blender scene at 40x56 written by both packages, and
    the port's float renders."""
    root = tmp_path_factory.mktemp("scenes")
    renders = t_scene.build_blender_scene(str(root / "port"), H=H, W=W, device="cpu")
    j_scene.build_blender_scene(str(root / "jax"), H=H, W=W)
    return root / "port", root / "jax", renders


class TestAnalyticScene:
    @pytest.mark.parametrize("scale", [1.0, 0.2])
    @pytest.mark.parametrize("texture", [False, True])
    def test_field(self, scale, texture):
        pts = (np.random.default_rng(0).normal(size=(64, 9, 3)) * 0.6 * scale).astype(np.float32)
        got = t_scene.field(torch.from_numpy(pts), scale, texture=texture)
        _close(got, j_scene.field(jnp.asarray(pts), scale, texture=texture))

    @pytest.mark.parametrize("scale,texture", [(1.0, False), (0.2, True)])
    def test_render_gt_rays(self, scale, texture):
        rng = np.random.default_rng(1)
        o = rng.normal(size=(96, 3))
        o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 4.0 * scale).astype(np.float32)
        d = (-o / (4.0 * scale) + rng.normal(size=(96, 3)) * 0.1).astype(np.float32)
        near, far = 2.0 * scale, 6.0 * scale
        got = t_scene.render_gt_rays(torch.from_numpy(o), torch.from_numpy(d), near, far,
                                     n_samples=64, scale=scale, texture=texture)
        want = j_scene.render_gt_rays(jnp.asarray(o), jnp.asarray(d), near, far,
                                      n_samples=64, scale=scale, texture=texture)
        assert got.shape == (96, 3)
        _close(got, want)

    def test_blender_scene(self, blender_scenes):
        import imageio.v2 as imageio

        port, jax_dir, renders = blender_scenes
        for split, n in (("train", 12), ("val", 2), ("test", 2)):
            t_meta = json.loads((port / f"transforms_{split}.json").read_text())
            assert t_meta == json.loads((jax_dir / f"transforms_{split}.json").read_text())
            assert len(t_meta["frames"]) == n and renders[split].shape == (n, H, W, 3)
            for i in range(n):
                got = read_png(str(port / split / f"r_{i}.png")).astype(int)
                want = imageio.imread(str(jax_dir / split / f"r_{i}.png")).astype(int)
                assert got.shape == want.shape == (H, W, 4)
                assert np.abs(got - want).max() <= 1, (split, i)
                # The PNG is the float render, clipped and rounded.
                assert np.abs(got[..., :3] / 255.0 - np.clip(renders[split][i], 0, 1)).max() \
                    <= 0.5 / 255.0 + 1e-6

    def test_nerfpp_scene(self, tmp_path):
        """The NeRF++ layout with radial distortion and texture: the same
        files, the same cameras, the images within one level."""
        kwargs = dict(n_train=3, n_val=1, H=24, W=32, dist_k=(0.05, -0.01), texture=True)
        t_dir = Path(t_scene.build_nerfpp_scene(str(tmp_path / "port"), device="cpu", **kwargs))
        j_dir = Path(j_scene.build_nerfpp_scene(str(tmp_path / "jax"), **kwargs))
        files = sorted(str(p.relative_to(t_dir)) for p in t_dir.rglob("*") if p.is_file())
        assert files == sorted(str(p.relative_to(j_dir)) for p in j_dir.rglob("*") if p.is_file())
        assert len([f for f in files if f.endswith(".png")]) == 4
        for f in files:
            if f.endswith(".png"):
                got = read_png(str(t_dir / f)).astype(int)
                want = read_png(str(j_dir / f)).astype(int)
                assert got.shape == want.shape == (24, 32, 3)
                assert np.abs(got - want).max() <= 1, f
            else:
                _close(np.loadtxt(t_dir / f), np.loadtxt(j_dir / f), tol=0)


def test_write_exact_matches(blender_scenes, tmp_path):
    from scnerf_tpu_torch.data.blender import load_blender

    d = load_blender(str(blender_scenes[0]), testskip=1)
    args = (d.gt_poses, d.i_split[0], d.gt_intrinsic[0, 0], H, W)
    n_port = t_soak.write_exact_matches(str(tmp_path / "port.npz"), *args)
    n_jax = j_soak.write_exact_matches(str(tmp_path / "jax.npz"), *args)
    assert n_port == n_jax > 0
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    for name in want.files:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    assert PrecomputedMatches(str(tmp_path / "port.npz")).pairs() == \
        JMatches(str(tmp_path / "jax.npz")).pairs()
    assert t_soak.NOISE == j_soak.NOISE


def _noisy_cameras(seed: int = 0, n: int = 12):
    """A JAX camera with the ablation's injected noise and random noise on
    every learnable leaf, and the GT it is measured against."""
    rng = np.random.RandomState(seed)
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([j_scene._look_at_c2w_opencv(np.array([4 * np.cos(a), 4 * np.sin(a), 1.5]))
                   for a in angles]).astype(np.float32)
    K = np.array([[140.0, 0, W / 2, 0], [0, 140.0, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    noise = NoiseConfig(intrinsic_scale=0.05, rotation_deg=2.0, translation=0.05)
    noisy, focal = inject_pose_noise(gt[:, :3, :4], K[0, 0], np.arange(n), noise, rng)
    K_noisy = K.copy()
    K_noisy[0, 0] = K_noisy[1, 1] = focal
    cfg = j_camera.CameraConfig(H=H, W=W, multiplicative_noise=True)
    cam = j_camera.init_camera(K_noisy, noisy, cfg)
    cam = cam.replace(intrinsics_noise=jnp.asarray(rng.normal(size=4) * 0.01, jnp.float32),
                      extrinsics_noise=jnp.asarray(rng.normal(size=(n, 9)) * 0.5, jnp.float32))
    return cam, gt, K


def jax_alignment_in_float64(monkeypatch):
    """Make ``scripts/soak_nerf.py:camera_errors`` align in float64 from
    its float32 poses, as the port's does: ``align_c2w_trajectories`` and
    ``apply_sim3`` take their array arguments cast to float64 and run under
    ``jax.enable_x64``. The JAX package is not edited; the patch ends with
    the test."""
    from scnerf_tpu.geometry import alignment

    def in_float64(fn):
        def run(*args):
            with jax.enable_x64(True):
                out = fn(*(jnp.asarray(np.asarray(a), jnp.float64) for a in args))
                return jax.tree.map(np.asarray, out)
        return run

    for name in ("align_c2w_trajectories", "apply_sim3"):
        monkeypatch.setattr(alignment, name, in_float64(getattr(alignment, name)))


def _exp(camera, gt, K):
    return types.SimpleNamespace(state=types.SimpleNamespace(params={"camera": camera}),
                                 gt_poses=gt, i_train=np.arange(len(gt)), gt_intrinsic=K)


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_errors(seed, monkeypatch):
    cam, gt, K = _noisy_cameras(seed)
    port_cam = t_camera.trainable_camera(bridge.camera_from_numpy(
        jax.tree.map(np.asarray, cam), device="cpu"))
    got = t_soak.camera_errors(_exp(port_cam, gt, K))
    unpatched = j_soak.camera_errors(_exp(cam, gt, K))
    jax_alignment_in_float64(monkeypatch)
    want = j_soak.camera_errors(_exp(cam, gt, K))
    assert set(got) == {"rot_err_deg", "trans_err", "focal_rel_err"} == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), (k, got[k], want[k])
        assert abs(got[k] - unpatched[k]) <= 1e-5 * abs(unpatched[k]), (k, got[k], unpatched[k])
    assert t_soak.camera_errors(_exp(None, gt, K)) == {}


def _jax_rows(n_steps):
    """``scripts/ablation_curriculum.py:main``'s rows, as it builds them."""
    noise = {"initial_noise_size_intrinsic": j_soak.NOISE["intrinsic"],
             "initial_noise_size_rotation": j_soak.NOISE["rotation"],
             "initial_noise_size_translation": j_soak.NOISE["translation"]}
    cam = {"camera_model": "pinhole_rot_noise_10k_rayo_rayd", "multiplicative_noise": True,
           "camera_lrate_mult": 1.0, "camera_lrate_mult_until": 0, **noise}
    off, add_od, add_prd = 10 ** 9, max(n_steps // 6, 1), max(n_steps // 3, 2)
    return [("gt_poses", {}), ("noisy_no_calib", noise),
            ("ie", {**cam, "add_ie": 0, "add_od": off, "add_prd": off}),
            ("ie_od", {**cam, "add_ie": 0, "add_od": add_od, "add_prd": off}),
            ("ie_od_prd", {**cam, "add_ie": 0, "add_od": add_od, "add_prd": add_prd,
                           "ray_loss_type": "proj_ray_dist", "matcher": "sift",
                           "i_ray_dist_loss": 10})]


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
@pytest.mark.parametrize("n_steps", [8000, 300, 3])
def test_ablation_rows_configure_alike(n_steps, small):
    """Each row's flags, and the run's own keys around them, give the same
    config in both packages (``run_row``'s dict)."""
    rows = t_ablation.rows_spec(n_steps)
    assert rows == _jax_rows(n_steps)
    for name, flags in rows:
        got = t_ablation.row_config(name, "scene", "work", flags, small)
        want = j_flags({
            "dataset_type": "blender", "datadir": "scene", "testskip": 1,
            "N_rand": 128 if small else 1024, "N_samples": 8 if small else 64,
            "N_importance": 8 if small else 64,
            **({"netdepth": 2, "netwidth": 32, "multires": 4, "multires_views": 2}
               if small else {}),
            "i_print": 10 ** 9, "i_img": 10 ** 9, "i_testset": 10 ** 9,
            "i_video": 10 ** 9, "i_weights": 10 ** 9, "expname": name, "basedir": "work",
            **flags}, warn=lambda *a: None)
        assert json.loads(got.to_json()) == json.loads(want.to_json()), name
    if n_steps == 8000:
        prd = dict(rows)["ie_od_prd"]
        assert (prd["add_od"], prd["add_prd"]) == (1333, 2666)


def _baselines_stub(x0, fundamental):
    """``run_all_baselines`` without its solves (seconds of scipy each):
    every method returns the initial intrinsics."""
    return {name: np.array([*x0, 0.0]) for name in
            ("mendonca", "classical_kruppa", "simple_kruppa", "daq")}


def test_classical_baselines_hand_the_same_problem(blender_scenes, tmp_path, monkeypatch):
    """The Table-1 comparison builds the same fundamental matrices from the
    same matches and starts from the same noisy K in both packages (the
    solves themselves are held to JAX in ``tests/test_torch_tools.py``)."""
    from scnerf_tpu.tools import calibration_baselines as j_baselines
    from scnerf_tpu_torch.data.blender import load_blender

    d = load_blender(str(blender_scenes[0]), testskip=1)
    path = str(tmp_path / "matches.npz")
    t_soak.write_exact_matches(path, d.gt_poses, d.i_split[0], d.gt_intrinsic[0, 0], H, W)
    K_gt = np.asarray(d.gt_intrinsic, np.float64)
    K_noisy = K_gt.copy()
    K_noisy[0, 0] = K_noisy[1, 1] = K_gt[0, 0] * 1.05
    seen = {}

    def capture(side):
        def run(x0, fundamental):
            seen[side] = (x0, fundamental)
            return _baselines_stub(x0, fundamental)
        return run

    monkeypatch.setattr(t_ablation, "run_all_baselines", capture("port"))
    monkeypatch.setattr(j_baselines, "run_all_baselines", capture("jax"))
    got = t_ablation.classical_baselines(path, K_gt, K_noisy)
    want = j_ablation.classical_baselines(path, K_gt, K_noisy)
    assert got == want and got["initial_focal_rel_err"] == pytest.approx(0.05)
    (x0, f_port), (j_x0, f_jax) = seen["port"], seen["jax"]
    np.testing.assert_array_equal(x0, j_x0)
    assert sorted(f_port) == sorted(f_jax) and len(f_port) > 0
    for i in f_jax:
        assert sorted(f_port[i]) == sorted(f_jax[i])
        for j in f_jax[i]:
            np.testing.assert_allclose(f_port[i][j], f_jax[i][j], rtol=1e-9, atol=1e-12)


def test_ablation_main_small(tmp_path, monkeypatch):
    """Three steps a row at ``--small`` on the CPU: every number finite, one
    noise realization in the three camera rows, and its camera errors those
    of the JAX experiment built from the same config. (The classical
    baselines' solves are stubbed: the test above holds their problem.)"""
    from scnerf_tpu.train.driver import build_experiment as j_build

    monkeypatch.setattr(t_ablation, "run_all_baselines", _baselines_stub)
    report = t_ablation.main(3, str(tmp_path / "report.json"), str(tmp_path / "work"),
                             small=True, device="cpu")
    assert json.loads((tmp_path / "report.json").read_text()) == json.loads(json.dumps(report))
    rows = {r["name"]: r for r in report["rows"]}
    assert list(rows) == ["gt_poses", "noisy_no_calib", "ie", "ie_od", "ie_od_prd"]
    for r in rows.values():
        for k in ("heldout_psnr", "heldout_ssim", "final_train_loss"):
            assert np.isfinite(r[k]), (r["name"], k)
        assert r["n_views"] == 2
    initial = [rows[n]["camera_err_initial"] for n in ("ie", "ie_od", "ie_od_prd")]
    assert initial[0] == initial[1] == initial[2] and set(initial[0]) == {
        "rot_err_deg", "trans_err", "focal_rel_err"}
    assert rows["gt_poses"]["camera_err_initial"] == {}
    assert report["curriculum"] == {"add_od": 1, "add_prd": 2}
    for v in report["classical_baselines"].values():
        assert v is None or np.isfinite(v)
    assert report["device"] == "cpu" and isinstance(report["gain_gate_pass"], bool)

    flags = dict(t_ablation.rows_spec(3))["ie"]
    cfg = j_flags({"dataset_type": "blender", "datadir": str(tmp_path / "work" / "scene"),
                   "testskip": 1, "N_rand": 128, "N_samples": 8, "N_importance": 8,
                   "netdepth": 2, "netwidth": 32, "multires": 4, "multires_views": 2,
                   **flags}, warn=lambda *a: None)
    j_exp = j_build(cfg, None)
    unpatched = j_soak.camera_errors(j_exp)
    jax_alignment_in_float64(monkeypatch)
    want = j_soak.camera_errors(j_exp)
    for k, v in want.items():
        assert abs(initial[0][k] - v) <= 1e-6 * abs(v), (k, initial[0][k], v)
        assert abs(initial[0][k] - unpatched[k]) <= 1e-5 * abs(v), (k, initial[0][k], v)


def _polish_inputs(tmp_path, blender_scenes):
    """One camera, carried to both packages, and the soak's exact matches
    over every train pair."""
    from scnerf_tpu_torch.data.blender import load_blender

    d = load_blender(str(blender_scenes[0]), testskip=1)
    path = str(tmp_path / "matches.npz")
    t_soak.write_exact_matches(path, d.gt_poses, d.i_split[0], d.gt_intrinsic[0, 0], H, W)
    rng = np.random.RandomState(3)
    cfg = j_camera.CameraConfig(H=H, W=W, multiplicative_noise=True)
    K = d.gt_intrinsic.copy()
    K[0, 0] = K[1, 1] = K[0, 0] * 1.05
    cam = j_camera.init_camera(K, d.gt_poses[d.i_split[0]], cfg)
    cam = cam.replace(extrinsics_noise=jnp.asarray(rng.normal(size=(12, 9)) * 0.3, jnp.float32),
                      ray_d_grid=jnp.asarray(rng.normal(size=cam.ray_d_grid.shape) * 1e-3,
                                             jnp.float32))
    pairs = np.array(PrecomputedMatches(path).pairs())
    cam_cfg = types.SimpleNamespace(match_num=64, proj_ray_dist_threshold=5.0)
    j_exp = types.SimpleNamespace(state=types.SimpleNamespace(params={"camera": cam}),
                                  pair_list=pairs, match_cache=JMatches(path),
                                  cfg=types.SimpleNamespace(camera=cam_cfg))
    t_cam = t_camera.trainable_camera(bridge.camera_from_numpy(jax.tree.map(np.asarray, cam),
                                                               device="cpu"))
    t_exp = types.SimpleNamespace(state=types.SimpleNamespace(params={"camera": t_cam}),
                                  pair_list=pairs, match_cache=PrecomputedMatches(path),
                                  cfg=types.SimpleNamespace(camera=cam_cfg),
                                  device=torch.device("cpu"))
    return j_exp, t_exp


def test_polish_camera_against_jax(tmp_path, blender_scenes):
    """Phase A: the full-batch PRD over every pair, batched in one vmapped
    loss, equals JAX's vmapped per-pair PRD, step by step under Adam on the
    calibration leaves; the ray grids do not move."""
    j_exp, t_exp = _polish_inputs(tmp_path, blender_scenes)
    k0, k1, msk, idx = t_polish.stack_all_pairs(t_exp, 64)
    jk0, jk1, jmsk, jidx = j_polish.stack_all_pairs(j_exp, 64)
    np.testing.assert_array_equal(k0, jk0)
    np.testing.assert_array_equal(msk, jmsk)
    np.testing.assert_array_equal(idx, jidx)
    cam, hist = t_polish.polish_camera(t_exp, 4)
    j_cam, j_hist = j_polish.polish_camera(j_exp, 4)
    assert [h["step"] for h in hist] == [h["step"] for h in j_hist] == [0, 1, 2, 3]
    for got, want in zip(hist, j_hist):
        assert abs(got["prd"] - want["prd"]) <= 1e-5 * want["prd"], (got, want)
    assert hist[-1]["prd"] < hist[0]["prd"]
    before = t_exp.state.params["camera"]
    assert torch.equal(cam.ray_d_grid, before.ray_d_grid)
    assert not torch.equal(cam.extrinsics_noise, before.extrinsics_noise)
    _close(cam.extrinsics_noise.detach(), np.asarray(j_cam.extrinsics_noise), tol=1e-5)


def test_soak_then_polish(tmp_path, monkeypatch):
    """The soak at ``--small`` (20 steps, an evaluation every 10, then 5
    marginal steps in place of 500) and the polish on its workdir, both on
    the CPU."""
    monkeypatch.setattr(t_soak, "MARGINAL_STEPS", 5)
    work = str(tmp_path / "soak")
    report = t_soak.main(20, str(tmp_path / "soak.json"), work, small=True, eval_every=10,
                         add_prd=5, device="cpu")
    assert [row["step"] for row in report["eval_curve"]] == [0, 10, 20]
    assert report["n_steps"] == 25 and report["finite"]
    q = report["quality"]
    assert set(q["camera_err_initial"]) == {"rot_err_deg", "trans_err", "focal_rel_err"}
    assert isinstance(q["psnr_gate_pass"], bool) and isinstance(q["camera_gate_pass"], bool)
    assert set(report["eval_protocol_ab"]) == {"ate_full_camera", "ate_no_grid", "gt_pose_full",
                                               "gt_pose_gt_focal", "train_view"}
    assert sorted(os.listdir(os.path.join(work, "soak", "ckpts")))[:2] == [
        "ckpt_000000010.pt", "ckpt_000000020.pt"]

    polish = t_polish.main(work, str(tmp_path / "polish.json"), 3, 3, device="cpu")
    assert polish["restored_step"] == 23
    assert [p["tag"] for p in polish["phases"]] == ["baseline", "after_polish", "after_refit"]
    base, after_polish, after_refit = polish["phases"]
    # The refit pins the polished camera: its errors do not move.
    assert after_refit["rot_err_deg"] == after_polish["rot_err_deg"]
    assert all(np.isfinite(p["heldout_psnr"]) for p in polish["phases"])


@pytest.mark.parametrize("module", ["ablation_curriculum", "soak_nerf", "polish_calibration"])
def test_cli_needs_the_card_or_device_cpu(module, monkeypatch, capsys):
    """Without a card the scripts exit 2 unless given ``--device cpu``; they
    take no CPU route of their own."""
    import runpy
    import warnings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--workdir", "unused"] if module == "polish_calibration" else []
    monkeypatch.setattr(sys, "argv", [module, *args])
    with warnings.catch_warnings(), pytest.raises(SystemExit) as exit_:
        warnings.simplefilter("ignore", RuntimeWarning)  # the module is imported already
        runpy.run_module(f"scnerf_tpu_torch.scripts.{module}", run_name="__main__")
    assert exit_.value.code == 2
    assert "pass --device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("fn", [t_ablation.main, t_ablation.run_row, t_soak.main, t_polish.main,
                                t_polish.load_experiment, t_scene.build_blender_scene,
                                t_scene.build_nerfpp_scene],
                         ids=lambda fn: f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}")
def test_entry_points_default_to_the_card(fn):
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"
