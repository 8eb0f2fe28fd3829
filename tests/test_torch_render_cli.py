"""The port's render CLI, its ``--render_only`` dispatch from the training
CLI, the NeRF driver's ``i_video`` hook and ``tools/video.py``, on the CPU
at small sizes: a seeded NeRF++ scene (4 train views and 1 validation view
of 16x20) under the Truck config with 3x32 nets and cascade 8,8, and a
seeded LLFF scene (9 views of 24x32) under the fern config with 2x16 nets
and 4+4 samples.

- Train, then render: NeRF++ (``test``, ``train``, ``--render_splits``) and
  LLFF (``train``, ``test``, ``path``, ``--render_splits``): the restored
  step, the ``[eval]`` line, and every file written, read back.
- ``--render_only`` (with and without ``--render_test``) renders instead of
  training, with ``--device`` and the overrides passed on.
- ``render_training_video`` and the ``i_video`` hook.
- ``array_to_video`` and ``frames_to_video``: the same ``uint8`` frames as
  the JAX module's (both write the ``.npz`` where no ffmpeg backend is
  installed), and the ``.npz`` when ``imageio`` cannot be imported.
"""
import builtins
import json
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from _torch_support import write_llff_scene, write_nerfpp_scene  # noqa: E402
from scnerf_tpu.tools import video as jvideo  # noqa: E402
from scnerf_tpu_torch.cli import render as rcli  # noqa: E402
from scnerf_tpu_torch.cli import train as tcli  # noqa: E402
from scnerf_tpu_torch.core.config import load_experiment  # noqa: E402
from scnerf_tpu_torch.core.imaging import read_png, to8b, write_png  # noqa: E402
from scnerf_tpu_torch.tools import video as tvideo  # noqa: E402
from scnerf_tpu_torch.train.checkpoint import list_checkpoint_steps  # noqa: E402
from scnerf_tpu_torch.train import driver as tdriver  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUCK = os.path.join(REPO, "configs", "tanks_and_temples", "tat_training_Truck_ours.txt")
FERN = os.path.join(REPO, "configs", "llff", "fern_ours.txt")
PP_SMALL = {"scene": "", "netdepth": 3, "netwidth": 32, "max_freq_log2": 4,
            "max_freq_log2_viewdirs": 2, "cascade_samples": "8,8", "N_rand": 32,
            "chunk_size": 128, "i_print": 1, "i_weights": 3}
LLFF_SMALL = {"netdepth": 2, "netwidth": 16, "multires": 2, "multires_views": 2,
              "N_samples": 4, "N_importance": 4, "N_rand": 32, "llffhold": 4,
              "ray_loss_type": "none", "i_print": 1, "i_weights": 2}


def _argv(config, logs, flags, device="cpu"):
    argv = ["--config", config, "--device", device, "--basedir", str(logs)]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


def _frames(path) -> np.ndarray:
    with np.load(path) as npz:
        return npz["frames"]


def _eval_line(out: str) -> str:
    lines = [line for line in out.splitlines() if line.startswith("[eval]")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.fixture(scope="module")
def nerfpp_run(tmp_path_factory):
    """A NeRF++ experiment trained 3 steps through the CLI."""
    root = tmp_path_factory.mktemp("pp")
    write_nerfpp_scene(root / "scene", splits=(("train", 4), ("validation", 1)), H=16, W=20)
    argv = _argv(TRUCK, root / "logs", dict(PP_SMALL, datadir=root / "scene"))
    assert tcli.main(argv + ["--steps", "3"]) == 0
    return argv, root / "logs" / "tat_training_Truck_ours"


@pytest.fixture(scope="module")
def llff_run(tmp_path_factory):
    """An LLFF experiment trained 2 steps through the CLI."""
    root = tmp_path_factory.mktemp("llff")
    write_llff_scene(root / "scene", n_views=9, seed=5)
    argv = _argv(FERN, root / "logs", dict(LLFF_SMALL, datadir=root / "scene"))
    assert tcli.main(argv + ["--steps", "2"]) == 0
    return argv, root / "logs" / "fern_ours"


class TestNerfPP:
    def test_render_test_split(self, nerfpp_run, capsys):
        argv, expdir = nerfpp_run
        capsys.readouterr()
        assert rcli.main(argv + ["--split", "test", "--max_views", "1"]) == 0
        out = capsys.readouterr().out
        assert "[render] restored step 3 from" in out
        line = _eval_line(out)
        assert "views=1 split=heldout" in line and "lpips" not in line
        d = expdir / "render_test"
        for name in ("000.png", "000_fg.png", "000_bg.png", "000_depth.png"):
            assert read_png(d / name).shape == (16, 20, 3), name
        summary = (d / "tat_training_Truck_ours.txt").read_text().split()
        assert summary[0::2] == ["psnr", "ssim"] and np.isfinite(float(summary[1]))

    def test_render_train_split_and_render_splits(self, nerfpp_run, capsys):
        argv, expdir = nerfpp_run
        capsys.readouterr()
        assert rcli.main(argv + ["--split", "train", "--max_views", "2"]) == 0
        assert "views=2 split=train" in _eval_line(capsys.readouterr().out)
        assert sorted(os.listdir(expdir / "render_train")) == sorted(
            [f"{i:03d}{s}.png" for i in range(2) for s in ("", "_fg", "_bg", "_depth")]
            + ["tat_training_Truck_ours.txt"])
        shutil.rmtree(expdir / "render_test", ignore_errors=True)
        assert rcli.main(argv + ["--render_splits", "train,validation", "--max_views", "1"]) == 0
        out = capsys.readouterr().out
        assert out.count("[eval]") == 2 and "split=train" in out and "split=heldout" in out
        assert (expdir / "render_test" / "000_depth.png").exists()

    def test_no_resume_and_no_last_step(self, nerfpp_run):
        """As the JAX driver: a run saves on i_weights steps only, and the
        next run on the same experiment starts again from step 0."""
        argv, expdir = nerfpp_run
        for _ in range(2):
            assert tcli.main(argv + ["--steps", "4", "--expname", "again"]) == 0
            again = expdir.parent / "again"
            assert list_checkpoint_steps(str(again / "ckpts")) == [3]
        with open(again / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4] * 2


class TestLLFF:
    def test_render_each_split(self, llff_run, capsys):
        argv, expdir = llff_run
        capsys.readouterr()
        assert rcli.main(argv + ["--split", "train", "--max_views", "2"]) == 0
        out = capsys.readouterr().out
        assert "[render] restored step 2 from" in out
        assert "trainset psnr=" in _eval_line(out) and "views=2" in _eval_line(out)
        assert read_png(expdir / "render_train" / "001.png").shape == (24, 32, 3)
        assert rcli.main(argv + ["--split", "test"]) == 0
        line = _eval_line(capsys.readouterr().out)
        assert "views=3" in line and "psnr=" in line and "ssim=" in line
        assert sorted(os.listdir(expdir / "render_test")) == ["000.png", "001.png", "002.png"]
        assert rcli.main(argv + ["--split", "path", "--max_views", "3"]) == 0
        out = capsys.readouterr().out
        written = [line.split()[-1] for line in out.splitlines() if line.startswith("[render] video")]
        assert len(written) == 1 and os.path.exists(written[0])
        if written[0].endswith(".npz"):
            assert _frames(written[0]).shape == (3, 24, 32, 3)
        assert read_png(expdir / "render_path" / "002.png").shape == (24, 32, 3)

    def test_render_splits(self, llff_run, capsys, monkeypatch):
        argv, _ = llff_run
        seen = []
        real = rcli.main

        def spy(sub):
            if "--render_splits" not in sub:
                seen.append((sub[sub.index("--split") + 1], sub[sub.index("--device") + 1],
                             "--datadir" in sub))
            return real(sub)

        monkeypatch.setattr(rcli, "main", spy)
        assert spy(argv + ["--render_splits", "train,validation", "--max_views", "1"]) == 0
        assert seen == [("train", "cpu", True), ("test", "cpu", True)]

    @pytest.mark.parametrize("render_test", [True, False])
    def test_render_only_dispatch(self, llff_run, capsys, render_test):
        argv, expdir = llff_run
        split = "test" if render_test else "path"
        shutil.rmtree(expdir / f"render_{split}", ignore_errors=True)
        extra = ["--render_only", "True", "--max_views", "2"] + (
            ["--render_test", "True"] if render_test else [])
        capsys.readouterr()
        assert tcli.main(argv + extra) == 0
        out = capsys.readouterr().out
        assert "[render] restored step 2 from" in out and "[resume]" in out
        assert f"render_{split}" in out.splitlines()[-1]
        assert (expdir / f"render_{split}" / "001.png").exists()
        steps = [f for f in os.listdir(expdir / "ckpts") if f.startswith("ckpt_")]
        assert steps == ["ckpt_000000002.pt"]  # rendered, not trained

    def test_cuda_without_a_card_exits_nonzero(self, llff_run, capsys):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        argv, _ = llff_run
        assert rcli.main(argv[:2] + argv[4:] + ["--split", "test"]) == 2
        assert "no CUDA device" in capsys.readouterr().err


class TestVideo:
    def test_render_training_video(self, llff_run, tmp_path):
        argv, _ = llff_run
        cfg = load_experiment(FERN, tcli.parse_cli(argv)[1])
        exp = tdriver.build_experiment(cfg, None, device="cpu")
        path = tdriver.render_training_video(exp, 7, out_dir=str(tmp_path), max_frames=3)
        assert path.startswith(str(tmp_path / "video_00000007.mp4"))
        files = sorted(os.listdir(tmp_path))
        assert len(files) == 2 and files[1].startswith("video_00000007_disp.mp4")
        if path.endswith(".npz"):
            frames = _frames(path)
            assert frames.shape == (3, 24, 32, 3) and frames.dtype == np.uint8
            disp = _frames(tmp_path / files[1])
            assert disp.shape == (3, 24, 32, 3) and disp.max() == 255

    def test_array_to_video_frames_alike(self, tmp_path):
        frames = np.random.RandomState(0).uniform(-0.2, 1.2, (4, 8, 10, 3))
        got = tvideo.array_to_video(frames, str(tmp_path / "port.mp4"))
        jvideo.array_to_video(frames, str(tmp_path / "jax.mp4"))
        if got.endswith(".npz"):  # no ffmpeg backend: both wrote the .npz
            np.testing.assert_array_equal(_frames(got),
                                          _frames(tmp_path / "jax.mp4.npz"))
        else:
            assert os.path.getsize(got) > 0

    def test_frames_to_video_alike(self, tmp_path, capsys):
        rng = np.random.RandomState(1)
        (tmp_path / "frames").mkdir()
        for i in range(3):
            write_png(tmp_path / "frames" / f"{i:03d}.png", to8b(rng.rand(8, 10, 3)))
        n = tvideo.frames_to_video(str(tmp_path / "frames"), str(tmp_path / "port.mp4"))
        assert n == jvideo.frames_to_video(str(tmp_path / "frames"), str(tmp_path / "jax.mp4"))
        assert n == 3 and "[video] wrote" in capsys.readouterr().out
        if (tmp_path / "port.mp4.npz").exists():
            np.testing.assert_array_equal(_frames(tmp_path / "port.mp4.npz"),
                                          _frames(tmp_path / "jax.mp4.npz"))
        assert tvideo.frames_to_video(str(tmp_path), str(tmp_path / "none.mp4")) == 0

    def test_npz_without_imageio(self, tmp_path, monkeypatch):
        real = builtins.__import__

        def no_imageio(name, *args, **kwargs):
            if name.startswith("imageio"):
                raise ImportError("no imageio here")
            return real(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_imageio)
        frames = np.random.RandomState(2).rand(2, 4, 6, 3)
        path = tvideo.array_to_video(frames, str(tmp_path / "v.mp4"))
        assert path == str(tmp_path / "v.mp4.npz")
        np.testing.assert_array_equal(_frames(path),
                                      (np.clip(frames, 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("masked", [False, True])
def test_colorize_depth_alike(masked):
    """The depth PNGs' colours: the port's jet table against the JAX
    package's matplotlib colormap, exactly, with a NaN, an infinity, a flat
    map and a mask."""
    pytest.importorskip("matplotlib")
    from scnerf_tpu.core.imaging import colorize_depth as j_colorize

    from scnerf_tpu_torch.core.imaging import colorize_depth

    rng = np.random.RandomState(0)
    depth = rng.rand(30, 40) * 5.0
    depth[0, 0], depth[1, 1] = np.nan, np.inf
    mask = (rng.rand(30, 40) > 0.3).astype(np.float32) if masked else None
    for d in (depth, np.linspace(0.0, 1.0, 10001).reshape(1, -1), np.full((3, 4), 2.0)):
        m = mask if mask is not None and d.shape == mask.shape else None
        got, want = colorize_depth(d, m), j_colorize(d, m)
        assert got.dtype == want.dtype == np.float32 and got.shape == d.shape + (3,)
        np.testing.assert_array_equal(got, want)
