"""The port's profiling helpers (``train/profiling.py``) and its native host
library (``native/``) against the JAX package's, on the CPU:

- ``check_finite_tree``: the same names as JAX's for the same tree (dicts,
  lists, a camera);
- ``debug_nans``: a NaN in the forward raises inside the block, the
  backward runs under anomaly mode, and the caller's setting comes back;
- ``profile_rows`` / ``roofline_summary``: the FLOPs of a known ``addmm``
  equal ``2 M N K`` a step, its time the operators' self time on the CPU;
  ``measure_roofline``'s keys and its trace file; ``{}`` for an empty run;
- ``native``: built into ``build/native/`` (never beside its source),
  searchsorted on both sides with either input broadcast, ties, the seeded
  permutation equal to the JAX library's for the same seed, both gathers,
  each against ``scnerf_tpu.native`` on the same inputs (as
  ``tests/test_native.py``); and the numpy fallback without ``g++``.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu import native as jnative  # noqa: E402
from scnerf_tpu.camera import model as jcam  # noqa: E402
from scnerf_tpu.train import profiling as jprof  # noqa: E402
from scnerf_tpu_torch import bridge, native as tnative  # noqa: E402
from scnerf_tpu_torch.train import profiling as tprof  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCheckFiniteTree:
    def _trees(self):
        nan = np.float32(np.nan)
        K = np.array([[20.0, 0, 8, 0], [0, 20.0, 8, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        cam = jcam.init_camera(K, np.tile(np.eye(4), (2, 1, 1)), jcam.CameraConfig(H=16, W=16))
        cam = cam.replace(ray_o_grid=cam.ray_o_grid.at[0, 0, 0].set(nan),
                          intrinsics_noise=cam.intrinsics_noise.at[1].set(np.inf))
        tree = {"coarse": {"pts": [{"w": np.ones((2, 2), np.float32), "b": np.array([0.0, nan])},
                                   {"w": np.full((2, 2), np.inf, np.float32)}]},
                "ok": np.zeros(3, np.float32), "step": np.array(3), "camera": cam}
        t_tree = {"coarse": {"pts": [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
                                     for d in tree["coarse"]["pts"]]},
                  "ok": torch.zeros(3), "step": torch.tensor(3),
                  "camera": bridge.camera_from_numpy(jax.tree.map(np.asarray, cam),
                                                     device="cpu")}
        return tree, t_tree

    @pytest.mark.parametrize("prefix", ["", "state."])
    def test_names_equal_jax(self, prefix):
        tree, t_tree = self._trees()
        want = jprof.check_finite_tree(tree, prefix)
        assert sorted(tprof.check_finite_tree(t_tree, prefix)) == sorted(want)
        assert sorted(want) == sorted(prefix + n for n in (
            "coarse.pts.0.b", "coarse.pts.1.w", "camera.intrinsics_noise", "camera.ray_o_grid"))

    def test_clean_tree(self):
        assert tprof.check_finite_tree({"a": [torch.ones(2)], "b": 1.0}) == []


class TestDebugNans:
    def test_forward_nan_raises_inside_only(self):
        x = torch.tensor([-1.0, 1.0])
        with tprof.debug_nans():
            assert torch.is_anomaly_enabled()
            with pytest.raises(FloatingPointError, match="log"):
                torch.log(x)
        assert not torch.is_anomaly_enabled()
        assert torch.isnan(torch.log(x)).any()  # no check outside the block

    def test_backward_nan_raises_under_anomaly_mode(self):
        x = torch.tensor([0.0], requires_grad=True)
        with tprof.debug_nans(), pytest.raises((FloatingPointError, RuntimeError)), \
                pytest.warns(UserWarning, match="SqrtBackward0"):
            # sqrt(0)'s gradient is inf, times 0 is NaN: only the backward
            # has it; anomaly mode names the forward operator.
            (torch.sqrt(x) * 0.0).sum().backward()

    def test_restores_the_callers_setting(self):
        torch.autograd.set_detect_anomaly(True, check_nan=False)
        try:
            with tprof.debug_nans(False):
                assert not torch.is_anomaly_enabled()
                torch.log(torch.tensor([-1.0]))  # off: no raise
            assert torch.is_anomaly_enabled() and not torch.is_anomaly_check_nan_enabled()
        finally:
            torch.autograd.set_detect_anomaly(False)


class TestRoofline:
    M, N, K = 64, 48, 32

    def _addmm(self, steps):
        x, w, b = torch.randn(self.M, self.K), torch.randn(self.K, self.N), torch.randn(self.N)
        for _ in range(steps):
            torch.addmm(b, x, w)

    def test_addmm_flops(self):
        with tprof.trace(None) as prof:
            self._addmm(3)
        cols, rows = tprof.profile_rows(prof)
        assert cols == list(tprof.PROFILE_COLUMNS)
        summary = tprof.roofline_summary(cols, rows, 3)
        assert summary["measured_flops_per_step"] == 2 * self.M * self.N * self.K
        addmm = [r for r in rows if r[0] == "aten::addmm"]
        assert addmm and addmm[0][1] == "cpu" and addmm[0][2] == 3
        assert summary["device_us_per_step"] > 0  # no card: the operators' self time

    def test_measure_roofline(self, tmp_path):
        got = tprof.measure_roofline(self._addmm, n_steps=4, logdir=str(tmp_path))
        assert set(got) == {"device_us_per_step", "measured_flops_per_step"}
        assert got["measured_flops_per_step"] == 2 * self.M * self.N * self.K
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))
        assert tprof.roofline_summary(list(tprof.PROFILE_COLUMNS), [], 4) == {}


@pytest.fixture(scope="module")
def libraries():
    if not (tnative.available() and jnative.available()):
        pytest.skip("g++ toolchain unavailable; the numpy fallback is tested below")
    return tnative, jnative


class TestNative:
    def test_built_outside_the_package(self, libraries):
        path = tnative.library_path()
        assert path.exists() and path.parent == tnative.BUILD_DIR
        assert os.path.relpath(path, REPO).startswith(os.path.join("build", "native"))
        assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(tnative.__file__)))

    @pytest.mark.parametrize("side", ["left", "right"])
    @pytest.mark.parametrize("Ba,Bv", [(4, 4), (1, 4), (4, 1)])
    def test_searchsorted(self, libraries, side, Ba, Bv):
        rng = np.random.RandomState(0)
        a = np.sort(rng.randn(Ba, 100).astype(np.float32), axis=-1)
        v = rng.randn(Bv, 37).astype(np.float32)
        got = tnative.searchsorted_host(a, v, side)
        np.testing.assert_array_equal(got, jnative.searchsorted_host(a, v, side))
        assert got.dtype == np.int64 and got.shape == (max(Ba, Bv), 37)

    def test_ties(self, libraries):
        a = np.array([[0.0, 1.0, 1.0, 1.0, 2.0]], np.float32)
        v = np.array([[1.0, -1.0, 3.0]], np.float32)
        for side, want in (("left", [1, 0, 5]), ("right", [4, 0, 5])):
            np.testing.assert_array_equal(tnative.searchsorted_host(a, v, side)[0], want)
            np.testing.assert_array_equal(jnative.searchsorted_host(a, v, side)[0], want)

    @pytest.mark.parametrize("n,seed", [(1000, 42), (535_080, 7)])
    def test_permutation_equal_for_a_seed(self, libraries, n, seed):
        got = tnative.permutation_host(n, seed)
        np.testing.assert_array_equal(got, jnative.permutation_host(n, seed))
        np.testing.assert_array_equal(np.sort(got), np.arange(n))
        assert (got != tnative.permutation_host(n, seed + 1)).any()

    def test_gathers(self, libraries):
        rng = np.random.RandomState(1)
        data = rng.rand(50, 7).astype(np.float32)
        idx = rng.randint(0, 50, 64).astype(np.int64)
        np.testing.assert_array_equal(tnative.gather_rows_host(data, idx),
                                      jnative.gather_rows_host(data, idx))
        imgs = rng.rand(3, 6, 7, 3).astype(np.float32)
        px, py = rng.randint(0, 7, 40), rng.randint(0, 6, 40)
        for ii in (rng.randint(0, 3, 40), 2):  # per pixel, or one image broadcast
            got = tnative.gather_pixels_host(imgs, ii, px, py)
            np.testing.assert_array_equal(got, jnative.gather_pixels_host(imgs, ii, px, py))
            np.testing.assert_array_equal(got, imgs[np.broadcast_to(ii, px.shape), py, px])

    def test_numpy_fallback_without_gxx(self, monkeypatch, tmp_path):
        monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
        monkeypatch.setattr(tnative, "library_path", lambda: tmp_path / "native" / "lib.so")
        monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
        tnative.load.cache_clear()
        try:
            assert not tnative.available()
            a = np.sort(np.random.RandomState(0).randn(2, 9).astype(np.float32), -1)
            v = np.random.RandomState(1).randn(2, 5).astype(np.float32)
            np.testing.assert_array_equal(tnative.searchsorted_host(a, v, "right"),
                                          np.stack([np.searchsorted(a[i], v[i], "right")
                                                    for i in range(2)]))
            np.testing.assert_array_equal(tnative.permutation_host(10, 3),
                                          np.random.RandomState(3).permutation(10))
            data = np.arange(12, dtype=np.float32).reshape(4, 3)
            np.testing.assert_array_equal(tnative.gather_rows_host(data, np.array([3, 0])),
                                          data[[3, 0]])
        finally:
            tnative.load.cache_clear()
