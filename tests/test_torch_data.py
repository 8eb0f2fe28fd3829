"""The port's host-side data modules against the JAX package's, on seeded
inputs: the config parser on every file under ``configs/``, the zlib PNG
reader and writer against ``imageio``, the LLFF loader on a seeded scene,
the noise injection, the pools and pixel draws, the pair selection and the
match cache. These modules are numpy on both sides, so every comparison is
exact unless stated otherwise.
"""
import dataclasses
import glob
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
imageio = pytest.importorskip("imageio.v2")

from _torch_support import hang_watchdog  # noqa: E402,F401
from _torch_support import smooth_texture, write_llff_scene  # noqa: E402
from scnerf_tpu.core import config as jconfig  # noqa: E402
from scnerf_tpu.data import batching as jbatching  # noqa: E402
from scnerf_tpu.data import llff as jllff  # noqa: E402
from scnerf_tpu.data import noise as jnoise  # noqa: E402
from scnerf_tpu.matching import pairs as jpairs  # noqa: E402
from scnerf_tpu.matching import provider as jprovider  # noqa: E402
from scnerf_tpu_torch.core import config as tconfig  # noqa: E402
from scnerf_tpu_torch.core.imaging import read_png, to8b, write_png  # noqa: E402
from scnerf_tpu_torch.data import batching as tbatching  # noqa: E402
from scnerf_tpu_torch.data import llff as tllff  # noqa: E402
from scnerf_tpu_torch.data import noise as tnoise  # noqa: E402
from scnerf_tpu_torch.matching import pairs as tpairs  # noqa: E402
from scnerf_tpu_torch.matching import provider as tprovider  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.txt"), recursive=True))


def _quiet(*_):
    pass


class TestConfig:
    @pytest.mark.parametrize("path", CONFIGS)
    def test_every_config_resolves_alike(self, path):
        full = os.path.join(REPO, path)
        j = jconfig.load_experiment(full, warn=_quiet)
        t = tconfig.load_experiment(full, warn=_quiet)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.to_json() == j.to_json()
        for pipeline in ("nerf", "nerfpp"):
            assert (tconfig.resolved_noise_scales(t.camera, pipeline)
                    == jconfig.resolved_noise_scales(j.camera, pipeline))

    def test_flags_and_warnings_alike(self):
        flags = {"no_batching": "True", "use_camera": True, "lrate_decay_steps": 750,
                 "cascade_samples": "64,128", "ft_path": "x.tar", "scene": "truck",
                 "datadir": "/data", "bogus": 3, "N_rand": 77, "raw_noise_std": 1}
        j_warn, t_warn = [], []
        j = jconfig.experiment_from_flags(dict(flags), warn=j_warn.append)
        t = tconfig.experiment_from_flags(dict(flags), warn=t_warn.append)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t_warn == j_warn and len(t_warn) == 1
        for v in ("1e0", "True", "none", "3", "2.5", "64,128", "-1,2", "abc"):
            assert tconfig._parse_value(v) == jconfig._parse_value(v)


def _imageio_png(path, img):
    imageio.imwrite(path, img)


class TestPng:
    @pytest.mark.parametrize("channels", [0, 2, 3, 4])
    @pytest.mark.parametrize("writer", ["imageio", "port"])
    def test_read_png_equals_imageio(self, tmp_path, channels, writer):
        rng = np.random.RandomState(channels)
        shape = (23, 37) if channels == 0 else (23, 37, channels)
        # Noise and smooth gradients, so the encoder picks several filters.
        img = rng.randint(0, 256, shape).astype(np.uint8)
        img[:12] = (np.linspace(0, 255, 37)[None, :, None] if channels else
                    np.linspace(0, 255, 37)[None, :]).astype(np.uint8)
        path = str(tmp_path / "x.png")
        (_imageio_png if writer == "imageio" else write_png)(path, img)
        got, want = read_png(path), np.asarray(imageio.imread(path))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img)

    @pytest.mark.parametrize("channels", [1, 3, 4])
    def test_every_filter_type(self, tmp_path, channels):
        """A PNG whose rows cycle through the five filters (None, Sub, Up,
        Average, Paeth), encoded here by the specification: the port and
        imageio read the same pixels."""
        import struct
        import zlib

        img = to8b(smooth_texture(np.random.RandomState(channels), 20, 17))
        img = img[..., 0] if channels == 1 else np.concatenate(
            [img, img[..., :channels - 3]], axis=-1)
        h = img.shape[0]
        raw = img.reshape(h, -1).astype(np.int32)
        prev, rows = np.zeros(raw.shape[1], np.int32), []
        for y in range(h):
            kind, cur = y % 5, raw[y]
            a = np.concatenate([np.zeros(channels, np.int32), cur[:-channels]])
            c = np.concatenate([np.zeros(channels, np.int32), prev[:-channels]])
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = [0, a, prev, (a + prev) // 2,
                    np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))][kind]
            rows.append(np.concatenate([[kind], (cur - pred) & 0xFF]).astype(np.uint8))
            prev = cur

        def chunk(kind, data):
            return (struct.pack(">I", len(data)) + kind + data
                    + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

        color = {1: 0, 3: 2, 4: 6}[channels]
        path = str(tmp_path / "filters.png")
        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n"
                    + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h, 8, color, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(np.concatenate(rows).tobytes()))
                    + chunk(b"IEND", b""))
        np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
        np.testing.assert_array_equal(read_png(path), img)

    def test_rejects_16_bit(self, tmp_path):
        path = str(tmp_path / "x16.png")
        imageio.imwrite(path, np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
        with pytest.raises(ValueError, match="imageio"):
            read_png(path)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_llff_scene(tmp_path_factory.mktemp("llff") / "scene", n_views=9, seed=3)


class TestLlff:
    @pytest.mark.parametrize("spherify", [False, True])
    @pytest.mark.parametrize("noise", [False, True])
    def test_load_llff_alike(self, scene, spherify, noise):
        cfg = dict(intrinsic_scale=0.1, rotation_deg=5.0, translation=0.1) if noise else {}
        j = jllff.load_llff(scene, factor=8, spherify=spherify, llffhold=4,
                            noise=jnoise.NoiseConfig(**cfg), rng=np.random.RandomState(7))
        t = tllff.load_llff(scene, factor=8, spherify=spherify, llffhold=4,
                            noise=tnoise.NoiseConfig(**cfg), rng=np.random.RandomState(7))
        for f in dataclasses.fields(j):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        assert t.images.shape == (9, 24, 32, 3) and list(t.i_test) == [0, 4, 8]

    def test_jpeg_without_imageio_names_it(self, tmp_path, monkeypatch):
        import builtins

        real = builtins.__import__

        def no_imageio(name, *args, **kwargs):
            if name.startswith("imageio"):
                raise ImportError("no imageio here")
            return real(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_imageio)
        with pytest.raises(ImportError, match="needs imageio"):
            tllff._imread(str(tmp_path / "x.jpg"))


class TestNoise:
    @pytest.mark.parametrize("mode", ["none", "both", "rot", "trans"])
    def test_inject_pose_noise_alike(self, mode):
        rng = np.random.RandomState(0)
        poses = rng.randn(6, 3, 4)
        i_train = np.array([1, 2, 4, 5])
        kw = dict(intrinsic_scale=0.2, rotation_deg=10.0, translation=0.3,
                  run_without_colmap=mode)
        jp, jf = jnoise.inject_pose_noise(poses, 500.0, i_train, jnoise.NoiseConfig(**kw),
                                          np.random.RandomState(5))
        tp, tf = tnoise.inject_pose_noise(poses, 500.0, i_train, tnoise.NoiseConfig(**kw),
                                          np.random.RandomState(5))
        np.testing.assert_array_equal(tp, jp)
        assert tf == jf
        np.testing.assert_array_equal(tp[[0, 3]][:, :3], poses[[0, 3]])


class TestBatching:
    def test_ray_pool_draws_alike(self):
        rng = np.random.RandomState(1)
        o, d, c = (rng.rand(50, 3).astype(np.float32) for _ in range(3))
        jp, tp = jbatching.RayPool(o, d, c, seed=4), tbatching.RayPool(o, d, c, seed=4)
        for _ in range(12):  # crosses two epochs
            a, b = tp.next_batch(9), jp.next_batch(9)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        assert tp.epoch == jp.epoch == 2

    def test_pixel_pool_draws_alike(self):
        jp = jbatching.PixelPool(3, 5, 7, rng=np.random.RandomState(2))
        tp = tbatching.PixelPool(3, 5, 7, rng=np.random.RandomState(2))
        for _ in range(14):
            for a, b in zip(tp.next_batch(10), jp.next_batch(10)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert tp.epoch == jp.epoch == 1

    @pytest.mark.parametrize("precrop", [None, 0.5])
    def test_sample_pixels_and_gather_alike(self, precrop):
        images = np.random.RandomState(3).rand(4, 12, 10, 3).astype(np.float32)
        j_rng, t_rng = np.random.RandomState(9), np.random.RandomState(9)
        for _ in range(5):
            jx, jy = jbatching.sample_pixels(j_rng, 12, 10, 20, precrop)
            tx, ty = tbatching.sample_pixels(t_rng, 12, 10, 20, precrop)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            np.testing.assert_array_equal(tbatching.gather_target(images, 2, tx, ty),
                                          jbatching.gather_target(images, 2, jx, jy))
        idx = np.array([0, 3, 1])
        px, py = np.array([1.0, 9.0, 4.0]), np.array([11.0, 0.0, 5.0])
        np.testing.assert_array_equal(tbatching.gather_target(images, idx, px, py),
                                      jbatching.gather_target(images, idx, px, py))


class TestMatching:
    def test_pairs_alike(self):
        rng = np.random.RandomState(4)
        from scnerf_tpu_torch.data.noise import axis_angle_matrices, random_axes

        E = np.tile(np.eye(4), (7, 1, 1))
        E[:, :3, :3] = axis_angle_matrices(random_axes(rng, 7), rng.rand(7) * np.pi / 3)
        i_map = np.array([0, 2, 3, 5, 6, 8, 9])
        for threshold in (10.0, 30.0, 60.0):
            for imap in (None, i_map):
                j = jpairs.image_pair_candidates(E, threshold, imap)
                t = tpairs.image_pair_candidates(E, threshold, imap)
                assert j.keys() == t.keys()
                for k in j:
                    np.testing.assert_array_equal(t[k], j[k])
                np.testing.assert_array_equal(tpairs.flatten_pairs(t), jpairs.flatten_pairs(j))

    @pytest.mark.parametrize("n,conf", [(5, False), (12, True), (12, False), (0, False)])
    def test_pad_matches_alike(self, n, conf):
        rng = np.random.RandomState(n)
        k0, k1 = rng.rand(n, 2).astype(np.float32), rng.rand(n, 2).astype(np.float32)
        c = rng.rand(n).astype(np.float32) if conf else None
        got = tprovider.pad_matches(tprovider.PairMatches(k0, k1, c), 8)
        want = jprovider.pad_matches(jprovider.PairMatches(k0, k1, c), 8)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    def test_npz_round_trip_both_ways(self, tmp_path):
        rng = np.random.RandomState(6)
        t_cache, j_cache = tprovider.PrecomputedMatches(), jprovider.PrecomputedMatches()
        for (i, j), conf in (((0, 1), True), ((3, 2), False)):
            k0, k1 = rng.rand(6, 2).astype(np.float32), rng.rand(6, 2).astype(np.float32)
            c = rng.rand(6).astype(np.float32) if conf else None
            t_cache.put(i, j, tprovider.PairMatches(k0, k1, c))
            j_cache.put(i, j, jprovider.PairMatches(k0, k1, c))
        t_cache.save(str(tmp_path / "t.npz"))
        j_cache.save(str(tmp_path / "j.npz"))
        # Each side reads the other's file.
        t_read = tprovider.PrecomputedMatches(str(tmp_path / "j.npz"))
        j_read = jprovider.PrecomputedMatches(str(tmp_path / "t.npz"))
        assert t_read.pairs() == j_read.pairs() == [(0, 1), (2, 3)]
        for i, j in ((0, 1), (1, 0), (2, 3), (3, 2)):
            a, b = t_read.get(i, j), j_read.get(i, j)
            np.testing.assert_array_equal(a.kps0, b.kps0)
            np.testing.assert_array_equal(a.kps1, b.kps1)
            if b.confidence is None:
                assert a.confidence is None
            else:
                np.testing.assert_array_equal(a.confidence, b.confidence)
        assert t_read.get(4, 5) is None

    def test_matcher_from_config(self):
        cfg = tconfig.experiment_from_flags({"matcher": "superglue"}, warn=_quiet).camera
        with pytest.warns(UserWarning, match="superglue"):
            assert tprovider.matcher_from_config(cfg) is None
        cfg = tconfig.experiment_from_flags({"matcher": "precomputed"}, warn=_quiet).camera
        assert tprovider.matcher_from_config(cfg) is None

    def test_sift_matches_alike(self, scene):
        if not tprovider.sift_available():
            pytest.skip("needs cv2 with SIFT")
        images = jllff.load_llff(scene, factor=8, llffhold=4).images
        pairs = np.array([[1, 2], [2, 3], [5, 7]])
        t = tprovider.build_match_cache(images, pairs, tprovider.SIFTMatcher())
        j = jprovider.build_match_cache(images, pairs, jprovider.SIFTMatcher())
        for i, k in pairs:
            a, b = t.get(int(i), int(k)), j.get(int(i), int(k))
            np.testing.assert_array_equal(a.kps0, b.kps0)
            np.testing.assert_array_equal(a.kps1, b.kps1)
            np.testing.assert_array_equal(a.confidence, b.confidence)
        assert tprovider.rgb_to_gray(images[0]).dtype == np.float32
        np.testing.assert_array_equal(tprovider.rgb_to_gray(images[0]),
                                      jprovider.rgb_to_gray(images[0]))
