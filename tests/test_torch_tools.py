"""The port's host tools against the JAX package's, on the JAX package's own
test cases (``tests/test_tools.py``): the COLMAP model readers and writers,
the NeRF++ dataset preparation, the sqlite database, the posed runner (gated
on the ``colmap`` binary), the classical calibration baselines with and
without ``cv2``, and the visualizers. Both sides are the same numpy and
scipy code, so every comparison is exact; the figures compare as rendered
pixels, equal when both sides drew the same.
"""
import dataclasses
import os
import sqlite3
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import test_tools as jt  # noqa: E402  (the JAX package's cases and scene writers)
from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu.tools import calibration_baselines as jcb  # noqa: E402
from scnerf_tpu.tools import colmap as jcolmap  # noqa: E402
from scnerf_tpu.tools import colmap_db as jdb  # noqa: E402
from scnerf_tpu.tools import colmap_runner as jrunner  # noqa: E402
from scnerf_tpu.tools import visualize as jvis  # noqa: E402
from scnerf_tpu_torch import tools as ttools  # noqa: E402
from scnerf_tpu_torch.core.imaging import write_png  # noqa: E402
from scnerf_tpu_torch.tools import calibration_baselines as tcb  # noqa: E402
from scnerf_tpu_torch.tools import colmap as tcolmap  # noqa: E402
from scnerf_tpu_torch.tools import colmap_db as tdb  # noqa: E402
from scnerf_tpu_torch.tools import colmap_runner as trunner  # noqa: E402
from scnerf_tpu_torch.tools import visualize as tvis  # noqa: E402


def _equal(got, want):
    """Exact equality of nested dicts, lists, dataclasses and arrays."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            _equal(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)) and not (want and isinstance(want[0], (int, float))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_package_exports_alike():
    import scnerf_tpu.tools as jtools

    names = [n for n in dir(jtools) if not n.startswith("_") and callable(getattr(jtools, n))]
    assert names and all(callable(getattr(ttools, n)) for n in names), names


class TestColmapModel:
    def test_binary_readers(self, tmp_path):
        jt.write_synthetic_sparse(str(tmp_path))
        for reader in ("read_cameras_bin", "read_images_bin", "read_points3d_bin"):
            name = {"read_points3d_bin": "points3D.bin"}.get(reader, reader[5:-4] + ".bin")
            path = str(tmp_path / name)
            _equal(getattr(tcolmap, reader)(path), getattr(jcolmap, reader)(path))
        _equal(tcolmap.read_sparse_model(str(tmp_path)), jcolmap.read_sparse_model(str(tmp_path)))

    def test_qvec_and_c2w(self):
        rng = np.random.RandomState(0)
        for q in [np.array([1.0, 0, 0, 0])] + list(rng.randn(8, 4)):
            q = q / np.linalg.norm(q)
            _equal(tcolmap.qvec2rotmat(q), jcolmap.qvec2rotmat(q))
            t = rng.randn(3)
            img = dict(id=1, qvec=q, tvec=t, camera_id=1, name="x", xys=np.zeros((0, 2)),
                       point3D_ids=np.zeros(0, np.int64))
            _equal(tcolmap.colmap_to_c2w(tcolmap.ColmapImage(**img)),
                   jcolmap.colmap_to_c2w(jcolmap.ColmapImage(**img)))

    def test_poses_bounds(self, tmp_path):
        jt.write_synthetic_sparse(str(tmp_path))
        _equal(tcolmap.sparse_to_poses_bounds(str(tmp_path)),
               jcolmap.sparse_to_poses_bounds(str(tmp_path)))
        t = tcolmap.write_poses_bounds(str(tmp_path), str(tmp_path / "t.npy"))
        j = jcolmap.write_poses_bounds(str(tmp_path), str(tmp_path / "j.npy"))
        _equal(t, j)
        _equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))

    @pytest.mark.parametrize("radius", [1.0, 2.5])
    def test_normalize_unit_sphere(self, radius):
        poses = np.eye(4)[None].repeat(3, 0)
        poses[:, :3, 3] = [[10, 0, 0], [0, 20, 0], [0, 0, 5]]
        _equal(tcolmap.normalize_cameras_to_unit_sphere(poses, radius),
               jcolmap.normalize_cameras_to_unit_sphere(poses, radius))

    def test_nerfpp_dataset_prep(self, tmp_path):
        sparse = str(tmp_path / "sparse")
        jt.TestNerfPPDatasetPrep._write_sparse(sparse)
        cd = tcolmap.extract_cam_dict(sparse)
        _equal(cd, jcolmap.extract_cam_dict(sparse))
        norm = tcolmap.normalize_cam_dict(cd, target_radius=1.0)
        _equal(norm, jcolmap.normalize_cam_dict(cd, target_radius=1.0))
        src = tmp_path / "images"
        os.makedirs(src)
        rng = np.random.RandomState(0)
        for name in cd:
            write_png(str(src / name), (rng.rand(48, 64, 3) * 255).astype(np.uint8))
        fisheye = {name: dict(v, k=[0.1, -0.02, 0.5]) for name, v in norm.items()}
        for i, cams in enumerate((norm, fisheye)):
            t = tcolmap.write_nerfpp_split(cams, str(tmp_path / f"t{i}"), "train", str(src))
            j = jcolmap.write_nerfpp_split(cams, str(tmp_path / f"j{i}"), "train", str(src))
            assert os.path.relpath(t, tmp_path / f"t{i}") == os.path.relpath(j, tmp_path / f"j{i}")
            assert _files(t) == _files(j) and len(_files(t)) == 6

    def test_text_model(self, tmp_path):
        rng = np.random.RandomState(3)
        q, _ = np.linalg.qr(rng.randn(3, 3))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        qvec = [float(x) for x in trunner.rotation_to_quaternion(q)]
        pinhole = {"a.png": [64, 48, 50.0, 52.0, 32.0, 24.0, *qvec, 0.5, -0.2, 1.4],
                   "b.png": [64, 48, 51.0, 50.0, 31.0, 23.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.1, 2.0]}
        ids = {"a.png": 3, "b.png": 7}
        trunner.write_posed_init_model(pinhole, ids, str(tmp_path / "t"))
        jrunner.write_posed_init_model(pinhole, ids, str(tmp_path / "j"))
        assert _files(tmp_path / "t") == _files(tmp_path / "j")
        # Points on an image's second line, as COLMAP writes them.
        with open(tmp_path / "t" / "images.txt") as f:
            lines = f.read().splitlines()
        lines[1] = "10.5 20.25 4 11.0 21.0 -1"
        for d in ("t", "j"):
            with open(tmp_path / d / "images.txt", "w") as f:
                f.write("# a comment\n" + "\n".join(lines) + "\n")
        for side in ("t", "j"):
            _equal(tcolmap.read_sparse_model(str(tmp_path / side)),
                   jcolmap.read_sparse_model(str(tmp_path / side)))
            _equal(tcolmap.extract_cam_dict(str(tmp_path / side)),
                   jcolmap.extract_cam_dict(str(tmp_path / side)))


class TestCalibrationBaselines:
    @pytest.mark.parametrize("name", ["mendonca", "classical_kruppa", "simple_kruppa"])
    @pytest.mark.parametrize("scale", [1.0, 1.2])
    def test_refinement(self, name, scale):
        K, fundamental, *_ = jt.synthetic_fundamental_scene()
        x0 = [K[0, 0] * scale, K[1, 1] * scale, K[0, 2], K[1, 2]]
        _equal(getattr(tcb, name)(x0, fundamental), getattr(jcb, name)(x0, fundamental))

    @pytest.mark.parametrize("scale", [1.0, 1.2])
    def test_daq_problem(self, monkeypatch, scale):
        """DAQ's solve is chaotic on these scenes (a singular homography per
        pair): two calls of the JAX function itself end 1e15 apart. So the
        problem it hands ``least_squares`` is held alike instead: the start,
        the options, and the residuals at seeded points."""
        K, fundamental, *_ = jt.synthetic_fundamental_scene()
        x0 = [K[0, 0] * scale, K[1, 1] * scale, K[0, 2], K[1, 2]]
        problems = []

        def record(fun, x, **kwargs):
            problems.append((fun, x, kwargs))
            return type("Result", (), {"x": np.asarray(x, np.float64) * 2.0})()

        monkeypatch.setattr(tcb, "least_squares", record)
        monkeypatch.setattr(jcb, "least_squares", record)
        _equal(tcb.daq(x0, fundamental), jcb.daq(x0, fundamental))
        (tfun, tx, tkw), (jfun, jx, jkw) = problems
        _equal(tx, jx)
        assert tkw == jkw == {"method": "lm", "xtol": 3e-16, "ftol": 3e-16}
        rng = np.random.RandomState(7)
        for p in [jx] + [jx + rng.randn(9) * [10, 10, 5, 5, 0.1, 0.1, 1e-3, 1e-3, 0.1]
                         for _ in range(4)]:
            _equal(tfun(p), jfun(p))

    def test_run_all(self):
        K, fundamental, *_ = jt.synthetic_fundamental_scene(seed=1)
        x0 = [K[0, 0] * 0.9, K[1, 1], K[0, 2], K[1, 2]]
        got, want = tcb.run_all_baselines(x0, fundamental), jcb.run_all_baselines(x0, fundamental)
        assert set(got) == set(want) == {"mendonca", "classical_kruppa", "simple_kruppa", "daq"}
        for name in ("mendonca", "classical_kruppa", "simple_kruppa"):
            _equal(got[name], want[name])
        assert np.shape(got["daq"]) == np.shape(want["daq"]) == (3, 3)

    def test_skew_and_eight_point(self):
        K, fundamental, poses, pts, project = jt.synthetic_fundamental_scene()
        _equal(tcb.skew(np.array([1.0, -2.0, 3.0])), jcb.skew(np.array([1.0, -2.0, 3.0])))
        p0, p1 = project(*poses[0]), project(*poses[1])
        _equal(tcb._eight_point(p0, p1), jcb._eight_point(p0, p1))

    @pytest.mark.parametrize("with_cv2", [True, False])
    def test_fundamental_from_matches(self, monkeypatch, with_cv2):
        """With ``cv2``, RANSAC; without it (the card's machine), the
        normalised eight-point; under 8 matches, None."""
        if with_cv2:
            pytest.importorskip("cv2")
        else:
            monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises
        K, fundamental, poses, pts, project = jt.synthetic_fundamental_scene()
        p0 = project(*poses[0]).astype(np.float32)
        p1 = project(*poses[2]).astype(np.float32)
        got = tcb.fundamental_from_matches(p0, p1)
        _equal(got, jcb.fundamental_from_matches(p0, p1))
        assert got.shape == (3, 3)
        if not with_cv2:
            _equal(got, jcb._eight_point(p0, p1))
        assert tcb.fundamental_from_matches(p0[:7], p1[:7]) is None


class TestVisualize:
    def test_arrays(self):
        K = np.array([[50.0, 0, 32, 0], [0, 50, 24, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        rng = np.random.RandomState(0)
        c2w = np.eye(4)
        c2w[:3, :3], _ = np.linalg.qr(rng.randn(3, 3))
        c2w[:3, 3] = rng.randn(3)
        for depth in (0.3, 1.5):
            _equal(tvis.frustum_corners(K, c2w, 64, 48, depth),
                   jvis.frustum_corners(K, c2w, 64, 48, depth))
        _equal(tvis.radial_distortion_field(np.array([0.1, 0.01]), 48, 64),
               jvis.radial_distortion_field(np.array([0.1, 0.01]), 48, 64))
        _equal(tvis.radial_distortion_field(np.array([-0.2, 0.05]), 30, 40, cx=18.5, cy=16.0),
               jvis.radial_distortion_field(np.array([-0.2, 0.05]), 30, 40, cx=18.5, cy=16.0))
        o, d = rng.randn(6, 3), rng.randn(6, 3)
        _equal(tvis.rays_to_pointcloud(o, d, [0.5, 1.0, 2.0]),
               jvis.rays_to_pointcloud(o, d, [0.5, 1.0, 2.0]))

    def test_epipolar_lines(self):
        K, fundamental, poses, pts, project = jt.synthetic_fundamental_scene()
        p0 = project(*poses[0])[:5]
        _equal(tvis.epipolar_lines(fundamental[0][1], p0, (480, 640)),
               jvis.epipolar_lines(fundamental[0][1], p0, (480, 640)))
        vertical = np.array([[0.0, 0, 0], [0, 0, 1], [1, 0, 0]])  # lines with b = 0
        _equal(tvis.epipolar_lines(vertical, p0, (480, 640)),
               jvis.epipolar_lines(vertical, p0, (480, 640)))

    @pytest.mark.parametrize("plot", ["plot_cameras", "inspect_epipolar_geometry",
                                      "visualize_matches"])
    def test_plots(self, tmp_path, plot):
        pytest.importorskip("matplotlib")
        rng = np.random.RandomState(1)
        K = np.array([[50.0, 0, 32], [0, 50, 24], [0, 0, 1]])
        poses = np.tile(np.eye(4), (3, 1, 1))
        poses[:, :3, 3] = rng.randn(3, 3)
        img0, img1 = rng.rand(48, 64, 3), rng.rand(40, 56, 3)
        kps0, kps1 = rng.rand(12, 2) * 40, rng.rand(12, 2) * 40
        F = np.array([[0.0, -0.001, 0.02], [0.001, 0, -0.03], [-0.02, 0.03, 1.0]])
        args = {"plot_cameras": (poses, K, 64, 48),
                "inspect_epipolar_geometry": (img0, img1, F, kps0[:4]),
                "visualize_matches": (img0, img1, kps0, kps1)}[plot]
        kwargs = {"plot_cameras": dict(unit_sphere=True, second_set=poses * 1.1)}.get(plot, {})
        got = getattr(tvis, plot)(*args, **kwargs)
        want = getattr(jvis, plot)(*args, **kwargs)
        assert got.ndim == 3 and got.shape[-1] == 3
        _equal(got, want)
        assert getattr(tvis, plot)(*args, **kwargs, out_path=str(tmp_path / "p.png")) is None
        assert os.path.getsize(tmp_path / "p.png") > 0

    @pytest.mark.parametrize("plot", ["plot_cameras", "inspect_epipolar_geometry",
                                      "visualize_matches"])
    def test_plots_without_matplotlib(self, monkeypatch, plot):
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        z = np.zeros((2, 2))
        args = {"plot_cameras": (np.eye(4)[None], np.eye(3), 4, 4),
                "inspect_epipolar_geometry": (z, z, np.eye(3), z),
                "visualize_matches": (z[..., None], z[..., None], z, z)}[plot]
        for module in (tvis, jvis):
            with pytest.raises(ImportError):
                getattr(module, plot)(*args)


def _dump(path):
    conn = sqlite3.connect(path)
    try:
        return list(conn.iterdump())
    finally:
        conn.close()


class TestColmapDatabase:
    def _write(self, cdb, path):
        rng = np.random.RandomState(0)
        with cdb.open_database(path) as conn:
            ids = []
            for i in range(3):
                cid = cdb.add_camera(conn, ["PINHOLE", 1, "RADIAL"][i], 640, 480,
                                     [500.0, 500.0, 320.0, 240.0, 0.01][:4 + (i == 2)])
                ids.append(cdb.add_image(conn, f"im{i}.png", cid,
                                         prior_q=[1.0, 0, 0, 0] if i == 1 else None,
                                         prior_t=[0.0, 1, 2] if i == 1 else None))
            for i in range(3):
                cdb.set_keypoints(conn, ids[i], rng.rand(20 + i, [2, 4, 6][i]) * 100)
                cdb.set_descriptors(conn, ids[i], rng.randint(0, 255, (20 + i, 128)))
            m01 = np.stack([np.arange(10), np.arange(10) + 1], -1)
            cdb.set_matches(conn, ids[0], ids[1], m01)
            cdb.set_two_view_geometry(conn, ids[0], ids[1], m01, F=np.arange(9.0).reshape(3, 3))
            cdb.set_matches(conn, ids[2], ids[1], np.stack([np.arange(5), np.arange(5) + 2], -1))
        return ids

    def test_written_alike_and_read_across(self, tmp_path):
        t_path, j_path = str(tmp_path / "t.db"), str(tmp_path / "j.db")
        ids = self._write(tdb, t_path)
        assert self._write(jdb, j_path) == ids
        assert _dump(t_path) == _dump(j_path)
        for path in (t_path, j_path):
            with tdb.open_database(path) as tc, jdb.open_database(path) as jc:
                _equal(tdb.read_images(tc), jdb.read_images(jc))
                _equal(tdb.read_cameras(tc), jdb.read_cameras(jc))
                for i in ids:
                    _equal(tdb.read_keypoints(tc, i), jdb.read_keypoints(jc, i))
                for a in ids:
                    for b in ids:
                        _equal(tdb.read_matches(tc, a, b), jdb.read_matches(jc, a, b))

    def test_reads_reference_data500_schema(self, tmp_path):
        path = str(tmp_path / "ref.db")
        conn = sqlite3.connect(path)
        conn.execute("CREATE TABLE keypoints (image_id INTEGER PRIMARY KEY,"
                     " rows INTEGER, cols INTEGER, data_500 BLOB)")
        conn.execute("CREATE TABLE matches (pair_id INTEGER PRIMARY KEY,"
                     " rows INTEGER, cols INTEGER, data_500 BLOB)")
        kps = np.arange(8, dtype=np.float32).reshape(4, 2)
        conn.execute("INSERT INTO keypoints VALUES (?, ?, ?, ?)", (1, 4, 2, kps.tobytes()))
        m = np.arange(6, dtype=np.uint32).reshape(3, 2)
        conn.execute("INSERT INTO matches VALUES (?, ?, ?, ?)",
                     (tdb.pair_id_from_images(1, 2), 3, 2, m.tobytes()))
        conn.commit()
        try:
            for read, args in (("read_keypoints", (1,)), ("read_matches", (1, 2)),
                               ("read_matches", (2, 1))):
                _equal(getattr(tdb, read)(conn, *args), getattr(jdb, read)(conn, *args))
        finally:
            conn.close()

    def test_pair_id_convention(self):
        for a, b in ((7, 3), (3, 7), (1, 2), (2**31 - 2, 5)):
            assert tdb.pair_id_from_images(a, b) == jdb.pair_id_from_images(a, b)
            pid = tdb.pair_id_from_images(a, b)
            assert tdb.images_from_pair_id(pid) == jdb.images_from_pair_id(pid)
        assert tdb.CAMERA_MODEL_IDS == jdb.CAMERA_MODEL_IDS

    def test_export_from_match_cache(self, tmp_path):
        rng = np.random.RandomState(2)
        images = {f"v{i}.png": {"width": 64, "height": 48, "params": [50.0, 50.0, 32.0, 24.0]}
                  for i in range(3)}
        images["v2.png"].update(model="SIMPLE_RADIAL", params=[50.0, 32.0, 24.0, 0.01],
                                prior_focal_length=False)
        keypoints = {name: rng.rand(12, 2).astype(np.float32) for name in images}
        matches = {("v0.png", "v1.png"): np.stack([np.arange(6), np.arange(6)], -1),
                   ("v2.png", "v0.png"): np.stack([np.arange(4), np.arange(4) + 3], -1)}
        t_path, j_path = str(tmp_path / "t.db"), str(tmp_path / "j.db")
        ids = tdb.write_database_from_matches(t_path, images, keypoints, matches)
        assert ids == jdb.write_database_from_matches(j_path, images, keypoints, matches)
        assert _dump(t_path) == _dump(j_path)


class TestColmapRunner:
    def test_gated_on_the_binary(self, tmp_path):
        assert trunner.colmap_available() == jrunner.colmap_available()
        if trunner.colmap_available():
            pytest.skip("colmap installed; the gating targets its absence")
        for fn, args in ((trunner.run_colmap, ("/nonexistent", str(tmp_path / "ws"))),
                         (trunner.images_to_poses_bounds, ("/nonexistent", str(tmp_path / "ws"))),
                         (trunner.run_colmap_posed, (str(tmp_path), {}, str(tmp_path / "out")))):
            with pytest.raises(RuntimeError, match="colmap binary"):
                fn(*args)
        assert not os.path.exists(tmp_path / "ws") and not os.path.exists(tmp_path / "out")

    def test_rotation_to_quaternion(self):
        rng = np.random.RandomState(4)
        rotations = [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                     np.diag([-1.0, -1, 1])]
        for _ in range(20):
            q, _ = np.linalg.qr(rng.randn(3, 3))
            if np.linalg.det(q) < 0:
                q[:, 0] *= -1
            rotations.append(q)
        for R in rotations:  # every branch of Shepperd's method
            _equal(trunner.rotation_to_quaternion(R), jrunner.rotation_to_quaternion(R))

    def test_cam_dict_to_pinhole(self, tmp_path):
        """With ``img_size``, and without it, the size read from the image:
        a PNG, which the port reads without imageio."""
        rng = np.random.RandomState(5)
        cam_dict = {}
        for i, name in enumerate(("a.png", "b.png")):
            K = np.eye(4)
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 500.0 + i, 510.0, 320.0, 240.0
            W2C = np.eye(4)
            W2C[:3, :3], _ = np.linalg.qr(rng.randn(3, 3))
            W2C[:3, 3] = rng.randn(3)
            cam_dict[name] = {"K": K.reshape(-1).tolist(), "W2C": W2C.reshape(-1).tolist()}
            write_png(str(tmp_path / name), np.zeros((30 + i, 40, 3), np.uint8))
        cam_dict["a.png"]["img_size"] = [640, 480]
        got = trunner.cam_dict_to_pinhole(cam_dict, str(tmp_path))
        _equal(got, jrunner.cam_dict_to_pinhole(cam_dict, str(tmp_path)))
        assert got["b.png"][:2] == [40, 31]
