"""The scene and traffic generators are deterministic per seed, and the
frames follow the LLFF loader's render path."""
from __future__ import annotations

import numpy as np

from portbench import scene as scenes
from portbench.drivers.serve_nerf import Path, checked_pixels, frame_rays, pixel_dirs
from portbench.reference.llff import llff_poses
from portbench.tests.tiny import fern, truck


def test_fern_scene_is_deterministic_per_seed(tmp_path):
    sc = fern()["scene"]
    a = scenes.write_fern_scene(str(tmp_path / "a"), 5, sc, 8, 8)
    b = scenes.write_fern_scene(str(tmp_path / "b"), 5, sc, 8, 8)
    c = scenes.write_fern_scene(str(tmp_path / "c"), 6, sc, 8, 8)
    assert np.array_equal(a["images"], b["images"]) and np.array_equal(a["poses"], b["poses"])
    assert not np.array_equal(a["images"], c["images"])
    assert (tmp_path / "a" / "images_8" / "IMG_0000.png").read_bytes() == \
        (tmp_path / "b" / "images_8" / "IMG_0000.png").read_bytes()
    m1 = scenes.projected_matches(a["poses"][a["i_train"]], a["K"], sc["H"], sc["W"], 60, 1)
    m2 = scenes.projected_matches(b["poses"][b["i_train"]], b["K"], sc["H"], sc["W"], 60, 1)
    assert m1.keys() == m2.keys()
    assert all(np.array_equal(m1[k][0], m2[k][0]) for k in m1)
    assert sum(len(v[0]) for v in m1.values()) > 0


def test_scene_reads_back_through_the_port(tmp_path):
    from scnerf_tpu_torch.data.llff import load_llff
    from scnerf_tpu_torch.data.nerfpp_split import load_nerfpp_split

    sc = fern()["scene"]
    a = scenes.write_fern_scene(str(tmp_path / "fern"), 3, sc, 8, 8)
    data = load_llff(str(tmp_path / "fern"), factor=8, llffhold=8)
    assert np.array_equal((data.images * 255).round().astype(np.uint8), a["images"])
    assert np.array_equal(data.gt_poses, a["poses"])
    assert np.array_equal(data.i_train, a["i_train"])
    assert data.gt_intrinsic.tolist() == a["K"].tolist()
    t = scenes.write_truck_scene(str(tmp_path / "truck"), 3, truck()["scene"])
    split = load_nerfpp_split(str(tmp_path / "truck"), "train")
    assert np.array_equal((split.images * 255).round().astype(np.uint8), t["images"])
    assert np.array_equal(split.poses, t["poses"].astype(np.float32))


def test_frames_follow_the_loaders_render_path(tmp_path):
    from scnerf_tpu_torch.data.llff import load_llff

    sc = fern()["scene"]
    scenes.write_fern_scene(str(tmp_path / "fern"), 4, sc, 8, 8)
    data = load_llff(str(tmp_path / "fern"), factor=8, llffhold=8)
    rows = scenes.fern_poses_bounds(np.random.RandomState(4), sc)
    lf = llff_poses(rows, sc["H"], sc["W"], 8, 8)
    assert lf["render_poses"].shape == (120, 4, 4)
    np.testing.assert_allclose(lf["render_poses"][:, :3, :4], data.render_poses[:, :3, :4],
                               rtol=0, atol=1e-5)


def test_every_seed_renders_the_path_from_its_own_pose():
    poses = np.eye(4, dtype=np.float32)[None].repeat(120, 0)
    a, b, c = (Path(s, poses) for s in (1, 1, 2))
    ra = [a.next() for _ in range(130)]
    assert ra == [b.next() for _ in range(130)]
    assert ra != [c.next() for _ in range(130)]
    assert all((y - x) % 120 == 1 for x, y in zip(ra, ra[1:]))
    o, d = frame_rays(pixel_dirs(6, 8, 7.0), poses[0])
    assert o.shape == d.shape == (48, 3) and d.dtype == np.float32
    assert np.allclose(d[0], [-4 / 7, 3 / 7, -1])


def test_checked_pixels_are_distinct_and_deterministic_per_seed():
    a, b, c = (checked_pixels(s, 3, 1000, 100) for s in (5, 5, 6))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(len(np.unique(x)) == 34 and x.max() < 1000 for x in a)
