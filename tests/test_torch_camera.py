"""The port's camera, rays and NDC warp against the JAX package.

Same seeded numpy inputs into both. Tolerance atol 1e-6: the values are O(1)
float32 and the two packages sum the small matrix products in different
orders, which moves the last bit or two.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu.camera import model as jmodel  # noqa: E402
from scnerf_tpu.camera import rays as jrays  # noqa: E402
from scnerf_tpu.geometry import ndc as jndc  # noqa: E402
from scnerf_tpu.geometry import so3 as jso3  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera import model as tmodel  # noqa: E402
from scnerf_tpu_torch.camera import rays as trays  # noqa: E402
from scnerf_tpu_torch.geometry import ndc as tndc  # noqa: E402
from scnerf_tpu_torch.geometry import so3 as tso3  # noqa: E402

ATOL = 1e-6
H, W = 24, 32


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def _cameras(seed, n_images=4, **cfg):
    """The same noisy camera in both packages: (jax Camera, port Camera)."""
    rng = np.random.default_rng(seed)
    config = jmodel.CameraConfig(H=H, W=W, grid_size=4, **cfg)
    K = np.array([[30.0, 0, 15.5, 0], [0, 31.0, 12.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    E = np.tile(np.eye(4), (n_images, 1, 1))
    E[:, :3, :3] = _rotations(rng, n_images)
    E[:, :3, 3] = rng.normal(size=(n_images, 3))
    cam = jmodel.init_camera(K, E, config, k=np.array([0.04, -0.02]))
    noise = dict(
        intrinsics_noise=rng.normal(size=4) * (0.01 if cfg.get("multiplicative_noise") else 0.5),
        extrinsics_noise=rng.normal(size=(n_images, 9)),
        distortion_noise=rng.normal(size=2),
        ray_o_grid=rng.normal(size=cam.ray_o_grid.shape) * 10,
        ray_d_grid=rng.normal(size=cam.ray_d_grid.shape) * 10,
    )
    cam = cam.replace(**{k: jnp.asarray(v, jnp.float32) for k, v in noise.items()})
    return cam, bridge.camera_from_numpy(jax.tree.map(np.asarray, cam), device="cpu")


class TestSO3:
    def test_ortho2rotation_and_back(self):
        rng = np.random.default_rng(0)
        poses = rng.normal(size=(64, 6)).astype(np.float32)
        want = jso3.ortho2rotation(jnp.asarray(poses))
        got = tso3.ortho2rotation(_t(poses))
        _close(got, want)
        _close(tso3.rotation2orth(got), jso3.rotation2orth(want))
        _close(tso3.embed_rotation_44(got), jso3.embed_rotation_44(want))

    def test_ortho2rotation_clamps_degenerate_input(self):
        poses = np.zeros((2, 6), np.float32)
        poses[1, :3] = [1e-9, 0, 0]
        _close(tso3.ortho2rotation(_t(poses)), jso3.ortho2rotation(jnp.asarray(poses)))

    def test_intrinsics(self):
        params = np.array([812.5, 799.0, 503.5, 377.25], np.float32)
        K_j = jso3.intrinsic_param_to_K(jnp.asarray(params))
        K_t = tso3.intrinsic_param_to_K(_t(params))
        np.testing.assert_array_equal(K_t.numpy(), np.asarray(K_j))
        K = np.asarray(K_j).copy()
        K[0, 1] = 0.75  # skew
        np.testing.assert_allclose(tso3.K_inverse_3x3(_t(K)).numpy(),
                                   np.asarray(jso3.K_inverse_3x3(jnp.asarray(K))),
                                   rtol=1e-6, atol=1e-9)


class TestCameraDecoders:
    @pytest.mark.parametrize("cfg", [{}, dict(multiplicative_noise=True)])
    def test_intrinsic_extrinsic_distortion(self, cfg):
        jcam, tcam = _cameras(1, **cfg)
        _close(tmodel.get_intrinsic(tcam), jmodel.get_intrinsic(jcam))
        _close(tmodel.get_extrinsics(tcam), jmodel.get_extrinsics(jcam))
        idx = np.array([3, 0, 2])
        _close(tmodel.get_extrinsic(tcam, torch.as_tensor(idx)),
               jmodel.get_extrinsic(jcam, jnp.asarray(idx)))
        _close(tmodel.get_extrinsic(tcam, 1), jmodel.get_extrinsic(jcam, 1))
        _close(tmodel.get_distortion(tcam), jmodel.get_distortion(jcam))

    @pytest.mark.parametrize("cfg", [dict(use_distortion=True),
                                     dict(use_distortion=True, tied_ray_noise=True), {}])
    def test_camera_log_images(self, cfg):
        """The dashboard's images: the noise grids and, on a distortion
        camera, the radial field through ``tools/visualize.py``. Within
        ATOL: the field is normalised in float32 from ``k``, which the two
        packages decode with the camera's rounding."""
        jcam, tcam = _cameras(4, **cfg)
        got, want = tmodel.camera_log_images(tcam), jmodel.camera_log_images(jcam)
        assert set(got) == set(want)
        assert ("camera/radial_field" in got) == cfg.get("use_distortion", False)
        for name in want:
            assert got[name].shape == np.shape(want[name]) and got[name].dtype == np.float32
            _close(got[name], want[name])

    def test_noise_grid_interpolation(self):
        rng = np.random.default_rng(2)
        grid = rng.normal(size=(6, 8, 3)).astype(np.float32)
        px = rng.integers(0, W, 200).astype(np.float32)
        py = rng.integers(0, H, 200).astype(np.float32)
        px[:4] = [0, W - 1, 0, W - 1]  # the borders, where the clamps act
        py[:4] = [0, 0, H - 1, H - 1]
        _close(tmodel.sample_noise_grid(_t(grid), _t(px), _t(py), H, W),
               jmodel.sample_noise_grid(jnp.asarray(grid), jnp.asarray(px),
                                        jnp.asarray(py), H, W))


class TestPixelsToRays:
    @pytest.mark.parametrize("cfg,add_noise", [
        (dict(), True),  # OpenGL, non-zero noise grids
        (dict(), False),
        (dict(convention="opencv", use_distortion=True, pixel_offset=0.5), True),
        (dict(convention="opencv", use_distortion=True, pixel_offset=0.5,
              tied_ray_noise=True), True),
    ])
    def test_per_ray_images(self, cfg, add_noise):
        jcam, tcam = _cameras(3, **cfg)
        rng = np.random.default_rng(4)
        px = rng.integers(0, W, 300).astype(np.float32)
        py = rng.integers(0, H, 300).astype(np.float32)
        idx = rng.integers(0, 4, 300)
        want = jrays.pixels_to_rays(jcam, px, py, image_idx=jnp.asarray(idx),
                                    add_noise=add_noise)
        got = trays.pixels_to_rays(tcam, px, py, image_idx=torch.as_tensor(idx),
                                   add_noise=add_noise)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w)

    def test_full_image_with_one_c2w(self):
        jcam, tcam = _cameras(5)
        c2w = np.asarray(jmodel.get_extrinsic(jcam, 2))
        want = jrays.rays_full_image(jcam, c2w=jnp.asarray(c2w))
        got = trays.rays_full_image(tcam, c2w=_t(c2w))
        for g, w in zip(got, want):
            assert g.shape == (H * W, 3)
            _close(g, w)

    def test_full_image_pixels_order(self):
        px_j, py_j = jrays.full_image_pixels(H, W)
        px_t, py_t = trays.full_image_pixels(H, W, device="cpu")
        np.testing.assert_array_equal(px_t.numpy(), np.asarray(px_j))
        np.testing.assert_array_equal(py_t.numpy(), np.asarray(py_j))

    def test_rays_no_camera(self):
        rng = np.random.default_rng(6)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = _rotations(rng, 1)[0]
        c2w[:3, 3] = rng.normal(size=3)
        want = jrays.rays_no_camera(H, W, 28.0, jnp.asarray(c2w))
        got = trays.rays_no_camera(H, W, 28.0, _t(c2w))
        for g, w in zip(got, want):
            _close(g, w)


class TestNDC:
    @pytest.mark.parametrize("focal", [(28.0, 28.0), (27.5, 29.25)])
    def test_matches_jax(self, focal):
        rng = np.random.default_rng(7)
        rays_o = (rng.normal(size=(256, 3)) * 0.2).astype(np.float32)
        rays_d = rng.normal(size=(256, 3)).astype(np.float32)
        rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.5  # forward-facing
        want = jndc.ndc_rays(H, W, *focal, 1.0, jnp.asarray(rays_o), jnp.asarray(rays_d))
        got = tndc.ndc_rays(H, W, *focal, 1.0, _t(rays_o), _t(rays_d))
        for g, w in zip(got, want):
            _close(g, w)
