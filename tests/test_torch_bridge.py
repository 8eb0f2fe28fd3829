"""The bridge between the JAX package and the PyTorch port: parameters and
configs go JAX -> numpy -> port -> numpy unchanged (exact equality: the
bridge only copies)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scnerf_tpu.camera.model import CameraConfig as JCameraConfig  # noqa: E402
from scnerf_tpu.camera.model import init_camera as j_init_camera  # noqa: E402
from scnerf_tpu.fields.nerf import NeRFConfig as JNeRFConfig  # noqa: E402
from scnerf_tpu.fields.nerf import init_nerf_mlp as j_init_nerf_mlp  # noqa: E402
from scnerf_tpu.fields.nerfpp import NerfPPConfig as JNerfPPConfig  # noqa: E402
from scnerf_tpu.fields.nerfpp import init_nerfpp_net as j_init_nerfpp_net  # noqa: E402
from scnerf_tpu.render.nerfpp_renderer import NerfPPRenderConfig as JNerfPPRenderConfig  # noqa: E402
from scnerf_tpu.render.renderer import RenderConfig as JRenderConfig  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera.model import CameraConfig  # noqa: E402
from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp  # noqa: E402
from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig  # noqa: E402
from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig  # noqa: E402
from scnerf_tpu_torch.render.renderer import RenderConfig  # noqa: E402

SMALL = dict(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
SMALL_PP = dict(depth=3, width=32, skips=(1,), max_freq_log2=4, max_freq_log2_viewdirs=2)


def _assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _jax_camera(seed=0, n_images=3, **cfg):
    rng = np.random.default_rng(seed)
    config = JCameraConfig(H=24, W=32, grid_size=4, **cfg)
    K = np.array([[30.0, 0, 16, 0], [0, 31.0, 12, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    E = np.tile(np.eye(4), (n_images, 1, 1))
    E[:, :3, 3] = rng.normal(size=(n_images, 3))
    cam = j_init_camera(K, E, config, k=np.array([0.05, -0.01]))
    leaves = dict(
        intrinsics_noise=rng.normal(size=4) * 0.1,
        extrinsics_noise=rng.normal(size=(n_images, 9)),
        distortion_noise=rng.normal(size=2),
        ray_o_grid=rng.normal(size=cam.ray_o_grid.shape),
        ray_d_grid=rng.normal(size=cam.ray_d_grid.shape),
    )
    return cam.replace(**{k: jnp.asarray(v, jnp.float32) for k, v in leaves.items()})


class TestMLP:
    @pytest.mark.parametrize("use_viewdirs", [True, False])
    def test_round_trip_exact(self, use_viewdirs):
        cfg = JNeRFConfig(use_viewdirs=use_viewdirs, **SMALL)
        params = {
            "coarse": j_init_nerf_mlp(jax.random.key(0), cfg),
            "fine": j_init_nerf_mlp(jax.random.key(1), cfg),
        }
        np_params = jax.tree.map(np.asarray, params)
        port = bridge.tree_to_torch(np_params)
        assert port["coarse"]["pts"][0]["w"].dtype == torch.float32
        _assert_trees_equal(bridge.tree_to_numpy(port), np_params)

    def test_port_init_has_jax_structure_and_layout(self):
        cfg = JNeRFConfig(**SMALL)
        want = jax.tree.map(np.asarray, j_init_nerf_mlp(jax.random.key(0), cfg))
        got = bridge.tree_to_numpy(init_nerf_mlp(
            bridge.convert_config(cfg, NeRFConfig),
            generator=torch.Generator().manual_seed(0)))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert x.shape == y.shape  # w is (in, out) on both sides

    def test_nerfpp_levels_with_autoexpo_round_trip_exact(self):
        """The NeRF++ tree ``{"levels": [{fg, bg, autoexpo}, ...]}``."""
        cfg = JNerfPPConfig(**SMALL_PP)
        params = {"levels": [
            j_init_nerfpp_net(jax.random.key(m), cfg, n_images=4, autoexpo=True)
            for m in range(2)]}
        params["levels"][1]["autoexpo"] = params["levels"][1]["autoexpo"] * 1.5 - 0.25
        np_params = jax.tree.map(np.asarray, params)
        port = bridge.tree_to_torch(np_params)
        assert isinstance(port["levels"], list) and len(port["levels"]) == 2
        assert port["levels"][0]["autoexpo"].shape == (4, 2)
        assert port["levels"][1]["bg"]["base"][0]["w"].dtype == torch.float32
        _assert_trees_equal(bridge.tree_to_numpy(port), np_params)


class TestCamera:
    @pytest.mark.parametrize("cfg", [
        {}, dict(convention="opencv", use_distortion=True, tied_ray_noise=True,
                 pixel_offset=0.5),
    ])
    def test_round_trip_exact(self, cfg):
        cam = jax.tree.map(np.asarray, _jax_camera(**cfg))
        port = bridge.camera_from_numpy(cam)
        assert dataclasses.asdict(port.config) == dataclasses.asdict(
            bridge.convert_config(cam.config, CameraConfig))
        back = bridge.camera_to_numpy(port)
        for name, value in back.items():
            np.testing.assert_array_equal(value, getattr(cam, name))
        # ... and back into a JAX camera, leaf for leaf.
        _assert_trees_equal(cam.replace(**back), cam)
        assert JCameraConfig(**bridge.config_to_dict(port.config)) == cam.config


class TestConfigs:
    @pytest.mark.parametrize("jax_cls,port_cls,kwargs", [
        (JNeRFConfig, NeRFConfig, SMALL),
        (JRenderConfig, RenderConfig, dict(n_samples=8, n_importance=4, near=0.5)),
        (JCameraConfig, CameraConfig, dict(H=7, W=9, convention="opencv")),
        (JNerfPPConfig, NerfPPConfig, SMALL_PP),
        (JNerfPPRenderConfig, NerfPPRenderConfig,
         dict(cascade_samples=(64, 128), perturb=False, pdf_impl="pallas_vjp")),
    ])
    def test_round_trip(self, jax_cls, port_cls, kwargs):
        jcfg = jax_cls(**kwargs)
        port = bridge.convert_config(jcfg, port_cls)
        assert jax_cls(**bridge.config_to_dict(port)) == jcfg

    @pytest.mark.parametrize("jcfg", [
        JNeRFConfig(compute_dtype="bfloat16"),
        JRenderConfig(remat_stash_bf16=True),
    ])
    def test_refuses_value_changing_jax_levers(self, jcfg):
        port_cls = NeRFConfig if isinstance(jcfg, JNeRFConfig) else RenderConfig
        with pytest.raises(ValueError, match="does not support"):
            bridge.convert_config(jcfg, port_cls)

    def test_nerfpp_refuses_bf16(self):
        with pytest.raises(ValueError, match="does not support"):
            bridge.convert_config(JNerfPPConfig(compute_dtype="bfloat16"), NerfPPConfig)

    def test_accepts_jax_only_levers_that_keep_values(self):
        jcfg = JRenderConfig(pdf_impl="pallas", remat_chunk=0)
        assert bridge.convert_config(jcfg, RenderConfig) == RenderConfig()

    @pytest.mark.parametrize("fuse_fgbg", [False, True])
    def test_nerfpp_accepts_fuse_fgbg_and_remat(self, fuse_fgbg):
        """``fuse_fgbg`` is the same function up to float32 reassociation and
        ``remat_chunk`` a training lever: any value converts."""
        port = bridge.convert_config(JNerfPPConfig(fuse_fgbg=fuse_fgbg), NerfPPConfig)
        assert port == NerfPPConfig()
        jr = JNerfPPRenderConfig(cascade_samples=(64, 128), remat_chunk=0,
                                 pdf_impl="pallas_stopgrad")
        assert bridge.convert_config(jr, NerfPPRenderConfig) == NerfPPRenderConfig(
            cascade_samples=(64, 128), pdf_impl="pallas_stopgrad")
