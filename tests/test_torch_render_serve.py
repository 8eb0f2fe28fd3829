"""The port's serving slice as a whole against the JAX package: compositing,
``render_rays`` with every random draw injected, the eval-mode chunked
render, and the serve function (with and without NDC) behind the batch
service. The same weights go to both through the bridge.

Maps are compared by :func:`assert_maps_close`: median |err| < 1e-6, and
the 99.9th percentile < 1e-4, because a u within rounding of a CDF edge can
move one fine sample to the neighbouring bin (a boundary flip), which moves
that ray's maps a little. disp = acc/depth reaches 1e10 where acc -> 0, so
its error is taken relative to max(|disp|, 1).

Deterministic resampling (eval mode: the chunked render and the serve path)
puts its last u at exactly 1.0, and whether cdf[-1] rounds above or below
1.0 depends on the order of the sums: that flips the last fine sample of
about one ray in twenty between the two packages (5.2% of 20k random rows
on the CPU). There the percentile of the criterion is the 99th, and every
error stays below 1e-2, the most one sample moved within its bin can do.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu import serve as jserve  # noqa: E402
from scnerf_tpu.fields.nerf import NeRFConfig as JNeRFConfig  # noqa: E402
from scnerf_tpu.fields.nerf import init_nerf_mlp as j_init_nerf_mlp  # noqa: E402
from scnerf_tpu.render import composite as jcomp  # noqa: E402
from scnerf_tpu.render import renderer as jrend  # noqa: E402
from scnerf_tpu_torch import bridge, serve as tserve  # noqa: E402
from scnerf_tpu_torch.fields.nerf import NeRFConfig  # noqa: E402
from scnerf_tpu_torch.kernels import pdf_cuda  # noqa: E402
from scnerf_tpu_torch.render import composite as tcomp  # noqa: E402
from scnerf_tpu_torch.render import renderer as trend  # noqa: E402

J_MODEL = JNeRFConfig(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
J_RENDER = jrend.RenderConfig(n_samples=8, n_importance=8, remat_chunk=0,
                              near=0.5, far=2.0, chunk=512)
T_MODEL = bridge.convert_config(J_MODEL, NeRFConfig)
T_RENDER = bridge.convert_config(J_RENDER, trend.RenderConfig)
MAPS = ("rgb", "acc", "depth", "disp")


def assert_maps_close(got, want, key, *, pct=99.9):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    err = np.abs(got - want)
    if key.startswith("disp"):
        err = err / np.maximum(np.abs(want), 1.0)
    assert np.median(err) < 1e-6, key
    assert np.percentile(err, pct) < 1e-4, key
    assert err.max() < 1e-2, key


def assert_det_maps_close(got, want, key):
    """Eval-mode maps: see the module docstring for the flips at u = 1."""
    if key == "z_std":  # the std of the fine depths shows each flip directly
        err = np.abs(np.asarray(got) - np.asarray(want))
        assert np.median(err) < 1e-6 and err.max() < 1e-2
    else:
        assert_maps_close(got, want, key, pct=99.0)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def params():
    k = jax.random.key(0)
    jp = {"coarse": j_init_nerf_mlp(k, J_MODEL),
          "fine": j_init_nerf_mlp(jax.random.fold_in(k, 1), J_MODEL)}
    return jp, bridge.tree_to_torch(jax.tree.map(np.asarray, jp), device="cpu")


def _rays(n, seed=0, forward=False):
    rng = np.random.default_rng(seed)
    rays_o = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    rays_d = rng.normal(size=(n, 3)).astype(np.float32)
    if forward:  # forward-facing, as NDC needs
        rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 1.0
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    near = np.full((n,), 0.5, np.float32)
    far = np.full((n,), 2.0, np.float32)
    return rays_o, rays_d, near, far


def _viewdirs(rays_d):
    return rays_d / (np.linalg.norm(rays_d, axis=-1, keepdims=True) + 1e-10)


class TestComposite:
    @pytest.mark.parametrize("white_bkgd", [False, True])
    def test_raw2outputs(self, white_bkgd):
        rng = np.random.default_rng(1)
        raw = rng.normal(size=(32, 12, 4)).astype(np.float32)
        z = np.sort(rng.uniform(0.5, 2.0, (32, 12)).astype(np.float32), -1)
        rays_d = rng.normal(size=(32, 3)).astype(np.float32)
        noise = rng.normal(size=(32, 12)).astype(np.float32)
        want = jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rays_d),
                                 raw_noise_std=0.5, white_bkgd=white_bkgd,
                                 noise=jnp.asarray(noise))
        got = tcomp.raw2outputs(_t(raw), _t(z), _t(rays_d), raw_noise_std=0.5,
                                white_bkgd=white_bkgd, noise=_t(noise))
        for k in ("rgb", "acc", "depth", "disp", "weights"):
            assert got[k].shape == want[k].shape
            assert_maps_close(got[k].numpy(), want[k], k)


class TestRenderRays:
    @pytest.mark.parametrize("cfg", [
        dict(),
        dict(lindisp=True, white_bkgd=True),
        dict(n_importance=0),
    ])
    def test_injected_randoms(self, params, cfg):
        jp, tp = params
        jcfg = J_RENDER.replace(raw_noise_std=1.0, **cfg)
        tcfg = bridge.convert_config(jcfg, trend.RenderConfig)
        n, s, si = 2048, jcfg.n_samples, jcfg.n_importance
        rays_o, rays_d, near, far = _rays(n, seed=2)
        rng = np.random.default_rng(3)
        rands = {"t": rng.random((n, s)), "noise0": rng.normal(size=(n, s)),
                 "noise1": rng.normal(size=(n, s + si)), "u": rng.random((n, si))}
        rands = {k: v.astype(np.float32) for k, v in rands.items()}
        want = jrend.render_rays(
            jp, J_MODEL, jcfg, jnp.asarray(rays_o), jnp.asarray(rays_d),
            jnp.asarray(_viewdirs(rays_d)), near, far, jax.random.key(0),
            rands={k: jnp.asarray(v) for k, v in rands.items()})
        got = trend.render_rays(
            tp, T_MODEL, tcfg, _t(rays_o), _t(rays_d), _t(_viewdirs(rays_d)),
            _t(near), _t(far), rands={k: _t(v) for k, v in rands.items()})
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert_maps_close(got[k].numpy(), want[k], k)

    def test_eval_render_chunked(self, params):
        """Deterministic resampling; 2000 rays in chunks of 512 (edge-padded)."""
        jp, tp = params
        rays_o, rays_d, near, far = _rays(2000, seed=4)
        vd = _viewdirs(rays_d)
        want = jrend.render_chunked(
            jp, J_MODEL, J_RENDER.eval_mode(), jnp.asarray(rays_o), jnp.asarray(rays_d),
            jnp.asarray(vd), 0.5, 2.0, jax.random.key(0))
        before = pdf_cuda.launches
        got = trend.render_chunked(tp, T_MODEL, T_RENDER.eval_mode(), _t(rays_o),
                                   _t(rays_d), _t(vd), 0.5, 2.0)
        assert pdf_cuda.launches == before  # CPU tensors take the plain twin
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert_det_maps_close(got[k].numpy(), want[k], k)


class TestServe:
    @pytest.mark.parametrize("ndc", [None, (24, 32, 28.0, 29.5)])
    def test_serve_fn_matches_jax(self, params, ndc):
        jp, tp = params
        rays = _rays(2048, seed=5, forward=True)
        want = jserve.make_nerf_serve_fn(jp, J_MODEL, J_RENDER, ndc=ndc)(
            *(jnp.asarray(x) for x in rays))
        got = tserve.make_nerf_serve_fn(tp, T_MODEL, T_RENDER, ndc=ndc)(
            *(_t(x) for x in rays))
        assert set(got) == set(MAPS)
        for k in MAPS:
            assert got[k].shape == want[k].shape
            assert_det_maps_close(got[k].numpy(), want[k], k)
        assert float(got["rgb"].max()) <= 1.0

    def test_service_pads_and_matches_jax(self, params):
        """2000 rays through a batch of 512: four slices, the last
        edge-padded; numpy in, numpy out."""
        jp, tp = params
        ndc = (24, 32, 28.0, 28.0)
        rays = _rays(2000, seed=6, forward=True)
        jsvc = jserve.RenderService(
            jserve.make_nerf_serve_fn(jp, J_MODEL, J_RENDER, ndc=ndc),
            jserve.nerf_serve_specs(512))
        tsvc = tserve.RenderService(
            tserve.make_nerf_serve_fn(tp, T_MODEL, T_RENDER, ndc=ndc), 512, device="cpu")
        want = jsvc(*rays)
        got = tsvc(*rays)
        for k in MAPS:
            assert isinstance(got[k], np.ndarray) and got[k].shape == want[k].shape
            assert_det_maps_close(got[k], want[k], k)
        # Tensors are taken as well, and a request of one ray is padded.
        one = tsvc(*(_t(x[:1]) for x in rays))
        np.testing.assert_allclose(one["rgb"], got["rgb"][:1], rtol=0, atol=1e-6)

    def test_service_rejects_empty_request(self, params):
        _, tp = params
        svc = tserve.RenderService(
            tserve.make_nerf_serve_fn(tp, T_MODEL, T_RENDER), 16, device="cpu")
        with pytest.raises(ValueError, match="empty"):
            svc(*(x[:0] for x in _rays(4)))
