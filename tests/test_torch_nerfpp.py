"""The port's NeRF++ serving slice against the JAX package: the sphere
geometry, the fg/bg field, K2's autograd function (``pdf_cuda.
sample_pdf_diff``), the cascaded renderer for every ``pdf_impl``, and the
eval-mode serve function behind the batch service. The same weights go to
both packages through the bridge; inputs are made with numpy from a seed.
Small sizes: depth 3, width 32, skip at 1, 4/2 frequencies, cascade (8, 8).

Tolerances, each with its reason:

- geometry and field (same float32 ops, other summation orders): abs error
  below 1e-5 (1e-5 relative where the value reaches 1e6, ``1/(depth+1e-6)``);
- the inverse CDF (values and gradients): ``tests/test_kernels.py``'s
  criteria, since a u within rounding of a CDF edge may move a sample to the
  neighbouring bin (a boundary flip): values median |err| < 1e-6 and under
  0.1% of them off by more than 1e-4; a gradient entry is off when its error
  exceeds 1e-4 of the largest entry, and under 0.2% may be;
- rendered maps (:func:`assert_maps_close`): median |err| < 1e-6, 99.9th
  percentile < 1e-4 and max < 1e-2 (the most one flipped sample moves a map).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from scnerf_tpu import serve as jserve  # noqa: E402
from scnerf_tpu.fields import nerfpp as jfield  # noqa: E402
from scnerf_tpu.geometry import sphere as jsphere  # noqa: E402
from scnerf_tpu.kernels.pdf_pallas import sample_pdf_pallas_core, sample_pdf_pallas_diff  # noqa: E402
from scnerf_tpu.render import nerfpp_renderer as jrend  # noqa: E402
from scnerf_tpu.sampling.pdf import sample_pdf as j_sample_pdf  # noqa: E402
from scnerf_tpu_torch import bridge, serve as tserve  # noqa: E402
from scnerf_tpu_torch.fields import nerfpp as tfield  # noqa: E402
from scnerf_tpu_torch.geometry import sphere as tsphere  # noqa: E402
from scnerf_tpu_torch.kernels import pdf_cuda  # noqa: E402
from scnerf_tpu_torch.render import nerfpp_renderer as trend  # noqa: E402

J_MODEL = jfield.NerfPPConfig(depth=3, width=32, skips=(1,), max_freq_log2=4,
                              max_freq_log2_viewdirs=2)
J_RENDER = jrend.NerfPPRenderConfig(cascade_samples=(8, 8), remat_chunk=0, chunk=96)
T_MODEL = bridge.convert_config(J_MODEL, tfield.NerfPPConfig)
N_IMAGES = 3


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def assert_maps_close(got, want, key):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).ravel()
    assert np.median(err) < 1e-6, key
    assert np.percentile(err, 99.9) < 1e-4, key
    assert err.max() < 1e-2, key


def assert_resample_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.median(err) < 1e-6
    assert (err > 1e-4).mean() < 1e-3


def assert_grads_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    frac_off = (np.abs(got - want) / (np.abs(want).max() + 1e-8) > 1e-4).mean()
    assert frac_off < 2e-3, (name, frac_off)


def _rays(n, seed=0):
    """Origins inside the unit sphere, unnormalised directions."""
    rng = np.random.default_rng(seed)
    ray_o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    ray_d = rng.normal(size=(n, 3)).astype(np.float32)
    return ray_o, ray_d, np.full((n,), 1e-4, np.float32)


@pytest.fixture(scope="module")
def levels():
    """Two cascade levels of JAX weights (with autoexpo) and the port's copy,
    bridged as the whole ``{"levels": [...]}`` tree."""
    k = jax.random.key(0)
    jl = [jfield.init_nerfpp_net(jax.random.fold_in(k, m), J_MODEL, n_images=N_IMAGES,
                                 autoexpo=True) for m in range(2)]
    tl = bridge.tree_to_torch(jax.tree.map(np.asarray, {"levels": jl}))["levels"]
    return jl, tl


class TestSphere:
    def test_intersect_sphere(self):
        """abs error < 1e-5."""
        ray_o, ray_d, _ = _rays(512, seed=1)
        want = jsphere.intersect_sphere(jnp.asarray(ray_o), jnp.asarray(ray_d))
        got = tsphere.intersect_sphere(_t(ray_o), _t(ray_d))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    def test_depth2pts_outside(self):
        """pts abs error < 1e-5; the real depth, up to 1e6 at inverse depth
        0, relative error < 1e-5."""
        ray_o, ray_d, _ = _rays(128, seed=2)
        depth = np.random.default_rng(3).random((128, 16)).astype(np.float32)
        depth[:, 0] = 0.0
        depth[:, -1] = 1.0
        shape = (128, 16, 3)
        jo = jnp.broadcast_to(jnp.asarray(ray_o)[:, None], shape)
        jd = jnp.broadcast_to(jnp.asarray(ray_d)[:, None], shape)
        want_pts, want_real = jsphere.depth2pts_outside(jo, jd, jnp.asarray(depth))
        got_pts, got_real = tsphere.depth2pts_outside(
            _t(ray_o)[:, None].expand(shape), _t(ray_d)[:, None].expand(shape), _t(depth))
        np.testing.assert_allclose(got_pts.numpy(), want_pts, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_real.numpy(), want_real, rtol=1e-5, atol=1e-5)


class TestField:
    def test_init_has_jax_structure(self):
        """The port's init gives the JAX tree, leaf shapes and dtypes."""
        want = jax.tree.map(np.asarray, jfield.init_nerfpp_net(
            jax.random.key(0), J_MODEL, n_images=N_IMAGES, autoexpo=True))
        got = bridge.tree_to_numpy(tfield.init_nerfpp_net(
            T_MODEL, N_IMAGES, autoexpo=True, generator=torch.Generator().manual_seed(0)))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(got["autoexpo"], want["autoexpo"])

    @pytest.mark.parametrize("net,input_dim", [("fg", 3), ("bg", 4)])
    def test_mlpnet_apply(self, levels, net, input_dim):
        """rgb and sigma abs error < 1e-5."""
        jl, tl = levels
        rng = np.random.default_rng(4)
        pts_enc = rng.normal(size=(64, 8, J_MODEL.pos_encoding(input_dim).out_dim))
        views_enc = rng.normal(size=(64, 8, J_MODEL.view_encoding.out_dim))
        pts_enc, views_enc = pts_enc.astype(np.float32), views_enc.astype(np.float32)
        want = jfield.mlpnet_apply(jl[0][net], J_MODEL, jnp.asarray(pts_enc),
                                   jnp.asarray(views_enc))
        got = tfield.mlpnet_apply(tl[0][net], T_MODEL, _t(pts_enc), _t(views_enc))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)

    def test_nerfpp_forward(self, levels):
        """Every map and weight, abs error < 1e-5 (bg processed far to near
        in both)."""
        jl, tl = levels
        ray_o, ray_d, md = _rays(256, seed=5)
        rng = np.random.default_rng(6)
        far = np.asarray(jsphere.intersect_sphere(jnp.asarray(ray_o), jnp.asarray(ray_d)))
        fg_z = np.sort(rng.random((256, 12)), -1).astype(np.float32) * far[:, None]
        bg_z = np.sort(rng.random((256, 10)), -1).astype(np.float32)
        want = jfield.nerfpp_forward(jl[1], J_MODEL, *(jnp.asarray(x) for x in (
            ray_o, ray_d, far, fg_z, bg_z)))
        got = tfield.nerfpp_forward(tl[1], T_MODEL, *(_t(x) for x in (
            ray_o, ray_d, far, fg_z, bg_z)))
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)

    def test_autoexpo_params(self, levels):
        """Exact: an abs and an add."""
        jl, tl = levels
        ae = np.array([[-0.3, 0.1], [0.7, -0.2], [0.5, 0.0]], np.float32)
        idx = np.array([2, 0, 1, 1])
        want = jfield.autoexpo_params({"autoexpo": jnp.asarray(ae)}, jnp.asarray(idx))
        got = tfield.autoexpo_params({"autoexpo": _t(ae)}, torch.from_numpy(idx))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def _pdf_inputs(n=48, b=33, s=24, seed=7):
    """Sorted bins, weights with empty rays and empty bins (the eps and the
    denominator guard act), u, and a cotangent."""
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.random((n, b)) * 4 + 1, -1).astype(np.float32)
    weights = rng.random((n, b - 1)).astype(np.float32)
    weights[: n // 8] = 0.0
    weights[n // 8: n // 4, ::3] = 0.0
    u = rng.random((n, s)).astype(np.float32)
    cot = rng.normal(size=(n, s)).astype(np.float32)
    return bins, weights, u, cot


class TestSamplePdfDiff:
    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    def test_values_and_grads_match_jax(self, variant):
        """Against ``sample_pdf_pallas_diff`` in interpret mode, values and
        the gradients into bins, weights and u under a random cotangent."""
        bins, weights, u, cot = _pdf_inputs()
        j_in = tuple(jnp.asarray(x) for x in (bins, weights, u))

        def loss(b, w, uu):
            return jnp.sum(sample_pdf_pallas_diff(b, w, uu, variant) * cot)

        with pltpu.force_tpu_interpret_mode():
            want = sample_pdf_pallas_diff(*j_in, variant)
            j_grads = jax.grad(loss, argnums=(0, 1, 2))(*j_in)
        t_in = [_t(x).requires_grad_() for x in (bins, weights, u)]
        before = pdf_cuda.diff_launches
        got = pdf_cuda.sample_pdf_diff(*t_in, variant)
        (got * _t(cot)).sum().backward()
        assert pdf_cuda.diff_launches == before  # CPU tensors take the plain twin
        assert_resample_close(got.detach().numpy(), want)
        for x, g, name in zip(t_in, j_grads, ("bins", "weights", "u")):
            assert_grads_close(x.grad.numpy(), g, name)

    def test_forward_outputs_match_jax_kernel(self):
        """The search counts equal JAX's kernel's (int32, exact here); the
        CDF comes only when asked."""
        from scnerf_tpu.kernels.pdf_pallas import _pallas_fwd

        bins, weights, u, _ = _pdf_inputs(seed=8)
        with pltpu.force_tpu_interpret_mode():
            _, want_inds = _pallas_fwd(*(jnp.asarray(x) for x in (bins, weights, u)), "nerfpp")
        out, inds, cdf = pdf_cuda.sample_pdf_fwd(_t(bins), _t(weights), _t(u), "nerfpp")
        assert cdf is None and inds.dtype == torch.int32
        np.testing.assert_array_equal(inds.numpy(), want_inds)
        _, _, cdf = pdf_cuda.sample_pdf_fwd(_t(bins), _t(weights), _t(u), "nerfpp",
                                            with_cdf=True)
        assert cdf.shape == bins.shape
        np.testing.assert_allclose(cdf[:, -1].numpy(), 1.0, atol=1e-6)

    def test_pallas_stopgrad_runs_the_nerfpp_variant(self):
        """``pdf_impl="pallas_stopgrad"``: the JAX package's TPU branch calls
        ``sample_pdf_pallas``, the NeRF variant (eps 1e-5, full-CDF search,
        no width widening), by mistake. The port runs the NeRF++ variant, as
        every other ``pdf_impl`` does, and only cuts the gradient into the
        bins."""
        rng = np.random.default_rng(9)
        depth = np.sort(rng.random((64, 9)) * 3 + 0.5, -1).astype(np.float32)
        mid = 0.5 * (depth[:, 1:] + depth[:, :-1])
        weights = rng.uniform(0.5, 1.0, (64, 9)).astype(np.float32)
        # Bin 3 weighs between the two variants' guards: NeRF++ (eps 1e-6)
        # interpolates across it, NeRF (eps 1e-5) snaps to its lower edge.
        weights[:, 4] = 2e-5
        w = weights[:, 1:-1].astype(np.float64) + 1e-6
        cdf = np.cumsum(w / w.sum(-1, keepdims=True), -1)
        u = rng.uniform(0.0, 0.99, (64, 8)).astype(np.float32)
        u[:, 0] = 0.5 * (cdf[:, 2] + cdf[:, 3])  # the middle of bin 3
        outs = {}
        for impl in ("xla", "pallas_stopgrad"):
            cfg = trend.NerfPPRenderConfig(cascade_samples=(9, 8), pdf_impl=impl)
            d = _t(depth).requires_grad_()
            merged = trend._resample(cfg, None, d, _t(weights), 8, _t(u))
            merged.sum().backward()
            outs[impl] = merged.detach().numpy(), d.grad.numpy()
        np.testing.assert_array_equal(outs["pallas_stopgrad"][0], outs["xla"][0])
        # Each old depth passes its unit gradient through the merge; with the
        # bins cut off, nothing else reaches it.
        np.testing.assert_array_equal(outs["pallas_stopgrad"][1], 1.0)
        assert np.abs(outs["xla"][1] - 1.0).max() > 1e-3

        # The renderer ran the K2 wrapper's NeRF++ variant, and nothing else.
        new = pdf_cuda.sample_pdf_diff(_t(mid), _t(weights[:, 1:-1]), _t(u), "nerfpp").numpy()
        np.testing.assert_array_equal(
            outs["pallas_stopgrad"][0], np.sort(np.concatenate([depth, new], -1), -1))

        # JAX: the NeRF++ variant, and the kernel under sample_pdf_pallas
        # (what its TPU branch runs) on the same u.
        j_args = (jnp.asarray(mid), jnp.asarray(weights[:, 1:-1]))
        nerfpp = np.asarray(j_sample_pdf(None, *j_args, 8, u=jnp.asarray(u), variant="nerfpp"))
        with pltpu.force_tpu_interpret_mode():
            nerf = np.asarray(sample_pdf_pallas_core(*j_args, jnp.asarray(u)))
        assert_resample_close(new[:, 1:], nerfpp[:, 1:])
        # Inside a bin 4e-6 wide in the CDF, t = (u - cdf)/denom carries the
        # CDF's rounding (~1e-7) magnified: compare against the bin's width.
        bin_width = mid[:, 4] - mid[:, 3]
        assert (np.abs(new[:, 0] - nerfpp[:, 0]) < 0.05 * bin_width).all()
        assert (np.abs(new[:, 0] - nerf[:, 0]) > 0.2 * bin_width).all()


class TestRenderRays:
    @pytest.mark.parametrize("pdf_impl", ["xla", "pallas_vjp"])
    def test_injected_randoms(self, levels, pdf_impl):
        """Both levels, every map, with the jitter and the inverse-CDF u
        injected; the JAX ``pallas_vjp`` side runs in interpret mode."""
        jl, tl = levels
        jcfg = J_RENDER.replace(pdf_impl=pdf_impl)
        tcfg = bridge.convert_config(jcfg, trend.NerfPPRenderConfig)
        n = 256
        ray_o, ray_d, md = _rays(n, seed=10)
        rng = np.random.default_rng(11)
        rands = [tuple(rng.random((n, s)).astype(np.float32) for _ in range(2))
                 for s in jcfg.cascade_samples]
        with pltpu.force_tpu_interpret_mode():
            want = jrend.render_rays_nerfpp(
                jl, J_MODEL, jcfg, *(jnp.asarray(x) for x in (ray_o, ray_d, md)),
                jax.random.key(0), rands=[tuple(map(jnp.asarray, r)) for r in rands])
        got = trend.render_rays_nerfpp(
            tl, T_MODEL, tcfg, *(_t(x) for x in (ray_o, ray_d, md)),
            rands=[tuple(map(_t, r)) for r in rands])
        assert len(got) == len(want) == 2
        assert got[1]["fg_weights"].shape == (n, 16)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].shape == w[k].shape, k
                assert_maps_close(g[k].numpy(), w[k], k)

    def test_eval_render_chunked(self, levels):
        """Deterministic resampling; 200 rays in chunks of 96 (edge-padded)."""
        jl, tl = levels
        ray_o, ray_d, md = _rays(200, seed=12)
        jcfg = J_RENDER.replace(perturb=False)
        want = jrend.render_chunked_nerfpp(
            jl, J_MODEL, jcfg, *(jnp.asarray(x) for x in (ray_o, ray_d, md)),
            jax.random.key(0))
        got = trend.render_chunked_nerfpp(
            tl, T_MODEL, bridge.convert_config(jcfg, trend.NerfPPRenderConfig),
            *(_t(x) for x in (ray_o, ray_d, md)))
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert_maps_close(got[k].numpy(), want[k], k)

    def test_rejects_unknown_pdf_impl(self, levels):
        _, tl = levels
        cfg = trend.NerfPPRenderConfig(cascade_samples=(8, 8), pdf_impl="pallas")
        with pytest.raises(ValueError, match="pdf_impl"):
            trend.render_rays_nerfpp(tl, T_MODEL, cfg, *(_t(x) for x in _rays(4)))


class TestServe:
    def test_service_matches_jax_at_a_ragged_size(self, levels):
        """300 rays through a batch of 128: three slices, the last
        edge-padded; numpy in, numpy out."""
        jl, tl = levels
        rays = _rays(300, seed=13)
        jsvc = jserve.RenderService(
            jserve.make_nerfpp_serve_fn(jl, J_MODEL, J_RENDER), jserve.nerfpp_serve_specs(128))
        tcfg = bridge.convert_config(J_RENDER, trend.NerfPPRenderConfig)
        tsvc = tserve.RenderService(
            tserve.make_nerfpp_serve_fn(tl, T_MODEL, tcfg), 128, device="cpu")
        want = jsvc(*rays)
        before = pdf_cuda.diff_launches
        got = tsvc(*rays)
        assert pdf_cuda.diff_launches == before
        assert set(got) == set(want) == {"rgb", "fg_depth", "bg_lambda"}
        for k in want:
            assert isinstance(got[k], np.ndarray) and got[k].shape == want[k].shape
            assert_maps_close(got[k], want[k], k)

    @pytest.mark.parametrize("flag", [True, False])
    def test_serve_fns_restore_tf32_flags(self, levels, flag):
        """Both serve functions compute with TF32 off and leave the caller's
        flags as they found them."""
        from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp
        from scnerf_tpu_torch.render.renderer import RenderConfig

        _, tl = levels
        nerf_cfg = NeRFConfig(depth=2, width=16, skips=(), multires=2, multires_views=2)
        nerf_params = {"coarse": init_nerf_mlp(nerf_cfg), "fine": None}
        fns = [
            (tserve.make_nerfpp_serve_fn(
                tl, T_MODEL, trend.NerfPPRenderConfig(cascade_samples=(8, 8))),
             [_t(x) for x in _rays(4)]),
            (tserve.make_nerf_serve_fn(
                nerf_params, nerf_cfg, RenderConfig(n_samples=4, n_importance=4)),
             [_t(x) for x in _rays(4)[:2]] + [torch.full((4,), 0.5), torch.full((4,), 2.0)]),
        ]
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        try:
            for fn, args in fns:
                torch.backends.cuda.matmul.allow_tf32 = flag
                torch.backends.cudnn.allow_tf32 = flag
                fn(*args)
                assert torch.backends.cuda.matmul.allow_tf32 is flag
                assert torch.backends.cudnn.allow_tf32 is flag
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def test_fp32_inference_sets_and_restores(self):
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            with pytest.raises(RuntimeError, match="inside"):
                with tserve.fp32_inference():
                    assert not torch.backends.cuda.matmul.allow_tf32
                    assert not torch.backends.cudnn.allow_tf32
                    assert torch.is_inference_mode_enabled()
                    raise RuntimeError("inside")
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
