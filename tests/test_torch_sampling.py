"""The port's samplers against the JAX package: stratified depths, the
row-wise sorted search, and the plain inverse-CDF ``sample_pdf`` (the K1
kernel's twin) against both JAX's ``sample_pdf`` and its Pallas kernel.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog, interpret  # noqa: E402,F401
from scnerf_tpu.kernels.pdf_pallas import sample_pdf_pallas_core  # noqa: E402
from scnerf_tpu.sampling import pdf as jpdf  # noqa: E402
from scnerf_tpu.sampling.searchsorted import searchsorted as j_searchsorted  # noqa: E402
from scnerf_tpu.sampling import stratified as jstrat  # noqa: E402
from scnerf_tpu_torch.sampling import pdf as tpdf  # noqa: E402
from scnerf_tpu_torch.sampling.searchsorted import searchsorted as t_searchsorted  # noqa: E402
from scnerf_tpu_torch.sampling import stratified as tstrat  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_resample_close(got, want, bins):
    """The criterion of tests/test_kernels.py for inverse-CDF outputs: the
    CDFs are summed in another order, so a u within rounding of a CDF edge
    may land in the neighbouring bin (a boundary flip); everything else
    agrees to float32 rounding."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.median(err) < 1e-6
    assert (err > 1e-4).mean() < 1e-3
    assert np.asarray(got).min() >= float(np.min(bins)) - 1e-5
    assert np.asarray(got).max() <= float(np.max(bins)) + 1e-5


def _pdf_inputs(seed, n, b, s):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.random((n, b)).astype(np.float32) * 4 + 1, axis=-1)
    weights = rng.random((n, b - 1)).astype(np.float32)
    weights[: n // 8] = 0.0  # all-zero rows: the eps makes them uniform
    weights[n // 8: n // 4, ::3] = 0.0  # empty bins: guarded denominators
    u = rng.random((n, s)).astype(np.float32)
    return bins, weights, u


class TestStratified:
    # rtol/atol 1e-6: XLA may fuse or reassociate the lerp and the two
    # reciprocals of lindisp; that moves depths up to 6 by a few ulps.
    @pytest.mark.parametrize("lindisp", [False, True])
    @pytest.mark.parametrize("jitter", [False, True])
    def test_matches_jax(self, lindisp, jitter):
        rng = np.random.default_rng(0)
        near = rng.uniform(0.5, 1.0, 32).astype(np.float32)
        far = rng.uniform(2.0, 6.0, 32).astype(np.float32)
        t_rand = rng.random((32, 16)).astype(np.float32) if jitter else None
        want = jstrat.stratified_z_vals(
            None, jnp.asarray(near), jnp.asarray(far), 16, lindisp=lindisp,
            perturb=False, t_rand=None if t_rand is None else jnp.asarray(t_rand))
        got = tstrat.stratified_z_vals(
            None, _t(near), _t(far), 16, lindisp=lindisp, perturb=False,
            t_rand=None if t_rand is None else _t(t_rand))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    def test_generator_jitter_stays_in_intervals(self):
        near = torch.full((64,), 2.0)
        far = torch.full((64,), 6.0)
        z0 = tstrat.stratified_z_vals(None, near, far, 8, perturb=False)
        z = tstrat.stratified_z_vals(torch.Generator().manual_seed(0), near, far, 8)
        mids = 0.5 * (z0[:, 1:] + z0[:, :-1])
        assert (z[:, 1:-1] >= mids[:, :-1]).all() and (z[:, 1:-1] <= mids[:, 1:]).all()
        assert not torch.equal(z, z0)

    @pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 10, 33, 64, 100, 128, 192])
    def test_depths_within_an_ulp_of_jax(self, n):
        """torch.linspace and jnp.linspace round a few points apart."""
        near, far = torch.full((2,), 2.0), torch.full((2,), 6.0)
        got = tstrat.stratified_z_vals(None, near, far, n, perturb=False)
        want = jstrat.stratified_z_vals(None, jnp.full((2,), 2.0), jnp.full((2,), 6.0), n,
                                        perturb=False)
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


class TestSearchsorted:
    """Exact against JAX's compare-and-sum."""

    @pytest.mark.parametrize("side", ["left", "right"])
    @pytest.mark.parametrize("rows", [(16, 16), (1, 16), (16, 1)])
    def test_matches_jax(self, side, rows):
        rng = np.random.default_rng(1)
        a = np.sort(rng.random((rows[0], 33)).astype(np.float32), axis=-1)
        v = rng.random((rows[1], 20)).astype(np.float32)
        v[0, :5] = a[0, :5]  # ties, where left and right differ
        want = j_searchsorted(jnp.asarray(a), jnp.asarray(v), side=side)
        got = t_searchsorted(_t(a), _t(v), side=side)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_rejects_bad_input(self):
        with pytest.raises(ValueError, match="batch mismatch"):
            t_searchsorted(torch.zeros(3, 4), torch.zeros(2, 4))
        with pytest.raises(ValueError, match="2D"):
            t_searchsorted(torch.zeros(4), torch.zeros(2, 4))
        with pytest.raises(ValueError, match="side"):
            t_searchsorted(torch.zeros(2, 4), torch.zeros(2, 4), side="middle")


class TestSamplePdf:
    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    @pytest.mark.parametrize("shape", [(64, 63, 64), (48, 33, 24)])
    def test_matches_jax_sample_pdf(self, variant, shape):
        bins, weights, u = _pdf_inputs(2, *shape)
        want = jpdf.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights),
                               shape[2], u=jnp.asarray(u), variant=variant)
        got = tpdf.sample_pdf(None, _t(bins), _t(weights), shape[2], u=_t(u),
                              variant=variant)
        assert got.shape == want.shape
        assert_resample_close(got.numpy(), want, bins)

    @pytest.mark.parametrize("shape", [(64, 63, 64), (40, 62, 33), (16, 64, 8)])
    def test_matches_pallas_kernel(self, shape):
        """The Pallas kernel run in interpret mode, as tests/test_kernels.py
        runs it on the CPU."""
        bins, weights, u = _pdf_inputs(3, *shape)
        want = interpret(lambda: sample_pdf_pallas_core(jnp.asarray(bins), jnp.asarray(weights),
                                                        jnp.asarray(u)))
        got = tpdf.sample_pdf(None, _t(bins), _t(weights), shape[2], u=_t(u))
        assert_resample_close(got.numpy(), want, bins)

    def test_det_matches_jax_and_reaches_u_one(self):
        """Deterministic u runs up to 1.0 >= cdf[-1]: the index clamps and
        the denominator guard decide the last samples."""
        bins, weights, _ = _pdf_inputs(4, 32, 63, 64)
        want = jpdf.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights), 64, det=True)
        got = tpdf.sample_pdf(None, _t(bins), _t(weights), 64, det=True)
        assert_resample_close(got.numpy(), want, bins)
        np.testing.assert_allclose(got[:, -1].numpy(), bins[:, -1], rtol=0, atol=1e-4)

    def test_uniforms(self):
        det = tpdf.pdf_uniforms(None, 3, 8, True, device="cpu")
        assert det.is_contiguous() and det.shape == (3, 8)
        np.testing.assert_array_max_ulp(det[1].numpy(), np.asarray(jnp.linspace(0.0, 1.0, 8)),
                                        maxulp=1)
        g = torch.Generator().manual_seed(0)
        r = tpdf.pdf_uniforms(g, 3, 8, False, device="cpu")
        assert r.shape == (3, 8) and (r >= 0).all() and (r < 1).all()
