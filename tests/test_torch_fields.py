"""The port's positional encoding and NeRF MLP against the JAX package.

Same seeded numpy inputs and the same weights (through the bridge) into both.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu.fields import encoding as jenc  # noqa: E402
from scnerf_tpu.fields import nerf as jnerf  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.fields import encoding as tenc  # noqa: E402
from scnerf_tpu_torch.fields import nerf as tnerf  # noqa: E402

SMALL = dict(depth=3, width=32, skips=(1,), multires=4, multires_views=2)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


class TestEncoding:
    # atol 1e-6: sin/cos of the same float32 products, from two libm
    # implementations that may differ by an ulp of an O(1) value.
    @pytest.mark.parametrize("cfg", [
        dict(n_freqs=10), dict(n_freqs=4), dict(n_freqs=3, include_input=False),
        dict(n_freqs=5, log_sampling=False), dict(n_freqs=4, max_freq_log2=2.5),
        dict(n_freqs=0),
    ])
    def test_matches_jax(self, cfg):
        x = np.random.default_rng(0).uniform(-1.5, 1.5, size=(7, 5, 3)).astype(np.float32)
        want = jenc.positional_encoding(jnp.asarray(x), jenc.EncodingConfig(**cfg))
        got = tenc.positional_encoding(_t(x), tenc.EncodingConfig(**cfg))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    def test_freq_bands(self):
        """Powers of two are exact; linear bands within an ulp."""
        cfg = dict(n_freqs=10)
        np.testing.assert_array_equal(
            tenc.freq_bands(tenc.EncodingConfig(**cfg)).numpy(),
            np.asarray(jenc.freq_bands(jenc.EncodingConfig(**cfg))))
        cfg = dict(n_freqs=7, log_sampling=False)
        np.testing.assert_array_max_ulp(
            tenc.freq_bands(tenc.EncodingConfig(**cfg)).numpy(),
            np.asarray(jenc.freq_bands(jenc.EncodingConfig(**cfg))), maxulp=1)


class TestQueryField:
    # rtol/atol 1e-5: the matmuls sum in another order on each side.
    @pytest.mark.parametrize("cfg", [
        SMALL,
        dict(SMALL, use_viewdirs=False),
        dict(depth=4, width=48, skips=(1, 2), multires=6, multires_views=3),
    ])
    def test_raw_matches_jax(self, cfg):
        jcfg = jnerf.NeRFConfig(**cfg)
        tcfg = bridge.convert_config(jcfg, tnerf.NeRFConfig)
        params = jax.tree.map(np.asarray, jnerf.init_nerf_mlp(jax.random.key(3), jcfg))
        rng = np.random.default_rng(1)
        pts = rng.normal(size=(16, 9, 3)).astype(np.float32)
        vd = rng.normal(size=(16, 3)).astype(np.float32)
        vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
        want = jnerf.query_field(params, jcfg, jnp.asarray(pts), jnp.asarray(vd))
        got = tnerf.query_field(bridge.tree_to_torch(params, device="cpu"), tcfg, _t(pts), _t(vd))
        assert got.shape == want.shape == (16, 9, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_chunked_jax_query_equals_plain_port(self):
        """The port calls query_field where JAX renders through the remat'd
        query_field_chunked: same values."""
        jcfg = jnerf.NeRFConfig(**SMALL)
        params = jax.tree.map(np.asarray, jnerf.init_nerf_mlp(jax.random.key(4), jcfg))
        rng = np.random.default_rng(2)
        pts = rng.normal(size=(8, 16, 3)).astype(np.float32)
        vd = rng.normal(size=(8, 3)).astype(np.float32)
        want = jnerf.query_field_chunked(params, jcfg, jnp.asarray(pts), jnp.asarray(vd), 4)
        got = tnerf.query_field(bridge.tree_to_torch(params, device="cpu"),
                                bridge.convert_config(jcfg, tnerf.NeRFConfig),
                                _t(pts), _t(vd))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_init_statistics(self):
        """Xavier-uniform bounds with the activation gain, zero bias."""
        cfg = tnerf.NeRFConfig(**SMALL)
        p = tnerf.init_nerf_mlp(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        w = p["pts"][1]["w"]
        limit = np.sqrt(2.0) * np.sqrt(6.0 / (32 + 32))
        assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
        assert float(p["rgb"]["b"].abs().max()) == 0.0
        q = tnerf.init_nerf_mlp(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        torch.testing.assert_close(p["views"]["w"], q["views"]["w"], rtol=0, atol=0)
