"""K3's port (``scnerf_tpu_torch/kernels/mlp_cuda.py``) against the JAX
package's Pallas kernel ``scnerf_tpu/kernels/mlp_pallas.py:fused_query_field``,
run in interpret mode on the CPU.

On CPU tensors the port's wrapper takes its plain twin, so this holds the
twin's arithmetic to the TPU kernel's; the CUDA kernel is held to the twin on
the card (``tests/test_torch_kernels.py``, marked ``cuda``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog, interpret  # noqa: E402,F401
from scnerf_tpu.fields import nerf as jnerf  # noqa: E402
from scnerf_tpu.kernels import mlp_pallas  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.fields import nerf as tnerf  # noqa: E402
from scnerf_tpu_torch.kernels import mlp_cuda  # noqa: E402


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, vd / np.linalg.norm(vd, axis=-1, keepdims=True)


class TestFusedQueryFieldMatchesJax:
    # atol 2e-5: the same float32 encodings and products, summed in another
    # order over K <= 319 in each of the ten layers the output depends on.
    @pytest.mark.parametrize("n,s,multires,multires_views", [
        (4, 8, 10, 4),   # one full tile of 32 points
        (3, 5, 10, 4),   # 15 points: ragged against the tile
        (3, 5, 6, 2),    # another pair of encoding widths
    ])
    def test_matches_interpret_mode_kernel(self, n, s, multires, multires_views):
        jcfg = jnerf.NeRFConfig(multires=multires, multires_views=multires_views)
        tcfg = bridge.convert_config(jcfg, tnerf.NeRFConfig)
        params = jax.tree.map(np.asarray, jnerf.init_nerf_mlp(jax.random.key(n * s), jcfg))
        pts, vd = _inputs(n, s, seed=multires)
        want = interpret(lambda: mlp_pallas.fused_query_field(
            params, jcfg, jnp.asarray(pts), jnp.asarray(vd), tile=32))
        before = mlp_cuda.launches
        got = mlp_cuda.fused_query_field(bridge.tree_to_torch(params, device="cpu"), tcfg,
                                         torch.from_numpy(pts), torch.from_numpy(vd))
        assert mlp_cuda.launches == before
        assert got.shape == want.shape == (n, s, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


class TestSupportsConfig:
    @pytest.mark.parametrize("fields", [
        {}, dict(depth=4), dict(width=128), dict(skips=(3,)), dict(skips=(4, 6)),
        dict(use_viewdirs=False), dict(multires=6, multires_views=2),
    ])
    def test_agrees_with_jax(self, fields):
        jcfg = jnerf.NeRFConfig(**fields)
        tcfg = bridge.convert_config(jcfg, tnerf.NeRFConfig)
        assert mlp_cuda.supports_config(tcfg) == mlp_pallas.supports_config(jcfg)

    def test_bfloat16_config_does_not_reach_the_port(self):
        """JAX rejects compute_dtype="bfloat16"; the port has no such field
        and the bridge refuses the config."""
        jcfg = jnerf.NeRFConfig(compute_dtype="bfloat16")
        assert not mlp_pallas.supports_config(jcfg)
        with pytest.raises(ValueError, match="compute_dtype"):
            bridge.convert_config(jcfg, tnerf.NeRFConfig)

    def test_unsupported_config_raises_on_cpu(self):
        """JAX leaves the check to its caller; the port raises rather than
        run another architecture through the kernel's shapes."""
        cfg = tnerf.NeRFConfig(depth=4)
        params = tnerf.init_nerf_mlp(cfg, generator=torch.Generator().manual_seed(0),
                                     device="cpu")
        pts, vd = _inputs(2, 3, seed=0)
        with pytest.raises(ValueError, match="depth 8"):
            mlp_cuda.fused_query_field(params, cfg, torch.from_numpy(pts), torch.from_numpy(vd))
