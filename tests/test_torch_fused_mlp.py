"""K3's port (``scnerf_tpu_torch/kernels/mlp_cuda.py``) against the JAX
package's Pallas kernel ``scnerf_tpu/kernels/mlp_pallas.py:fused_query_field``,
run in interpret mode on the CPU.

On CPU tensors the port's wrapper takes its plain twin, so this holds the
twin's arithmetic to the TPU kernel's; the CUDA kernel is held to the twin on
the card (``tests/test_torch_kernels.py``, marked ``cuda``). The kernel's
own arithmetic is held here through what the CPU can run of it: the TF32
split (``split_tf32``), the packed weights the kernel reads
(``pack_weights``), and ``query_field`` done in 3xTF32 as the kernel does it,
against the JAX kernel.
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
from scnerf_tpu_torch.fields import encoding as tenc  # noqa: E402
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


def _rna_tf32_reference(x):
    """float32 ``x`` rounded to TF32 (11 significant bits, ties away from
    zero) in float64 arithmetic, independent of the bit trick under test;
    TF32 keeps float32's exponent range, so below 2^-126 the step is
    2^-136."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)
    scale = np.exp2(11 - np.maximum(e, -125).astype(np.float64))
    return (np.sign(x64) * np.floor(np.abs(x64) * scale + 0.5) / scale).astype(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


class TestSplitTf32:
    """``mlp_cuda.split_tf32``: the weights' split, as the kernel's
    ``cvt.rna.tf32.f32`` splits the activations."""

    @staticmethod
    def _data(seed=0, n=4096):
        rng = np.random.default_rng(seed)
        mag = np.exp2(rng.uniform(-40, 40, n))
        return (rng.choice([-1.0, 1.0], n) * mag * rng.uniform(1, 2, n)).astype(np.float32)

    def test_big_has_low_13_bits_zero(self):
        x = self._data()
        big, small = mlp_cuda.split_tf32(torch.from_numpy(x))
        assert not (_bits(big.numpy()) & 0x1FFF).any()
        assert not (_bits(small.numpy()) & 0x1FFF).any()

    def test_big_plus_small_within_2_to_the_minus_22(self):
        x = self._data(seed=1)
        big, small = (t.numpy().astype(np.float64) for t in mlp_cuda.split_tf32(torch.from_numpy(x)))
        assert np.all(np.abs(big + small - x) <= np.exp2(-22) * np.abs(x))
        assert np.all(np.abs(x - big) <= np.exp2(-11) * np.abs(x))

    def test_matches_round_to_nearest_ties_away(self):
        x = np.concatenate([self._data(seed=2), self._data(seed=3) * np.float32(2.0**-100)])
        big, small = mlp_cuda.split_tf32(torch.from_numpy(x))
        np.testing.assert_array_equal(_bits(big.numpy()), _bits(_rna_tf32_reference(x)))
        rest = x - big.numpy()
        np.testing.assert_array_equal(_bits(small.numpy()), _bits(_rna_tf32_reference(rest)))

    @pytest.mark.parametrize("bits,want", [
        (0x3F800FFF, 0x3F800000),  # below half a TF32 ulp: down
        (0x3F801000, 0x3F802000),  # a tie on an even TF32 value: away, not to even
        (0xBF801000, 0xBF802000),  # the same below zero: away from zero
        (0x3F803000, 0x3F804000),  # a tie on an odd value
        (0x3F801001, 0x3F802000),  # above half: up
        (0x3FFFF000, 0x40000000),  # the carry reaches the exponent: 2.0
        (0x7F7FEFFF, 0x7F7FE000),  # the largest finite TF32 value stays
    ])
    def test_hand_picked_bit_patterns(self, bits, want):
        x = torch.from_numpy(np.array([bits], np.uint32).view(np.float32))
        big, small = mlp_cuda.split_tf32(x)
        assert _bits(big.numpy())[0] == want
        assert abs(float(big.double() + small.double()) - float(x)) <= 2.0**-22 * abs(float(x))

    def test_zeros_subnormals_and_infinities(self):
        x = np.array([0x00000000, 0x80000000, 0x00000001, 0x00001000, 0x80001000, 0x00003000,
                      0x007FFFFF, 0x7F800000, 0xFF800000], np.uint32).view(np.float32)
        big, small = mlp_cuda.split_tf32(torch.from_numpy(x))
        big, small = big.numpy(), small.numpy()
        np.testing.assert_array_equal(
            _bits(big), [0x00000000, 0x80000000, 0x00000000, 0x00002000, 0x80002000, 0x00004000,
                         0x00800000, 0x7F800000, 0xFF800000])
        np.testing.assert_array_equal(_bits(small[-2:]), [0, 0])  # no inf - inf
        # Finite entries: within half of TF32's step below 2^-126 (2^-136);
        # small is the rounded remainder.
        err = big[:-2].astype(np.float64) + small[:-2] - x[:-2]
        assert np.all(np.abs(err) <= 2.0**-137)
        np.testing.assert_array_equal(_bits(small[:-2]), _bits(_rna_tf32_reference(x[:-2] - big[:-2])))
        nan = mlp_cuda.split_tf32(torch.tensor([float("nan")]))
        assert torch.isnan(nan[0]).all() and (nan[1] == 0).all()


def _unpack_layer(stream, k, n):
    """One layer's B tiles back to ``(big, small)``, each ``(k, n)``: the
    element ``W[8kb + 4h + c, 8j + r]`` lies, as ``csrc/fused_mlp.cu``'s
    descriptors read it, at float ``kb * 16n + s * 8n + ((2j + h) * 8 + r) *
    4 + c`` (s = 0 big, 1 small: core matrices of 8 outputs x 4 K, the two
    of a k8 step 128 bytes apart, the next 8 outputs 256 bytes on)."""
    tiles = stream.reshape(k // 8, 2, n // 8, 2, 8, 4)  # (kb, s, j, h, r, c)
    w = tiles.permute(1, 0, 3, 5, 2, 4).reshape(2, k, n)  # (s, kb, h, c, j, r)
    return w[0], w[1]


class TestPackWeights:
    """The kernel's one weight buffer: offsets, zero padding of K to a
    multiple of 32, ``W^T`` in wgmma's K-major tiles, biases and the
    CUDA-core heads, against the params."""

    @pytest.mark.parametrize("multires,multires_views", [(10, 4), (6, 2), (0, 0), (16, 16)])
    def test_layout_against_the_params(self, multires, multires_views):
        cfg = tnerf.NeRFConfig(multires=multires, multires_views=multires_views)
        params = tnerf.init_nerf_mlp(cfg, generator=torch.Generator().manual_seed(3),
                                     device="cpu")
        buf, table = mlp_cuda.pack_weights(params, cfg)
        assert buf.dtype == torch.float32 and buf.is_contiguous()
        pe, ve = 3 + 6 * multires, 3 + 6 * multires_views
        pe_pad, ve_pad = -(-pe // 32) * 32, -(-ve // 32) * 32
        # (K rows as the kernel lays out its activations, N)
        trunk = [params["pts"][0]["w"]] + [p["w"] for p in params["pts"][1:]]
        padded = [torch.cat([trunk[0], torch.zeros(pe_pad - pe, 256)])]
        for i in range(1, 8):
            w = trunk[i]
            padded.append(torch.cat([w[:pe], torch.zeros(pe_pad - pe, 256), w[pe:]])
                          if i == 5 else w)
        padded.append(params["feature"]["w"])
        padded.append(torch.cat([params["views"]["w"], torch.zeros(ve_pad - ve, 128)]))
        at = 0
        for i, w in enumerate(padded):
            k, n = w.shape
            assert k % 32 == 0 and table["layers"][i] == at
            big, small = _unpack_layer(buf[at:at + 2 * k * n], k, n)
            want_big, want_small = mlp_cuda.split_tf32(w)
            torch.testing.assert_close(big, want_big, rtol=0, atol=0)
            torch.testing.assert_close(small, want_small, rtol=0, atol=0)
            assert not big[(w == 0).all(-1)].any()  # the padding rows are zero
            at += 2 * k * n
        # csrc/fused_mlp.cu:make_layout: N = 256 over the trunk and feature
        # layers' K, then N = 128 over views', big and small.
        assert at == 2 * ((2 * pe_pad + 2048) * 256 + (256 + ve_pad) * 128)
        assert table["bias"] == at
        names = [("pts", i) for i in range(8)] + ["feature", "views", "alpha", "rgb"]
        biases = [params[k[0]][k[1]]["b"] if isinstance(k, tuple) else params[k]["b"]
                  for k in names]
        torch.testing.assert_close(buf[at:table["alpha_w"]], torch.cat(biases), rtol=0, atol=0)
        assert table["alpha_w"] - at == 8 * 256 + 256 + 128 + 1 + 3
        torch.testing.assert_close(buf[table["alpha_w"]:table["rgb_w"]],
                                   params["alpha"]["w"].reshape(-1), rtol=0, atol=0)
        torch.testing.assert_close(buf[table["rgb_w"]:], params["rgb"]["w"].reshape(-1),
                                   rtol=0, atol=0)


def _dense_3xtf32(x, layer):
    """``x W + b`` as the kernel's tensor-core layers compute it: both
    operands split by ``split_tf32``, the small products first."""
    xb, xs = mlp_cuda.split_tf32(x)
    wb, ws = mlp_cuda.split_tf32(layer["w"])
    return ((xs @ wb + xb @ ws) + xb @ wb) + layer["b"]


def _query_field_3xtf32(params, cfg, pts, viewdirs):
    """``query_field`` with the trunk, feature and views layers in 3xTF32
    and alpha and rgb in float32, as ``csrc/fused_mlp.cu`` splits them."""
    pe = tenc.positional_encoding(pts, cfg.pos_encoding)
    ve = tenc.positional_encoding(viewdirs[:, None, :].expand(pts.shape), cfg.view_encoding)
    h = pe
    for i, layer in enumerate(params["pts"]):
        h = torch.relu(_dense_3xtf32(h, layer))
        if i in cfg.skips:
            h = torch.cat([pe, h], -1)
    alpha = h @ params["alpha"]["w"] + params["alpha"]["b"]
    feat = _dense_3xtf32(h, params["feature"])
    hv = torch.relu(_dense_3xtf32(torch.cat([feat, ve], -1), params["views"]))
    return torch.cat([hv @ params["rgb"]["w"] + params["rgb"]["b"], alpha], -1)


class TestThreeTf32MatchesJax:
    # The port's K3 limits (tests/test_kernels.py:195): median |err| < 1e-5,
    # max < 2e-4. 3xTF32 leaves out the small x small products and the
    # rounding of the small halves, about 2^-22 of each product: float32's
    # order of error, far inside both limits. One TF32 pass (2^-11 a
    # product) would not be.
    @pytest.mark.parametrize("n,s,multires,multires_views", [
        (4, 8, 10, 4), (3, 5, 10, 4), (3, 5, 6, 2),
    ])
    def test_matches_interpret_mode_kernel(self, n, s, multires, multires_views):
        jcfg = jnerf.NeRFConfig(multires=multires, multires_views=multires_views)
        tcfg = bridge.convert_config(jcfg, tnerf.NeRFConfig)
        params = jax.tree.map(np.asarray, jnerf.init_nerf_mlp(jax.random.key(n * s), jcfg))
        pts, vd = _inputs(n, s, seed=multires)
        want = interpret(lambda: mlp_pallas.fused_query_field(
            params, jcfg, jnp.asarray(pts), jnp.asarray(vd), tile=32))
        got = _query_field_3xtf32(bridge.tree_to_torch(params, device="cpu"), tcfg,
                                  torch.from_numpy(pts), torch.from_numpy(vd))
        err = np.abs(got.numpy() - np.asarray(want))
        assert got.shape == (n, s, 4)
        assert np.median(err) < 1e-5 and err.max() < 2e-4
