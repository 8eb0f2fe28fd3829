"""The NeRF++ serve function's last cascade level through K3
(``serve.py:nerfpp_field_query``, ``kernels/mlp_cuda.py`` at point widths 3
and 4): the packed layout of a 4-D MLPNet, the operand checks, the route,
the counters and the agreement with the benchmark's frozen reference.

On the CPU every query takes ``query_mlpnet_fused``, ``query_mlpnet``'s
inference twin with the same bits, so the serve function's maps
are bit for bit ``render_rays_nerfpp``'s; the route as on the card runs here
with K3's CPU twin behind the wrapper. The tests marked ``cuda`` hold K3 to
``mlpnet_apply`` at Truck's published widths, a served Truck slice to the
plain route, count the packing and export the serve function; they skip
without a card. This file needs no JAX, so the card's machine runs it with
``python -m pytest --noconftest tests/test_torch_serve_k3_nerfpp.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_support import hang_watchdog  # noqa: F401
from scnerf_tpu_torch import serve
from scnerf_tpu_torch.fields.encoding import EncodingConfig, positional_encoding
from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp
from scnerf_tpu_torch.fields.nerfpp import (NerfPPConfig, init_nerfpp_net, mlpnet_apply,
                                            query_mlpnet, query_mlpnet_fused)
from scnerf_tpu_torch.kernels import mlp_cuda
from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig, render_rays_nerfpp
from scnerf_tpu_torch.train import profiling

OP = "scnerf_tpu_torch.fused_query_field.default"
# Truck's serving slice: 546x980 at focal 580, chunk_size 4,096, cascade 64,128.
H, W, FOCAL, BATCH = 546, 980, 580.0, 4096
TRUCK = NerfPPConfig()  # 8x256, skip (4,), 10/4 frequencies


def seeded_levels(cfg: NerfPPConfig, n_levels: int, device, seed: int = 0) -> list:
    """``n_levels`` fg/bg MLPNet pairs with every leaf drawn, biases
    included, so that no map is flat."""
    gen = torch.Generator().manual_seed(seed)
    levels = [init_nerfpp_net(cfg, generator=gen, device="cpu") for _ in range(n_levels)]
    with torch.no_grad():
        for level in levels:
            for net in level.values():
                for layer in [*net["base"], *(v for k, v in net.items() if k != "base")]:
                    layer["b"].copy_(torch.randn(layer["b"].shape, generator=gen) * 0.1)
    return [{name: {k: ([{"w": x["w"].to(device), "b": x["b"].to(device)} for x in v]
                        if k == "base" else {"w": v["w"].to(device), "b": v["b"].to(device)})
                    for k, v in net.items()}
             for name, net in level.items()} for level in levels]


def truck_rays(n: int, seed: int = 0, device="cpu"):
    """``n`` world rays of seeded pixels of a Truck-shaped pinhole camera
    inside the unit sphere (OpenCV, pixel centres, not normalised), and
    ``min_depth`` 1e-4."""
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, W, n) + 0.5, rng.integers(0, H, n) + 0.5
    dirs = np.stack([(u - W / 2) / FOCAL, (v - H / 2) / FOCAL, np.ones(n)], -1)
    angle = 0.2
    rot = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                    [-np.sin(angle), 0, np.cos(angle)]])
    rays_d = torch.from_numpy((dirs @ rot.T).astype(np.float32)).to(device)
    rays_o = torch.tensor([[0.1, -0.05, 0.2]], device=device).expand(n, 3).contiguous()
    return rays_o, rays_d, torch.full((n,), 1e-4, device=device)


def plain_maps(levels, cfg, render_cfg, ray_o, ray_d, min_depth):
    """The serve function's maps by hand: ``render_rays_nerfpp`` with its
    default fields (``query_mlpnet``)."""
    eval_cfg = dataclasses.replace(render_cfg, perturb=False)
    with serve.fp32_inference():
        last = render_rays_nerfpp(levels, cfg, eval_cfg, ray_o, ray_d, min_depth)[-1]
    return {k: last[k] for k in serve.NERFPP_OUTPUTS}


def kernel_cfg(cfg: NerfPPConfig) -> NeRFConfig:
    return NeRFConfig(depth=cfg.depth, width=cfg.width, skips=cfg.skips,
                      multires=cfg.max_freq_log2, multires_views=cfg.max_freq_log2_viewdirs)


@pytest.fixture
def no_k3(monkeypatch):
    """Any call of the K3 wrapper fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the K3 wrapper was called")

    monkeypatch.setattr(mlp_cuda, "fused_query_field", refuse)


def _unpack_layer(stream, k, n):
    """One layer's B tiles back to ``(big, small)``, each ``(k, n)``, as
    ``csrc/fused_mlp.cu``'s descriptors read them (``tests/
    test_torch_fused_mlp.py`` derives the order)."""
    tiles = stream.reshape(k // 8, 2, n // 8, 2, 8, 4)  # (kb, s, j, h, r, c)
    w = tiles.permute(1, 0, 3, 5, 2, 4).reshape(2, k, n)  # (s, kb, h, c, j, r)
    return w[0], w[1]


class TestPackedAtPointWidthFour:
    @pytest.mark.parametrize("multires,multires_views", [(10, 4), (6, 2), (0, 0), (16, 16)])
    def test_layout_lengths_and_offsets(self, multires, multires_views):
        """pe is ``4 (1 + 2F)`` wide, padded to 32: 84 -> 96 at 10/4."""
        pe = 4 * (1 + 2 * multires)
        pe_pad, ve_pad = -(-pe // 32) * 32, -(-(3 + 6 * multires_views) // 32) * 32
        table = mlp_cuda.layout(multires, multires_views, 4)
        wide = [pe_pad] + [256] * 4 + [pe_pad + 256] + [256] * 3  # trunk 0-7, feature
        assert table["layers"] == [2 * 256 * sum(wide[:i]) for i in range(len(wide))] + [
            2 * 256 * sum(wide)]
        assert table["bias"] == 2 * (256 * sum(wide) + 128 * (256 + ve_pad))
        assert table["alpha_w"] - table["bias"] == 8 * 256 + 256 + 128 + 1 + 3
        assert table["length"] == table["alpha_w"] + 256 + 128 * 3
        assert table["length"] >= mlp_cuda.layout(multires, multires_views)["length"]
        if (multires, multires_views) == (10, 4):
            assert (pe, pe_pad) == (84, 96)
        shapes = mlp_cuda._expected_shapes(multires, multires_views, 4)
        assert shapes[0] == (pe, 256) and shapes[5] == (256 + pe, 256)

    def test_mlpnet_packed_through_the_name_map(self):
        """A bg MLPNet's buffer: each tensor-core layer ``W^T`` split into
        TF32 halves with zero rows where pe pads (after layer 0's input and
        inside layer 5's ``[pe, 0, h]``), biases and the CUDA-core heads in
        float32, all read from the MLPNet's own leaves."""
        cfg = kernel_cfg(TRUCK)
        net = seeded_levels(TRUCK, 1, "cpu")[0]["bg"]
        buf, table = mlp_cuda.pack_weights(net, cfg, 4)
        assert buf.shape == (table["length"],) == (mlp_cuda.layout(10, 4, 4)["length"],)
        renamed = mlp_cuda.nerf_names(net)
        assert renamed["pts"] is net["base"] and renamed["alpha"] is net["sigma"]
        assert torch.equal(buf, mlp_cuda.pack_weights(renamed, cfg, 4)[0])
        pe, pe_pad = 84, 96
        base = [layer["w"] for layer in net["base"]]
        padded = [torch.cat([base[0], torch.zeros(pe_pad - pe, 256)])]
        padded += [torch.cat([w[:pe], torch.zeros(pe_pad - pe, 256), w[pe:]]) if i == 5 else w
                   for i, w in enumerate(base) if i > 0]
        padded += [net["remap"]["w"], torch.cat([net["rgb0"]["w"], torch.zeros(5, 128)])]
        at = 0
        for i, w in enumerate(padded):
            k, n = w.shape
            assert table["layers"][i] == at
            big, small = _unpack_layer(buf[at:at + 2 * k * n], k, n)
            want_big, want_small = mlp_cuda.split_tf32(w)
            assert torch.equal(big, want_big) and torch.equal(small, want_small)
            at += 2 * k * n
        assert not _unpack_layer(buf[:2 * pe_pad * 256], pe_pad, 256)[0][pe:].any()
        heads = ["remap", "rgb0", "sigma", "rgb1"]
        biases = [layer["b"] for layer in net["base"]] + [net[h]["b"] for h in heads]
        assert torch.equal(buf[at:table["alpha_w"]], torch.cat(biases))
        assert torch.equal(buf[table["alpha_w"]:table["rgb_w"]], net["sigma"]["w"].reshape(-1))
        assert torch.equal(buf[table["rgb_w"]:], net["rgb1"]["w"].reshape(-1))

    def test_packed_weights_of_an_mlpnet_repack_after_a_change(self):
        cfg = kernel_cfg(TRUCK)
        net = seeded_levels(TRUCK, 1, "cpu")[0]["bg"]
        packed = mlp_cuda.PackedWeights(net, cfg, 4)
        first = packed.get()
        assert packed.get() is first
        with torch.no_grad():
            net["sigma"]["b"].add_(0.5)
        second = packed.get()
        assert second is not first and torch.equal(second, mlp_cuda.pack_weights(net, cfg, 4)[0])
        net["rgb0"] = {k: v.clone() for k, v in net["rgb0"].items()}  # a layer replaced
        assert packed.get() is not second


class TestOperands:
    @pytest.mark.parametrize("dim", [3, 4])
    def test_points_three_or_four_wide_taken(self, dim):
        packed = torch.zeros(mlp_cuda.layout(10, 4, dim)["length"])
        mlp_cuda._check_operands(torch.zeros(2, 5, dim), torch.zeros(2, 3), 10, 4, packed)
        with pytest.raises(ValueError, match="packed"):  # the other width's buffer
            mlp_cuda._check_operands(torch.zeros(2, 5, 7 - dim), torch.zeros(2, 3), 10, 4,
                                     packed)

    @pytest.mark.parametrize("dim", [2, 5])
    def test_other_widths_refused(self, dim):
        packed = torch.zeros(mlp_cuda.layout(10, 4, 4)["length"])
        with pytest.raises(ValueError, match="pts"):
            mlp_cuda._check_operands(torch.zeros(2, 5, dim), torch.zeros(2, 3), 10, 4, packed)
        launches = mlp_cuda.launches
        with pytest.raises(ValueError, match="pts"):
            mlp_cuda._fused_query_field_cuda(torch.zeros(2, 5, dim), torch.zeros(2, 3), packed,
                                             10, 4)
        assert mlp_cuda.launches == launches

    def test_cpu_twin_is_mlpnet_apply_before_its_activations(self):
        """K3's CPU twin on a 4-D MLPNet: the raw heads, whose ``sigmoid`` and
        ``abs`` are ``query_mlpnet``'s outputs bit for bit."""
        cfg = kernel_cfg(TRUCK)
        net = seeded_levels(TRUCK, 1, "cpu")[0]["bg"]
        rng = np.random.default_rng(3)
        pts = torch.from_numpy(rng.uniform(-1, 1, (3, 5, 4)).astype(np.float32))
        vd = torch.nn.functional.normalize(torch.from_numpy(
            rng.normal(size=(3, 3)).astype(np.float32)), dim=-1)
        views_enc = positional_encoding(vd, TRUCK.view_encoding)
        raw = mlp_cuda.fused_query_field(net, cfg, pts, views_enc[:, :3].contiguous())
        rgb, sigma = query_mlpnet(net, TRUCK, pts, views_enc, 4)
        assert torch.equal(torch.sigmoid(raw[..., :3]), rgb)
        assert torch.equal(torch.abs(raw[..., 3]), sigma)


class TestCpuRoute:
    @pytest.mark.parametrize("cfg,cascade", [
        (NerfPPConfig(depth=3, width=32, skips=(1,), max_freq_log2=4, max_freq_log2_viewdirs=2),
         (4, 8)),
        (TRUCK, (4, 8)),
    ], ids=["small", "truck_width"])
    def test_maps_bit_for_bit_the_plain_renderer(self, cfg, cascade, no_k3):
        levels = seeded_levels(cfg, len(cascade), "cpu")
        render_cfg = NerfPPRenderConfig(cascade_samples=cascade, chunk=16)
        rays = truck_rays(16)
        got = serve.make_nerfpp_serve_fn(levels, cfg, render_cfg)(*rays)
        want = plain_maps(levels, cfg, render_cfg, *rays)
        assert set(got) == set(serve.NERFPP_OUTPUTS)
        for k, v in got.items():
            assert torch.equal(v, want[k]), k

    def test_last_level_through_k3_level_zero_through_query_mlpnet(self, monkeypatch):
        """The route as on the card, K3's CPU twin behind the wrapper: only
        the last level's fg (3-D) and bg (4-D) nets reach it, each with its
        buffer packed once; level 0 takes ``query_mlpnet``'s inference twin
        (``query_mlpnet_fused``); the counters give 75.0%, Truck's share
        ((12 + 12) / 32 at cascade (4, 8)), and the twin the other 25%."""
        from portbench.metrics import k3_point_share

        levels = seeded_levels(TRUCK, 2, "cpu")
        monkeypatch.setattr(mlp_cuda, "serves", lambda *args: True)
        seen, plain = [], []
        k3 = mlp_cuda.fused_query_field

        def recording(mlp, c, pts, viewdirs, *, packed):
            seen.append((mlp, tuple(pts.shape), packed))
            return k3(mlp, c, pts, viewdirs, packed=packed)

        def plain_query(mlp, *args):
            plain.append(mlp)
            return query_mlpnet_fused(mlp, *args)

        monkeypatch.setattr(mlp_cuda, "fused_query_field", recording)
        monkeypatch.setattr("scnerf_tpu_torch.fields.nerfpp.query_mlpnet_fused", plain_query)
        render_cfg = NerfPPRenderConfig(cascade_samples=(4, 8), chunk=8)
        rays = truck_rays(8)
        fn = serve.make_nerfpp_serve_fn(levels, TRUCK, render_cfg)
        profiling.RECORDER.clear()
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                got = fn(*rays)
                fn(*rays)
            counts = profiling.counters()
            share = k3_point_share.read({"window": {}, "trace": {"units": 2}}, "nerfpp_serve")
        finally:
            profiling.RECORDER.clear()
        last = levels[-1]
        assert [(m is last["fg"], m is last["bg"], shape) for m, shape, _ in seen] == [
            (True, False, (8, 12, 3)), (False, True, (8, 12, 4))] * 2
        assert [m is levels[0]["fg"] or m is levels[0]["bg"] for m in plain] == [True] * 4
        assert seen[0][2] is seen[2][2] and seen[1][2] is seen[3][2]
        assert seen[1][2].shape == (mlp_cuda.layout(10, 4, 4)["length"],)
        assert counts == {"serve.field_points": 2 * 8 * (4 + 4 + 12 + 12),
                          "serve.field_points_k3": 2 * 8 * (12 + 12),
                          "serve.field_points_fused": 2 * 8 * (4 + 4)}
        assert share == 75.0
        monkeypatch.undo()
        want = plain_maps(levels, TRUCK, render_cfg, *rays)
        for k, v in got.items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=1e-6)

    def test_counters_under_a_profiler_on_the_cpu(self):
        """Every queried point in ``serve.field_points``; none through K3."""
        cfg = NerfPPConfig(depth=3, width=32, skips=(1,), max_freq_log2=4,
                           max_freq_log2_viewdirs=2)
        levels = seeded_levels(cfg, 2, "cpu")
        service = serve.RenderService(serve.make_nerfpp_serve_fn(
            levels, cfg, NerfPPRenderConfig(cascade_samples=(4, 8))), 16, device="cpu")
        request = [x.numpy() for x in truck_rays(20)]
        profiling.RECORDER.clear()
        service(*request)  # not recorded
        assert profiling.counters() == {}
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                service(*request)
            counts = profiling.counters()
        finally:
            profiling.RECORDER.clear()
        assert counts["serve.field_points"] == 2 * 16 * (4 + 4 + 12 + 12)  # two slices
        assert counts.get("serve.field_points_k3", 0) == 0


class TestAgainstTheFrozenReference:
    def test_serve_fn_agrees_with_the_benchmarks_reference(self):
        """The port's serve function against ``portbench/reference/
        nerfpp_renderer.py`` (plain PyTorch, K2 replaced by the plain NeRF++
        inverse CDF) from the same leaves. Both run the same float32
        operations but the resample, where K2's CPU twin and the reference's
        inverse CDF can round a sample's depth differently by an ulp or so;
        such a move changes the last level's rgb by far less than 1e-5 at
        these widths, while a wrong field, encoding or compositing moves it
        by 1e-2 or more."""
        from portbench.reference import nerfpp as rnerfpp
        from portbench.reference import nerfpp_renderer as rrender

        cfg = NerfPPConfig(depth=4, width=32, skips=(2,), max_freq_log2=4,
                           max_freq_log2_viewdirs=2)
        levels = seeded_levels(cfg, 2, "cpu", seed=5)
        ref_cfg = rnerfpp.NerfPPConfig(depth=4, width=32, skips=(2,), max_freq_log2=4,
                                       max_freq_log2_viewdirs=2)
        render_cfg = NerfPPRenderConfig(cascade_samples=(8, 16), chunk=64)
        rays = truck_rays(64, seed=4)
        got = serve.make_nerfpp_serve_fn(levels, cfg, render_cfg)(*rays)
        with torch.inference_mode():
            want = rrender.render_rays_nerfpp(
                levels, ref_cfg, rrender.NerfPPRenderConfig(cascade_samples=(8, 16),
                                                            perturb=False), *rays)[-1]
        assert float((got["rgb"] - want["rgb"]).abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def truck_slice(device, seed=0):
    """Truck's serving slice: fg/bg 8x256 at 10/4, cascade 64,128, 4,096
    rays."""
    levels = seeded_levels(TRUCK, 2, device, seed)
    render_cfg = NerfPPRenderConfig(cascade_samples=(64, 128), chunk=BATCH)
    return levels, render_cfg, truck_rays(BATCH, seed, device)


@pytest.mark.cuda
class TestServeOnCard:
    @pytest.mark.parametrize("name,dim", [("fg", 3), ("bg", 4)])
    def test_k3_against_mlpnet_apply(self, cuda, name, dim):
        """At (4096, 192) points, fg inside the unit sphere and bg
        ``(x/r, y/r, z/r, 1/r)``: K3's limits on fern (median |err| under
        1e-5, max under 2e-4), which one TF32 pass (about 5e-4 a product)
        would fail."""
        net = seeded_levels(TRUCK, 1, cuda)[0][name]
        gen = torch.Generator(device=cuda).manual_seed(7)
        n, s = BATCH, 192
        x = torch.nn.functional.normalize(torch.randn(n, s, 3, device=cuda, generator=gen), dim=-1)
        r = torch.rand(n, s, 1, device=cuda, generator=gen)
        pts = (x * r if dim == 3 else torch.cat([x, r], -1)).contiguous()
        vd = torch.nn.functional.normalize(torch.randn(n, 3, device=cuda, generator=gen), dim=-1)
        with serve.fp32_inference():
            raw = mlp_cuda.fused_query_field(net, kernel_cfg(TRUCK), pts, vd)
            pe = positional_encoding(pts, EncodingConfig(input_dim=dim, n_freqs=10))
            ve = positional_encoding(vd, TRUCK.view_encoding)[:, None].expand(n, s, 27)
            rgb, sigma = mlpnet_apply(net, TRUCK, pe, ve)
        torch.cuda.synchronize()
        for got, want in ((torch.sigmoid(raw[..., :3]), rgb), (torch.abs(raw[..., 3]), sigma)):
            err = (got - want).abs()
            assert float(err.median()) < 1e-5 and float(err.max()) < 2e-4, (
                float(err.median()), float(err.max()))

    def test_served_slice_against_the_plain_route(self, cuda, monkeypatch):
        """Two K3 launches a slice (the last level's fg and bg); level 0 is
        the plain route's, so every sample lies where it does there, and the
        rgb moves only by K3's float32-accuracy field (median under 1e-5;
        the largest within the benchmark's 4e-3, where a sigma within
        rounding of 0 meets the 1e10 last bg interval)."""
        levels, render_cfg, rays = truck_slice(cuda)
        before = mlp_cuda.launches
        got = serve.make_nerfpp_serve_fn(levels, TRUCK, render_cfg)(*rays)
        torch.cuda.synchronize()
        assert mlp_cuda.launches == before + 2
        monkeypatch.setattr(mlp_cuda, "supports_config", lambda c: False)
        want = serve.make_nerfpp_serve_fn(levels, TRUCK, render_cfg)(*rays)
        torch.cuda.synchronize()
        assert mlp_cuda.launches == before + 2
        for k in serve.NERFPP_OUTPUTS:
            err = (got[k] - want[k]).abs()
            assert float(err.median()) < 1e-5, (k, float(err.median()))
            assert float(err.max()) < 4e-3, (k, float(err.max()))

    def test_packs_each_net_of_the_last_level_once(self, cuda, monkeypatch):
        levels, render_cfg, rays = truck_slice(cuda)
        calls = []
        pack = mlp_cuda.pack_weights
        monkeypatch.setattr(mlp_cuda, "pack_weights",
                            lambda p, c, *dim: calls.append((p, *dim)) or pack(p, c, *dim))
        fn = serve.make_nerfpp_serve_fn(levels, TRUCK, render_cfg)
        assert [(p is levels[1][k], d) for (p, d), k in zip(calls, ("fg", "bg"))] == [
            (True, 3), (True, 4)]
        for _ in range(3):
            fn(*rays)
        assert len(calls) == 2

    def test_export_keeps_the_operator(self, cuda):
        levels, render_cfg, _ = truck_slice(cuda)
        fn = serve.make_nerfpp_serve_fn(levels, TRUCK, render_cfg)
        data = serve.export_serving_fn(fn, serve.nerfpp_serve_specs(BATCH), device=cuda)
        loaded = serve.load_serving_fn(data)
        assert OP in loaded.operators
        assert "scnerf_tpu_torch.sample_pdf_fwd.default" in loaded.operators
        assert "scnerf_tpu_torch.dense_into.default" in loaded.operators  # level 0
        request = [x.cpu().numpy() for x in truck_rays(2 * BATCH - 100, seed=2)]
        want = serve.RenderService(fn, BATCH, device=cuda)(*request)
        before = mlp_cuda.launches
        got = serve.RenderService(loaded, BATCH, device=cuda)(*request)
        assert mlp_cuda.launches == before + 4  # fg and bg of two slices
        for k, v in want.items():
            err = np.abs(got[k].astype(np.float64) - v) / np.maximum(np.abs(v), 1.0)
            assert np.median(err) < 1e-6 and err.max() < 1e-4, (k, np.median(err), err.max())
