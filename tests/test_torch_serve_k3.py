"""The NeRF serve function's fine field through K3
(``serve.py:nerf_field_query``, ``kernels/mlp_cuda.py``): the route, the
packed weights kept per model, the registered operator and the counters.

On the CPU the route is ``query_field_fused``, ``query_field``'s inference
twin with the same bits, so the serve function's maps are
bit for bit ``render_rays``' with its default field; the operator's schema
and fake, the ``packed=`` checks and :class:`mlp_cuda.PackedWeights` run
here too. The tests marked ``cuda`` hold the K3 route to the plain one on a
fern-shaped slice, export it, and change a weight after the build; they
skip without a card. This file needs no JAX, so the card's machine runs it
with ``python -m pytest --noconftest tests/test_torch_serve_k3.py``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_support import hang_watchdog  # noqa: F401
from scnerf_tpu_torch import serve
from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp, query_field
from scnerf_tpu_torch.geometry.ndc import ndc_rays
from scnerf_tpu_torch.kernels import mlp_cuda
from scnerf_tpu_torch.render.renderer import RenderConfig, render_rays
from scnerf_tpu_torch.train import profiling

REPO = Path(__file__).resolve().parents[1]
OP = "scnerf_tpu_torch.fused_query_field.default"
# fern at factor 8 (chip_smoke.py's slice): 378x504, the chunk of 8,192 rays.
H, W, FOCAL, BATCH = 378, 504, 407.5, 8192


def seeded_params(cfg: NeRFConfig, device, seed: int = 0) -> dict:
    """Coarse and fine MLPs with every leaf drawn, biases included, so that
    no map is flat."""
    gen = torch.Generator().manual_seed(seed)
    params = {"coarse": init_nerf_mlp(cfg, device="cpu"), "fine": init_nerf_mlp(cfg, device="cpu")}
    with torch.no_grad():
        for mlp in params.values():
            for layer in [*mlp["pts"], *(v for k, v in mlp.items() if k != "pts")]:
                layer["w"].copy_(torch.randn(layer["w"].shape, generator=gen)
                                 * (2.0 / layer["w"].shape[0]) ** 0.5)
                layer["b"].copy_(torch.randn(layer["b"].shape, generator=gen) * 0.1)
    return {k: {n: ([{"w": x["w"].to(device), "b": x["b"].to(device)} for x in v]
                    if n == "pts" else {"w": v["w"].to(device), "b": v["b"].to(device)})
                for n, v in mlp.items()}
            for k, mlp in params.items()}


def fern_rays(n: int, seed: int = 0):
    """``n`` world rays of a fern-shaped camera near the identity pose, with
    near 0 and far 1 (the NDC slice's), as numpy."""
    rng = np.random.default_rng(seed)
    i, j = rng.integers(0, W, n), rng.integers(0, H, n)
    dirs = np.stack([(i - W * 0.5) / FOCAL, -(j - H * 0.5) / FOCAL, -np.ones(n)], -1)
    angle = 0.1
    rot = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]])
    rays_d = (dirs @ rot.T).astype(np.float32)
    rays_o = np.broadcast_to(np.array([0.1, -0.05, 0.2], np.float32), rays_d.shape).copy()
    return rays_o, rays_d, np.zeros(n, np.float32), np.ones(n, np.float32)


def plain_maps(params, model_cfg, render_cfg, rays_o, rays_d, near, far, ndc):
    """The serve function's maps by hand: ``render_rays`` with its default
    field (``query_field``)."""
    eval_cfg = render_cfg.eval_mode()
    with serve.fp32_inference():
        viewdirs = rays_d / (torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True) + 1e-10)
        if ndc is not None:
            rays_o, rays_d = ndc_rays(*ndc, 1.0, rays_o, rays_d)
            near, far = torch.zeros_like(near), torch.ones_like(far)
        out = render_rays(params, model_cfg, eval_cfg, rays_o, rays_d, viewdirs, near, far)
        out["rgb"] = torch.clamp(out["rgb"], max=1.0)
    return out


@pytest.fixture
def no_k3(monkeypatch):
    """Any call of the K3 wrapper fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the K3 wrapper was called")

    monkeypatch.setattr(mlp_cuda, "fused_query_field", refuse)


class TestCpuRoute:
    @pytest.mark.parametrize("ndc", [None, (H, W, FOCAL, FOCAL)])
    @pytest.mark.parametrize("cfg", [NeRFConfig(), NeRFConfig(depth=3, width=32, skips=(1,),
                                                               multires=4, multires_views=2)],
                             ids=["k3_config", "small"])
    def test_maps_bit_for_bit_query_fields(self, cfg, ndc, no_k3):
        """K3's own config too: on the CPU the route is ``query_field``."""
        params = seeded_params(cfg, "cpu")
        render_cfg = RenderConfig(n_samples=8, n_importance=8)
        rays = [torch.from_numpy(x) for x in fern_rays(24)]
        fn = serve.make_nerf_serve_fn(params, cfg, render_cfg, ndc=ndc)
        got = fn(*rays)
        want = plain_maps(params, cfg, render_cfg, *rays, ndc)
        assert set(got) == {"rgb", "depth", "acc", "disp"}
        for k, v in got.items():
            assert torch.equal(v, want[k]), k

    @pytest.mark.parametrize("cfg,device,dtype,want", [
        (NeRFConfig(), "cuda", torch.float32, True),
        (NeRFConfig(multires=mlp_cuda.MAX_FREQS, multires_views=0), "cuda", torch.float32, True),
        (NeRFConfig(depth=4), "cuda", torch.float32, False),
        (NeRFConfig(use_viewdirs=False), "cuda", torch.float32, False),
        (NeRFConfig(width=128), "cuda", torch.float32, False),
        (NeRFConfig(multires=mlp_cuda.MAX_FREQS + 1), "cuda", torch.float32, False),
        (NeRFConfig(), "cuda", torch.float64, False),
        (NeRFConfig(), "cpu", torch.float32, False),
        (NeRFConfig(), "meta", torch.float32, False),
    ])
    def test_route_by_device_dtype_and_config(self, cfg, device, dtype, want):
        """What the serve function observes decides the route: a config K3
        does not compute takes ``query_field`` on the card too."""
        assert mlp_cuda.serves(cfg, torch.device(device), dtype) is want

    @pytest.mark.parametrize("fields", [dict(depth=4, skips=(2,)), dict(use_viewdirs=False)])
    def test_unsupported_config_serves_through_query_field(self, fields, no_k3):
        cfg = NeRFConfig(width=32, **fields)
        params = seeded_params(cfg, "cpu")
        rays = [torch.from_numpy(x) for x in fern_rays(16)]
        render_cfg = RenderConfig(n_samples=4, n_importance=4, use_viewdirs=cfg.use_viewdirs)
        got = serve.make_nerf_serve_fn(params, cfg, render_cfg)(*rays)
        want = plain_maps(params, cfg, render_cfg, *rays, None)
        assert torch.equal(got["rgb"], want["rgb"])

    def test_fine_field_through_k3_coarse_through_query_field(self, monkeypatch):
        """The route as on the card, with K3's CPU twin behind it: only the
        fine MLP reaches the wrapper, with its buffer packed once."""
        cfg = NeRFConfig()
        params = seeded_params(cfg, "cpu")
        monkeypatch.setattr(mlp_cuda, "serves", lambda *args: True)
        seen = []
        k3 = mlp_cuda.fused_query_field

        def recording(mlp, c, pts, viewdirs, *, packed):
            seen.append((mlp, tuple(pts.shape), packed))
            return k3(mlp, c, pts, viewdirs, packed=packed)

        monkeypatch.setattr(mlp_cuda, "fused_query_field", recording)
        render_cfg = RenderConfig(n_samples=8, n_importance=8)
        rays = [torch.from_numpy(x) for x in fern_rays(24)]
        fn = serve.make_nerf_serve_fn(params, cfg, render_cfg)
        profiling.RECORDER.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = fn(*rays)
            fn(*rays)
        counts = profiling.counters()
        profiling.RECORDER.clear()
        assert [(m is params["fine"], shape) for m, shape, _ in seen] == [(True, (24, 16, 3))] * 2
        length = mlp_cuda.layout(cfg.multires, cfg.multires_views)["length"]
        assert seen[0][2] is seen[1][2] and seen[0][2].shape == (length,)
        assert counts == {"serve.field_points": 2 * 24 * (8 + 16),
                          "serve.field_points_k3": 2 * 24 * 16,
                          "serve.field_points_fused": 2 * 24 * 8}
        want = plain_maps(params, cfg, render_cfg, *rays, None)
        assert torch.equal(got["rgb"], want["rgb"])

    def test_counters_under_a_profiler(self):
        """Every queried point in ``serve.field_points``; none through K3."""
        cfg = NeRFConfig(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
        params = seeded_params(cfg, "cpu")
        service = serve.RenderService(
            serve.make_nerf_serve_fn(params, cfg, RenderConfig(n_samples=8, n_importance=16)),
            32, device="cpu")
        profiling.RECORDER.clear()
        service(*fern_rays(40))  # not recorded
        assert profiling.counters() == {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            service(*fern_rays(40))
        counts = profiling.counters()
        profiling.RECORDER.clear()
        assert counts["serve.field_points"] == 2 * 32 * (8 + 8 + 16)  # two slices, padding in
        assert counts.get("serve.field_points_k3", 0) == 0


class TestOperator:
    def test_schema(self):
        schema = str(torch.ops.scnerf_tpu_torch.fused_query_field.default._schema)
        assert schema == ("scnerf_tpu_torch::fused_query_field(Tensor pts, Tensor viewdirs, "
                          "Tensor packed, int multires, int multires_views) -> Tensor")

    @pytest.mark.parametrize("n,s", [(5, 7), (8192, 128), (0, 3)])
    def test_fake_gives_raw_shape(self, n, s):
        cfg = NeRFConfig()
        length = mlp_cuda.layout(cfg.multires, cfg.multires_views)["length"]
        with FakeTensorMode():
            out = torch.ops.scnerf_tpu_torch.fused_query_field(
                torch.empty(n, s, 3), torch.empty(n, 3), torch.empty(length),
                cfg.multires, cfg.multires_views)
        assert out.shape == (n, s, 4) and out.dtype == torch.float32

    @pytest.mark.parametrize("fault,error,match", [
        ("short buffer", ValueError, "packed"),
        ("points (N, S, 2)", ValueError, "pts"),
        ("view directions (N + 1, 3)", ValueError, "viewdirs"),
        ("multires 17", ValueError, "multires"),
        ("float64 buffer", TypeError, "float32"),
        ("buffer on another device", ValueError, "different devices"),
        ("strided points", ValueError, "contiguous"),
    ])
    def test_cuda_implementation_checks_its_operands(self, fault, error, match):
        """What an exported artifact hands the operator reaches no pointer
        unchecked: the CUDA implementation raises before it launches (here
        on CPU tensors, which fail a check before the launch would)."""
        cfg = NeRFConfig()
        n, s = 4, 6
        pts, vd = torch.zeros(n, s, 3), torch.zeros(n, 3)
        packed = torch.zeros(mlp_cuda.layout(cfg.multires, cfg.multires_views)["length"])
        multires = cfg.multires
        if fault == "short buffer":
            packed = packed[:-1]
        elif fault == "points (N, S, 2)":
            pts = pts[..., :2]
        elif fault == "view directions (N + 1, 3)":
            vd = torch.zeros(n + 1, 3)
        elif fault == "multires 17":
            multires = 17
        elif fault == "float64 buffer":
            packed = packed.double()
        elif fault == "buffer on another device":
            packed = packed.to("meta")
        else:
            pts = torch.zeros(n, 2 * s, 3)[:, ::2]
        launches = mlp_cuda.launches
        with pytest.raises(error, match=match):
            mlp_cuda._fused_query_field_cuda(pts, vd, packed, multires, cfg.multires_views)
        assert mlp_cuda.launches == launches

    @pytest.mark.parametrize("multires,multires_views", [(10, 4), (6, 2), (0, 0), (16, 16)])
    def test_packed_length_is_the_buffers(self, multires, multires_views):
        cfg = NeRFConfig(multires=multires, multires_views=multires_views)
        packed, table = mlp_cuda.pack_weights(init_nerf_mlp(cfg, device="cpu"), cfg)
        assert packed.shape == (table["length"],)
        assert table["rgb_w"] + 3 * (cfg.width // 2) == packed.numel()

    def test_loading_imports_no_model_code(self):
        """A loaded artifact needs K3's schema: ``mlp_cuda`` imports none of
        ``fields`` or ``render``, which phase 23's fresh loader forbids."""
        code = ("import sys\n"
                "from scnerf_tpu_torch import serve\n"
                "from scnerf_tpu_torch.kernels import mlp_cuda\n"
                "assert hasattr(__import__('torch').ops.scnerf_tpu_torch, 'fused_query_field')\n"
                "bad = sorted(m for m in sys.modules if m.startswith(("
                "'scnerf_tpu_torch.render', 'scnerf_tpu_torch.fields')))\n"
                "assert not bad, bad\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr


class TestPacked:
    def _inputs(self, n=3, s=5):
        cfg = NeRFConfig()
        params = seeded_params(cfg, "cpu")["fine"]
        rng = np.random.default_rng(1)
        pts = torch.from_numpy(rng.normal(size=(n, s, 3)).astype(np.float32))
        vd = torch.nn.functional.normalize(torch.from_numpy(
            rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
        return cfg, params, pts, vd

    @pytest.mark.parametrize("delta", [-1, 1, -4096])
    def test_wrong_length_refused(self, delta):
        cfg, params, pts, vd = self._inputs()
        packed = torch.zeros(mlp_cuda.layout(cfg.multires, cfg.multires_views)["length"] + delta)
        with pytest.raises(ValueError, match="packed"):
            mlp_cuda.fused_query_field(params, cfg, pts, vd, packed=packed)
        with pytest.raises(ValueError, match="packed"):
            mlp_cuda.fused_query_field(params, cfg, pts, vd, packed=packed[:, None])

    def test_right_length_takes_the_twin_on_cpu(self):
        cfg, params, pts, vd = self._inputs()
        packed = mlp_cuda.PackedWeights(params, cfg).get()
        got = mlp_cuda.fused_query_field(params, cfg, pts, vd, packed=packed)
        assert torch.equal(got, query_field(params, cfg, pts, vd))
        with pytest.raises(TypeError):
            mlp_cuda.fused_query_field(params, cfg, pts, vd, packed=packed.double())
        with pytest.raises(ValueError, match="different devices"):
            mlp_cuda.fused_query_field(params, cfg, pts, vd, packed=packed.to("meta"))

    def test_packs_again_only_after_a_change(self, monkeypatch):
        cfg, params, _, _ = self._inputs()
        calls = []
        pack = mlp_cuda.pack_weights

        def counted(p, c, *point_dim):
            calls.append(1)
            return pack(p, c, *point_dim)

        monkeypatch.setattr(mlp_cuda, "pack_weights", counted)
        packed = mlp_cuda.PackedWeights(params, cfg)
        first = packed.get()
        assert packed.get() is first and packed.get() is first
        assert len(calls) == 1
        with torch.no_grad():
            params["pts"][3]["b"].add_(0.5)  # one leaf, in place
        second = packed.get()
        assert len(calls) == 2 and second is not first
        assert torch.equal(second, pack(params, cfg)[0]) and not torch.equal(second, first)
        assert packed.get() is second and len(calls) == 2
        params["views"]["w"] = params["views"]["w"].clone()  # a leaf replaced
        packed.get()
        assert len(calls) == 3
        with torch.inference_mode():  # an inference leaf keeps no version
            params["rgb"]["b"] = params["rgb"]["b"] + 0.0
        packed.get(), packed.get()
        assert len(calls) == 5

    def test_packs_without_autograd(self):
        cfg, params, _, _ = self._inputs()
        params["pts"][0]["w"].requires_grad_()
        assert not mlp_cuda.PackedWeights(params, cfg).get().requires_grad


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def fern_slice(device, seed=0):
    """The fern serving slice: 8x256 with multires 10/4, 64+64 samples, NDC,
    8,192 rays."""
    cfg = NeRFConfig()
    params = seeded_params(cfg, device, seed)
    rays = [torch.from_numpy(x).to(device) for x in fern_rays(BATCH, seed)]
    return cfg, params, RenderConfig(n_samples=64, n_importance=64), rays


def assert_rgb_close(got, want):
    """K3 against the plain route: float32 accuracy in the fields, and at
    most the benchmark's ``rgb_max_err`` limit once a field's change moves
    a fine sample."""
    err = (got - want).abs()
    assert float(err.median()) < 1e-5, float(err.median())
    assert float(err.max()) < 4e-3, float(err.max())


@pytest.mark.cuda
class TestServeOnCard:
    def test_k3_against_the_plain_route(self, cuda, monkeypatch):
        cfg, params, render_cfg, rays = fern_slice(cuda)
        ndc = (H, W, FOCAL, FOCAL)
        before = mlp_cuda.launches
        got = serve.make_nerf_serve_fn(params, cfg, render_cfg, ndc=ndc)(*rays)
        torch.cuda.synchronize()
        assert mlp_cuda.launches == before + 1  # the fine field
        monkeypatch.setattr(mlp_cuda, "supports_config", lambda c: False)
        want = serve.make_nerf_serve_fn(params, cfg, render_cfg, ndc=ndc)(*rays)
        torch.cuda.synchronize()
        assert mlp_cuda.launches == before + 1
        assert_rgb_close(got["rgb"], want["rgb"])

    def test_counters_count_the_fine_field_through_k3(self, cuda):
        cfg, params, render_cfg, rays = fern_slice(cuda)
        fn = serve.make_nerf_serve_fn(params, cfg, render_cfg)
        profiling.RECORDER.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            fn(*rays)
        counts = profiling.counters()
        profiling.RECORDER.clear()
        assert counts["serve.field_points"] == BATCH * (64 + 128)
        assert counts["serve.field_points_k3"] == BATCH * 128
        assert counts["serve.field_points_fused"] == BATCH * 64

    def test_packs_the_fine_model_once(self, cuda, monkeypatch):
        cfg, params, render_cfg, rays = fern_slice(cuda)
        calls = []
        pack = mlp_cuda.pack_weights
        monkeypatch.setattr(mlp_cuda, "pack_weights",
                            lambda p, c, *dim: calls.append(p) or pack(p, c, *dim))
        fn = serve.make_nerf_serve_fn(params, cfg, render_cfg)
        assert len(calls) == 1 and calls[0] is params["fine"]
        for _ in range(3):
            fn(*rays)
        assert len(calls) == 1

    def test_weights_changed_in_place_are_served(self, cuda):
        cfg, params, render_cfg, rays = fern_slice(cuda)
        fn = serve.make_nerf_serve_fn(params, cfg, render_cfg)
        before = fn(*rays)["rgb"].clone()
        with torch.no_grad():
            params["fine"]["rgb"]["b"].add_(0.25)
        after = fn(*rays)["rgb"]
        assert float((after - before).abs().max()) > 1e-2
        fresh = serve.make_nerf_serve_fn(params, cfg, render_cfg)(*rays)["rgb"]
        assert torch.equal(after, fresh)

    def test_export_keeps_the_operator(self, cuda):
        cfg, params, render_cfg, rays = fern_slice(cuda)
        fn = serve.make_nerf_serve_fn(params, cfg, render_cfg, ndc=(H, W, FOCAL, FOCAL))
        data = serve.export_serving_fn(fn, serve.nerf_serve_specs(BATCH), device=cuda)
        loaded = serve.load_serving_fn(data)
        assert OP in loaded.operators and "scnerf_tpu_torch.sample_pdf.default" in loaded.operators
        assert "scnerf_tpu_torch.dense_into.default" in loaded.operators  # the coarse field
        request = fern_rays(3 * BATCH - 100, seed=2)
        want = serve.RenderService(fn, BATCH, device=cuda)(*request)
        before = mlp_cuda.launches
        got = serve.RenderService(loaded, BATCH, device=cuda)(*request)
        assert mlp_cuda.launches == before + 3  # the fine field of three slices
        for k, v in want.items():
            # disp = acc / depth reaches 1e10 where acc -> 0: relative there.
            err = np.abs(got[k].astype(np.float64) - v) / np.maximum(np.abs(v), 1.0)
            assert np.median(err) < 1e-6 and err.max() < 1e-4, (k, np.median(err), err.max())
