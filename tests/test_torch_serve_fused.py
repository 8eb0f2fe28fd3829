"""The serve path's inference twins of the fields
(``fields/nerf.py:query_field_fused``, ``fields/nerfpp.py:query_mlpnet_fused``),
their parts (``fields/encoding.py:positional_encoding_into``,
``fields/mlp.py:dense_relu`` and ``relu_trunk_fused``) and the dense layer
they write into a wider buffer (``kernels/dense_lt.py:dense_into``).

On the CPU each twin is held bit for bit (``torch.equal``) to
``query_field`` / ``query_mlpnet``, and the serve functions' counters to the
points that went through them; ``dense_into``'s operator is checked for its
schema, its fake and its operands. The tests marked ``cuda`` hold the twins
to the plain fields at the served shapes, list the kernels they launch and
hold ``dense_into`` to ``addmm`` with a separate ReLU; they skip without a
card. This file needs no JAX, so the card's machine runs it with
``python -m pytest --noconftest tests/test_torch_serve_fused.py``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

# One thread: MKL's float32 sums depend on how it splits a product over
# threads (fern's field at 3 threads differs from 1 thread in the last bit),
# and a run of the whole suite once saw the plain field and its twin differ
# so; on one thread MKL has no split to choose.
from _torch_support import hang_watchdog, one_thread  # noqa: F401
from scnerf_tpu_torch import serve
from scnerf_tpu_torch.fields.encoding import (EncodingConfig, positional_encoding,
                                              positional_encoding_into)
from scnerf_tpu_torch.fields.mlp import dense, dense_relu, relu_trunk_fused
from scnerf_tpu_torch.fields.nerf import (NeRFConfig, init_nerf_mlp, query_field,
                                          query_field_fused)
from scnerf_tpu_torch.fields.nerfpp import (NerfPPConfig, init_mlpnet, query_mlpnet,
                                            query_mlpnet_fused)
from scnerf_tpu_torch.kernels import _build, dense_lt
from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig
from scnerf_tpu_torch.render.renderer import RenderConfig
from scnerf_tpu_torch.train import profiling

REPO = Path(__file__).resolve().parents[1]


def seeded(params: dict, seed: int = 0) -> dict:
    """Every leaf of a field's parameter dict drawn (He-scaled weights,
    biases at 0.1), so that each ReLU cuts and no output is flat."""
    gen = torch.Generator().manual_seed(seed)

    def draw(node):
        if isinstance(node, list):
            for x in node:
                draw(x)
            return
        w, b = node.get("w"), node.get("b")
        if w is None:
            for x in node.values():
                draw(x)
            return
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=gen) * (2.0 / w.shape[0]) ** 0.5)
            b.copy_(torch.randn(b.shape, generator=gen) * 0.1)

    draw(params)
    return params


def points(n, s, dim, device="cpu", seed=1):
    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand(n, s, dim, generator=gen) * 2 - 1
    vd = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    return pts.to(device), vd.to(device)


NERF_CASES = {
    "fern": NeRFConfig(),
    "skip_viewdirs": NeRFConfig(depth=4, width=32, skips=(1,), multires=4, multires_views=2),
    "skip_no_viewdirs": NeRFConfig(depth=4, width=32, skips=(1,), multires=4,
                                   use_viewdirs=False),
    "two_skips_in_a_row": NeRFConfig(depth=5, width=16, skips=(1, 2), multires=3,
                                     multires_views=0),
    "no_skip_no_encoding": NeRFConfig(depth=3, width=16, skips=(), multires=0),
}


class TestTwinsOnCpu:
    @pytest.mark.parametrize("case", list(NERF_CASES))
    def test_query_field_fused_bit_for_bit(self, case):
        cfg = NERF_CASES[case]
        mlp = seeded(init_nerf_mlp(cfg, device="cpu"))
        pts, vd = points(16, 64, 3)
        vd = vd if cfg.use_viewdirs else None
        with serve.fp32_inference():
            want = query_field(mlp, cfg, pts, vd)
            got = query_field_fused(mlp, cfg, pts, vd)
        assert got.shape == want.shape == (16, 64, cfg.output_ch if vd is None else 4)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("dim", [3, 4], ids=["fg", "bg"])
    def test_query_mlpnet_fused_bit_for_bit(self, dim):
        """NeRF++'s fg net on 3-D points, its bg net on the 4-D
        inverted-sphere points, at Truck's widths."""
        cfg = NerfPPConfig()
        net = seeded(init_mlpnet(cfg, dim, device="cpu"), seed=dim)
        pts, vd = points(8, 64, dim, seed=dim)
        views_enc = positional_encoding(vd, cfg.view_encoding)
        with serve.fp32_inference():
            want = query_mlpnet(net, cfg, pts, views_enc, dim)
            got = query_mlpnet_fused(net, cfg, pts, views_enc, dim)
        assert got[0].shape == (8, 64, 3) and got[1].shape == (8, 64)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def test_mlpnet_skip_after_the_last_layer_is_ignored(self):
        """``mlpnet_apply`` concatenates only before a later layer."""
        cfg = NerfPPConfig(depth=3, width=16, skips=(1, 2), max_freq_log2=3,
                           max_freq_log2_viewdirs=2)
        net = seeded(init_mlpnet(cfg, 3, device="cpu"))
        pts, vd = points(4, 6, 3)
        views_enc = positional_encoding(vd, cfg.view_encoding)
        with torch.inference_mode():
            got = query_mlpnet_fused(net, cfg, pts, views_enc, 3)
            want = query_mlpnet(net, cfg, pts, views_enc, 3)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    @pytest.mark.parametrize("enc", [
        EncodingConfig(input_dim=3, n_freqs=10), EncodingConfig(input_dim=4, n_freqs=10),
        EncodingConfig(input_dim=3, n_freqs=4, include_input=False),
        EncodingConfig(input_dim=3, n_freqs=5, log_sampling=False),
        EncodingConfig(input_dim=3, n_freqs=0),
    ], ids=["3d", "4d", "no_input", "linear", "none"])
    def test_encoding_into_a_wider_buffer(self, enc):
        x = torch.randn(50, enc.input_dim, generator=torch.Generator().manual_seed(3))
        buf = torch.full((50, enc.out_dim + 7), float("nan"))
        out = positional_encoding_into(x, enc, buf[:, :enc.out_dim])
        assert out.data_ptr() == buf.data_ptr() and out.shape == (50, enc.out_dim)
        assert torch.equal(buf[:, :enc.out_dim], positional_encoding(x, enc))
        assert torch.isnan(buf[:, enc.out_dim:]).all()

    def test_dense_relu_is_relu_of_dense(self):
        layer = seeded({"w": torch.empty(19, 8), "b": torch.empty(8)})
        x = torch.randn(30, 19, generator=torch.Generator().manual_seed(4))
        assert torch.equal(dense_relu(layer, x), torch.relu(dense(layer, x)))

    @pytest.mark.parametrize("skips", [(), (1,), (0, 1), (2,)])
    def test_trunk_writes_the_skip_input_in_place(self, skips):
        enc = EncodingConfig(input_dim=3, n_freqs=2)
        layers, dim = [], enc.out_dim
        for i in range(3):
            layers.append({"w": torch.empty(dim, 8), "b": torch.empty(8)})
            dim = 8 + (enc.out_dim if i in skips else 0)
        seeded(layers)
        x = torch.randn(20, 3, generator=torch.Generator().manual_seed(5))
        h = pe = positional_encoding(x, enc)
        for i, layer in enumerate(layers):
            h = torch.relu(dense(layer, h))
            if i in skips:
                h = torch.cat([pe, h], -1)
        assert torch.equal(relu_trunk_fused(layers, skips, x, enc), h)


class TestServeCountersOnCpu:
    def test_nerf_coarse_and_fine_through_the_twin(self):
        cfg = NeRFConfig(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
        params = {"coarse": seeded(init_nerf_mlp(cfg, device="cpu")),
                  "fine": seeded(init_nerf_mlp(cfg, device="cpu"), seed=1)}
        service = serve.RenderService(
            serve.make_nerf_serve_fn(params, cfg, RenderConfig(n_samples=8, n_importance=16)),
            32, device="cpu")
        rays = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (40, 1))
        request = (np.zeros((40, 3), np.float32), rays, np.full(40, 2.0, np.float32),
                   np.full(40, 6.0, np.float32))
        profiling.RECORDER.clear()
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                service(*request)
            counts = profiling.counters()
        finally:
            profiling.RECORDER.clear()
        points_run = 2 * 32 * (8 + 8 + 16)  # two slices, padding in
        assert counts == {"serve.rays": 40, "serve.rays_run": 64,
                          "serve.field_points": points_run,
                          "serve.field_points_fused": points_run}

    def test_nerfpp_every_level_through_the_twin(self):
        cfg = NerfPPConfig(depth=3, width=32, skips=(1,), max_freq_log2=4,
                           max_freq_log2_viewdirs=2)
        levels = [{"fg": seeded(init_mlpnet(cfg, 3, device="cpu"), seed=i),
                   "bg": seeded(init_mlpnet(cfg, 4, device="cpu"), seed=10 + i)}
                  for i in range(2)]
        fn = serve.make_nerfpp_serve_fn(levels, cfg, NerfPPRenderConfig(cascade_samples=(4, 8)))
        gen = torch.Generator().manual_seed(6)
        ray_d = torch.nn.functional.normalize(torch.randn(16, 3, generator=gen), dim=-1)
        profiling.RECORDER.clear()
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                fn(torch.zeros(16, 3), ray_d, torch.full((16,), 1e-4))
            counts = profiling.counters()
        finally:
            profiling.RECORDER.clear()
        assert counts == {"serve.field_points": 16 * (4 + 4 + 12 + 12),
                          "serve.field_points_fused": 16 * (4 + 4 + 12 + 12)}


class TestDenseInto:
    def _operands(self, m=12, k=9, n=5, seed=7):
        gen = torch.Generator().manual_seed(seed)
        layer = {"w": torch.randn(k, n, generator=gen), "b": torch.randn(n, generator=gen)}
        x = torch.randn(m, k, generator=gen)
        return layer, x

    @pytest.mark.parametrize("relu", [True, False])
    def test_plain_route_into_a_column_block(self, relu):
        layer, x = self._operands()
        buf = torch.full((12, 3 + 5 + 2), float("nan"))
        out = dense_lt.dense_into(layer, x, buf[:, 3:8], relu)
        want = dense(layer, x)
        assert out.data_ptr() == buf[:, 3:8].data_ptr()
        assert torch.equal(buf[:, 3:8], torch.relu(want) if relu else want)
        assert torch.isnan(buf[:, :3]).all() and torch.isnan(buf[:, 8:]).all()

    def test_schema_and_fake(self):
        schema = str(torch.ops.scnerf_tpu_torch.dense_into.default._schema)
        assert schema == ("scnerf_tpu_torch::dense_into(Tensor x, Tensor w, Tensor b, "
                          "Tensor(a!) out, bool relu) -> ()")
        with FakeTensorMode():
            buf = torch.empty(6, 10)
            assert torch.ops.scnerf_tpu_torch.dense_into(
                torch.empty(6, 4), torch.empty(4, 7), torch.empty(7), buf[:, 3:], True) is None

    @pytest.mark.parametrize("fault,error,match", [
        ("bias (N + 1)", ValueError, "do not fit"),
        ("out (M - 1, N)", ValueError, "do not fit"),
        ("float64 weight", TypeError, "float32"),
        ("weight on another device", ValueError, "different devices"),
        ("strided weight", ValueError, "contiguous"),
        ("column-strided out", ValueError, "unit column stride"),
    ])
    def test_cuda_implementation_checks_its_operands(self, fault, error, match, monkeypatch):
        """The CUDA implementation raises before it reaches a pointer (here
        on CPU tensors, which fail a check before the launch would)."""
        monkeypatch.setattr(_build, "load", lambda name: pytest.fail("reached the launch"))
        layer, x = self._operands()
        w, b, out = layer["w"], layer["b"], torch.empty(12, 5)
        if fault == "bias (N + 1)":
            b = torch.zeros(6)
        elif fault == "out (M - 1, N)":
            out = out[:-1]
        elif fault == "float64 weight":
            w = w.double()
        elif fault == "weight on another device":
            w = w.to("meta")
        elif fault == "strided weight":
            w = torch.zeros(5, 9).t()
        else:
            out = torch.empty(12, 10)[:, ::2]
        with pytest.raises(error, match=match):
            dense_lt._dense_into_cuda(x, w, b, out, True)

    def test_registered_at_import_for_cuda_only(self):
        """Importing the module registers the operator's CUDA
        implementation with nothing built; the CPU takes the plain twin
        before the operator."""
        code = (
            "import torch\n"
            "from scnerf_tpu_torch.kernels import _build\n"
            "def refuse(*args):\n"
            "    raise AssertionError('built or loaded at import')\n"
            "_build.load = _build.build = refuse\n"
            "from scnerf_tpu_torch.kernels import dense_lt\n"
            "name = 'scnerf_tpu_torch::dense_into'\n"
            "assert torch._C._dispatch_has_kernel_for_dispatch_key(name, 'CUDA')\n"
            "assert not torch._C._dispatch_has_kernel_for_dispatch_key(name, 'CPU')\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr

    def test_library_links_cublaslt(self, tmp_path, monkeypatch):
        """One nvcc command as for the kernels, with cuBLASLt linked."""
        commands = []

        def run(cmd, **kwargs):
            commands.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
            return subprocess.CompletedProcess(cmd, 0, "", "")

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/cuda/bin/nvcc")
        monkeypatch.setattr(_build.subprocess, "run", run)
        _build.build("dense_lt")
        (cmd,) = commands
        assert cmd == ["/toolkit/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-lcublasLt", "-o",
                       cmd[-2], str(_build.CSRC_DIR / "dense_lt.cu")]
        assert _build.library_path("dense_lt").name.startswith("libdense_lt_")

    def test_cpu_export_takes_the_plain_twin(self):
        """On the CPU the twin's trunk exports as ATen operators only."""
        cfg = NeRFConfig(depth=3, width=16, skips=(1,), multires=2, multires_views=1)
        mlp = seeded(init_nerf_mlp(cfg, device="cpu"))

        class Field(torch.nn.Module):
            def forward(self, pts, vd):
                return query_field_fused(mlp, cfg, pts, vd)

        pts, vd = points(4, 5, 3)
        program = torch.export.export(Field(), (pts, vd), strict=False)
        assert serve.artifact_operators(program) == []
        with torch.inference_mode():
            assert torch.equal(program.module()(pts, vd), query_field(mlp, cfg, pts, vd))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# The early fields as the benchmark's cells serve them: fern's coarse field
# (8,192 rays, 64 samples) and Truck's level-0 fg and bg nets (4,096 rays,
# 64 samples).
SERVED = {"fern_coarse": (8192, 64, 3), "truck_fg": (4096, 64, 3), "truck_bg": (4096, 64, 4)}


def served_field(name, device):
    """``(plain, twin)`` closures of one served early field on ``device``."""
    n, s, dim = SERVED[name]
    pts, vd = points(n, s, dim, device, seed=11)
    if name == "fern_coarse":
        cfg = NeRFConfig()
        mlp = seeded(init_nerf_mlp(cfg, device=device))
        return (lambda: (query_field(mlp, cfg, pts, vd),),
                lambda: (query_field_fused(mlp, cfg, pts, vd),))
    cfg = NerfPPConfig()
    net = seeded(init_mlpnet(cfg, dim, device=device), seed=dim)
    views_enc = positional_encoding(vd, cfg.view_encoding)
    return (lambda: query_mlpnet(net, cfg, pts, views_enc, dim),
            lambda: query_mlpnet_fused(net, cfg, pts, views_enc, dim))


def device_kernels(fn) -> list[str]:
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("name", list(SERVED))
    def test_twin_bit_for_bit_at_the_served_shape(self, cuda, name):
        plain, twin = served_field(name, cuda)
        with serve.fp32_inference():
            want, got = plain(), twin()
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("name", list(SERVED))
    def test_twin_launches_no_relu_or_concatenation_pass(self, cuda, name):
        """No ``clamp_min`` (ReLU) kernel; one concatenation, fern's
        ``[rgb, alpha]`` of 16 bytes a point; NeRF++ none."""
        plain, twin = served_field(name, cuda)
        with serve.fp32_inference():
            twin()
            names = device_kernels(twin)
            before = device_kernels(plain)
        assert any("clamp" in k for k in before)  # the plain field's ReLUs
        assert not [k for k in names if "clamp" in k]
        cats = [k for k in names if "CatArrayBatchedCopy" in k]
        assert len(cats) == (1 if name == "fern_coarse" else 0), cats

    @pytest.mark.parametrize("k,n,relu", [(256, 256, True), (256, 256, False), (63, 256, True),
                                          (84, 256, True), (283, 128, True)])
    def test_dense_into_a_column_block_is_addmm(self, cuda, k, n, relu):
        gen = torch.Generator().manual_seed(k + n)
        layer = {"w": (torch.randn(k, n, generator=gen) * (2.0 / k) ** 0.5).to(cuda),
                 "b": (torch.randn(n, generator=gen) * 0.1).to(cuda)}
        x = torch.relu(torch.randn(65536, k, generator=gen)).to(cuda)
        buf = torch.full((65536, 63 + n), float("nan"), device=cuda)
        with serve.fp32_inference():
            want = dense(layer, x)
            want = torch.relu(want) if relu else want
            dense_lt.dense_into(layer, x, buf[:, 63:], relu)
            torch.cuda.synchronize()
            assert torch.equal(buf[:, 63:], want)
            assert torch.isnan(buf[:, :63]).all()
            # Profiled warm, as the serve path calls it, with its plan kept.
            names = device_kernels(lambda: dense_lt.dense_into(layer, x, buf[:, 63:], relu))
        assert len(names) == 1 and "clamp" not in names[0], names

    def test_dense_into_refuses_a_column_strided_out(self, cuda):
        layer = {"w": torch.zeros(4, 3, device=cuda), "b": torch.zeros(3, device=cuda)}
        with pytest.raises(ValueError, match="unit column stride"):
            dense_lt.dense_into(layer, torch.zeros(5, 4, device=cuda),
                                torch.zeros(5, 6, device=cuda)[:, ::2], True)
