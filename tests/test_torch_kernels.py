"""The kernel wrappers (``scnerf_tpu_torch/kernels/``: K1 and K2 in
``pdf_cuda.py``, K3 in ``mlp_cuda.py``, K4 in ``searchsorted_cuda.py``) and
their build.

On the CPU the wrappers take the plain twin and launch nothing. The tests
marked ``cuda`` hold the CUDA kernels against the twin on the card, values
and K2's gradients; they skip without one. This file needs no JAX, so the card's machine runs it with
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""
import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_support import hang_watchdog  # noqa: F401
from scnerf_tpu_torch import bridge, distributed, serve
from scnerf_tpu_torch.camera import model as camera_model
from scnerf_tpu_torch.camera import rays
from scnerf_tpu_torch.fields import mlp, nerf, nerfpp
from scnerf_tpu_torch.kernels import _build, mlp_cuda, pdf_cuda, searchsorted_cuda
from scnerf_tpu_torch.sampling.pdf import bracket, inverse_cdf, pdf_uniforms, sample_pdf
from scnerf_tpu_torch.sampling.searchsorted import searchsorted
from scnerf_tpu_torch.serve import fp32_inference

REPO = Path(__file__).resolve().parents[1]


def _inputs(n, b, s, *, det, seed=0, device="cpu"):
    """Sorted bins, weights with empty rows and bins (so the eps and the
    denominator guard act), and det or random u."""
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.random((n, b)).astype(np.float32) * 4 + 1, axis=-1)
    weights = rng.random((n, b - 1)).astype(np.float32)
    weights[: n // 8] = 0.0
    weights[n // 8: n // 4, ::3] = 0.0
    if det:
        u = pdf_uniforms(None, n, s, True, device="cpu")
    else:
        u = torch.from_numpy(rng.random((n, s)).astype(np.float32))
    return (torch.from_numpy(bins).to(device), torch.from_numpy(weights).to(device),
            u.to(device))


def assert_resample_close(got, want, bins):
    """tests/test_kernels.py's criterion: boundary flips (u within rounding
    of a CDF edge) may move a few samples to the neighbouring bin."""
    err = (got - want).abs().cpu().numpy()
    assert np.median(err) < 1e-6
    assert (err > 1e-4).mean() < 1e-3
    assert float(got.min()) >= float(bins.min()) - 1e-5
    assert float(got.max()) <= float(bins.max()) + 1e-5


class TestCpuRoute:
    @pytest.mark.parametrize("det", [True, False])
    def test_cpu_tensor_takes_plain_twin(self, det):
        bins, weights, u = _inputs(64, 63, 64, det=det)
        before = pdf_cuda.launches
        got = pdf_cuda.sample_pdf_core(bins, weights, u)
        assert pdf_cuda.launches == before
        torch.testing.assert_close(got, pdf_cuda.sample_pdf_plain(bins, weights, u),
                                   rtol=0, atol=0)
        assert got.shape == (64, 64)

    def test_cpu_accepts_strided_views(self):
        bins, weights, u = _inputs(16, 10, 8, det=False)
        w_view = torch.cat([weights, weights], -1)[:, ::2]
        assert not w_view.is_contiguous()
        pdf_cuda.sample_pdf_core(bins, w_view, u)

    @pytest.mark.parametrize("bad,exc", [
        (lambda b, w, u: (b.double(), w, u), TypeError),
        (lambda b, w, u: (b, w.half(), u), TypeError),
        (lambda b, w, u: (b, w[:, :-1], u), ValueError),
        (lambda b, w, u: (b, w, u[:-1]), ValueError),
        (lambda b, w, u: (b[0], w, u), ValueError),
        (lambda b, w, u: (b.to("meta"), w.to("meta"), u.to("meta")), ValueError),
        (lambda b, w, u: (b, w, u.to("meta")), ValueError),
    ])
    def test_rejects_what_the_kernel_does_not_take(self, bad, exc):
        with pytest.raises(exc):
            pdf_cuda.sample_pdf_core(*bad(*_inputs(8, 5, 4, det=True)))


def _forward_only_calls(device):
    """K1's and K2's forward on one input that requires grad, by name."""
    def call(which, grad_input):
        inputs = list(_inputs(64, 17, 24, det=False, device=device))
        inputs[grad_input].requires_grad_()
        if which == "K1":
            return pdf_cuda.sample_pdf_core(*inputs)
        return pdf_cuda.sample_pdf_fwd(*inputs, "nerfpp")[0]
    return call


@pytest.mark.parametrize("grad_input", [0, 1, 2], ids=["bins", "weights", "u"])
@pytest.mark.parametrize("which", ["K1", "K2"])
def test_forward_only_on_cpu(which, grad_input):
    """An input that requires grad under grad mode is refused on the CPU as
    on the card (there no gradient would pass); under no_grad the call
    runs and its depths leave the graph."""
    call = _forward_only_calls("cpu")
    with pytest.raises(ValueError, match="forward only"):
        call(which, grad_input)
    with torch.no_grad():
        assert not call(which, grad_input).requires_grad


def assert_grads_close(got, want):
    """tests/test_kernels.py's criterion: an entry is off when its error
    exceeds 1e-4 of the largest entry; under 0.2% may be (flips)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert (np.abs(got - want) / (np.abs(want).max() + 1e-8) > 1e-4).mean() < 2e-3


def _k2_grads(fn, bins, weights, u, cot):
    """Gradients of sum(fn(bins, weights, u) * cot) into the three inputs."""
    leaves = [x.clone().requires_grad_() for x in (bins, weights, u)]
    (fn(*leaves) * cot).sum().backward()
    return [x.grad for x in leaves]


class TestK2CpuRoute:
    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    def test_cpu_tensor_takes_plain_twin(self, variant):
        bins, weights, u = _inputs(64, 63, 128, det=True)
        before = pdf_cuda.diff_launches
        out, inds, cdf = pdf_cuda.sample_pdf_fwd(bins, weights, u, variant)
        assert pdf_cuda.diff_launches == before
        assert cdf is None and inds.dtype == torch.int32 and out.shape == (64, 128)
        want = inverse_cdf(bins, weights, u, variant)
        torch.testing.assert_close(out, want[0], rtol=0, atol=0)
        torch.testing.assert_close(inds, want[1], rtol=0, atol=0)
        cdf = pdf_cuda.sample_pdf_fwd(bins, weights, u, variant, with_cdf=True)[2]
        torch.testing.assert_close(cdf, want[2], rtol=0, atol=0)

    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    def test_grads_match_plain_autograd(self, variant):
        """The hand-written backward against autograd through the twin."""
        bins, weights, u = _inputs(256, 33, 24, det=False)
        cot = torch.from_numpy(np.random.default_rng(1).normal(size=(256, 24)).astype(np.float32))
        got = _k2_grads(lambda b, w, uu: pdf_cuda.sample_pdf_diff(b, w, uu, variant),
                        bins, weights, u, cot)
        want = _k2_grads(lambda b, w, uu: sample_pdf(None, b, w, 24, u=uu, variant=variant),
                         bins, weights, u, cot)
        for g, w in zip(got, want):
            assert_grads_close(g, w)

    def test_no_saved_cdf_without_grad(self):
        bins, weights, u = _inputs(8, 5, 4, det=True)
        with torch.inference_mode():
            out = pdf_cuda.sample_pdf_diff(bins, weights, u)
        assert not out.requires_grad

    @pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input_requires_grad"])
    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    def test_no_autograd_function_without_grad(self, mode, variant, monkeypatch):
        """Where no gradient can be asked for, the forward runs alone: the
        autograd function is never entered, and the depths are the twin's."""
        def refuse(*args):
            raise AssertionError("entered _SamplePdfDiff without a gradient to compute")

        monkeypatch.setattr(pdf_cuda._SamplePdfDiff, "apply", refuse)
        bins, weights, u = _inputs(64, 33, 24, det=False)
        if mode != "no_input_requires_grad":
            weights.requires_grad_()
        context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
                   "no_input_requires_grad": torch.enable_grad}[mode]
        with context():
            got = pdf_cuda.sample_pdf_diff(bins, weights, u, variant)
        assert not got.requires_grad
        want = sample_pdf(None, bins, weights.detach(), 24, u=u, variant=variant)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    def test_autograd_function_with_grad(self, variant, monkeypatch):
        """With an input requiring grad under grad mode, the call goes
        through the autograd function once, and its gradients are the
        twin's autograd."""
        calls = []
        apply = pdf_cuda._SamplePdfDiff.apply

        def counted(*args):
            calls.append(args[-1])
            return apply(*args)

        monkeypatch.setattr(pdf_cuda._SamplePdfDiff, "apply", counted)
        bins, weights, u = _inputs(128, 17, 20, det=True)
        cot = torch.from_numpy(np.random.default_rng(2).normal(size=(128, 20)).astype(np.float32))
        got = _k2_grads(lambda b, w, uu: pdf_cuda.sample_pdf_diff(b, w, uu, variant),
                        bins, weights, u, cot)
        assert calls == [variant]
        want = _k2_grads(lambda b, w, uu: sample_pdf(None, b, w, 20, u=uu, variant=variant),
                         bins, weights, u, cot)
        for g, w in zip(got, want):
            assert_grads_close(g, w)

    @pytest.mark.parametrize("bad,exc", [
        (lambda b, w, u: (b, w, u, "nerf++"), ValueError),
        (lambda b, w, u: (b.double(), w, u, "nerfpp"), TypeError),
        (lambda b, w, u: (b, w[:, :-1], u, "nerfpp"), ValueError),
        (lambda b, w, u: (b.to("meta"), w.to("meta"), u.to("meta"), "nerfpp"), ValueError),
    ])
    def test_rejects_what_the_kernel_does_not_take(self, bad, exc):
        with pytest.raises(exc):
            pdf_cuda.sample_pdf_fwd(*bad(*_inputs(8, 5, 4, det=True)))


class TestBuild:
    def test_missing_nvcc_raises(self, monkeypatch):
        import torch.utils.cpp_extension as cpp

        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(cpp, "CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()

    def test_library_named_by_source_hash_in_ignored_dir(self):
        lib = _build.library_path("sample_pdf")
        assert lib.parent == REPO / "build" / "kernels"
        assert lib.name.startswith("libsample_pdf_") and lib.suffix == ".so"
        assert "build/" in (REPO / ".gitignore").read_text().split()
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

    def test_ops_library_named_by_both_sources_and_torch(self, tmp_path, monkeypatch):
        """K1/K2's operator library: under build/kernels/, and named anew
        when either source or torch's version changes."""
        assert _build.ops_library_path("sample_pdf").parent == REPO / "build" / "kernels"
        for suffix in (".cu", "_op.cpp"):
            (tmp_path / f"sample_pdf{suffix}").write_bytes(
                (_build.CSRC_DIR / f"sample_pdf{suffix}").read_bytes())
        monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
        names = [_build.ops_library_path("sample_pdf").name]
        assert names[0].startswith("libsample_pdf_op_")
        for suffix in (".cu", "_op.cpp"):
            with open(tmp_path / f"sample_pdf{suffix}", "a") as f:
                f.write("\n// changed\n")
            names.append(_build.ops_library_path("sample_pdf").name)
        monkeypatch.setattr(torch, "__version__", "0.0.0+other")
        names.append(_build.ops_library_path("sample_pdf").name)
        assert len(set(names)) == 4, names

    def test_ops_build_command(self, tmp_path, monkeypatch):
        """One nvcc command: both sources, sm_90a, torch's C++ ABI flag and
        headers, torch's libraries with an rpath, the output under the build
        directory; the library is then in place."""
        commands = []

        def run(cmd, **kwargs):
            commands.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
            return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

        build_dir = tmp_path / "build" / "kernels"
        monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
        monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/cuda/bin/nvcc")
        monkeypatch.setattr(_build.subprocess, "run", run)
        lib = _build.build_ops("sample_pdf")
        (cmd,) = commands
        assert cmd[0] == "/toolkit/cuda/bin/nvcc"
        abi = [flag for flag in cmd if flag.startswith("-D_GLIBCXX_USE_CXX11_ABI=")]
        assert abi == [f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
        assert str(_build.CSRC_DIR / "sample_pdf.cu") in cmd
        assert str(_build.CSRC_DIR / "sample_pdf_op.cpp") in cmd
        assert "-I/toolkit/cuda/include" in cmd
        from torch.utils import cpp_extension
        for d in cpp_extension.include_paths():
            assert f"-I{d}" in cmd
        for d in cpp_extension.library_paths():
            assert f"-L{d}" in cmd and f"-rpath,{d}" in cmd
        assert set(_build.TORCH_LIBRARIES) <= set(cmd)
        assert Path(cmd[cmd.index("-o") + 1]).parent == build_dir
        assert lib == build_dir / _build.ops_library_path("sample_pdf").name and lib.exists()
        assert (build_dir / "sample_pdf_op.log").read_text() == "ptxas info"
        assert _build.build_ops("sample_pdf") == lib and len(commands) == 1  # built once

    def test_failed_ops_build_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/cuda/bin/nvcc")
        monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kwargs:
                            subprocess.CompletedProcess(cmd, 2, "", "error: no such header"))
        with pytest.raises(RuntimeError, match="no such header"):
            _build.build_ops("sample_pdf")
        assert not list(tmp_path.glob("*.so"))

    def test_ops_build_without_nvcc_raises(self, tmp_path, monkeypatch):
        import torch.utils.cpp_extension as cpp

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(cpp, "CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_ops("sample_pdf")

    @pytest.mark.parametrize("name", ["searchsorted", "fused_mlp"])
    def test_new_sources_named_alike(self, name):
        """K4's and K3's sources build the same way, with no fast math (the
        encoding needs precise sinf/cosf)."""
        lib = _build.library_path(name)
        assert lib.parent == REPO / "build" / "kernels"
        assert lib.name.startswith(f"lib{name}_") and lib.suffix == ".so"
        assert not any("fast" in flag for flag in _build.NVCC_FLAGS)


# The port's entry points run on the card unless the caller asks for the CPU.
ENTRY_POINTS = [camera_model.init_camera, nerf.init_nerf_mlp, nerfpp.init_mlpnet,
                nerfpp.init_nerfpp_net, mlp.init_dense, bridge.tree_to_torch,
                bridge.camera_from_numpy, bridge.train_params_to_torch,
                rays.full_image_pixels, serve.export_serving_fn, serve.RenderService,
                distributed.shard_batch]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda fn: fn.__name__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _sorted_rows(rows, n, m, *, seed=0, ties=False, device="cpu"):
    """Sorted rows and queries; with ``ties``, runs of repeated values and
    queries equal to row entries half of the time."""
    rng = np.random.default_rng(seed)
    a = rng.random((rows, n))
    if ties:
        a = np.round(a * 8) / 8
    a = np.sort(a, axis=-1).astype(np.float32)
    v = rng.random((rows, m)).astype(np.float32)
    if ties and n:
        picks = np.take_along_axis(a, rng.integers(0, n, (rows, m)), -1)
        v = np.where(rng.random((rows, m)) < 0.5, picks, v).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(v).to(device)


class TestK4CpuRoute:
    @pytest.mark.parametrize("side", ["left", "right"])
    @pytest.mark.parametrize("ties", [False, True])
    def test_cpu_tensor_takes_plain_twin(self, side, ties):
        a, v = _sorted_rows(64, 63, 64, ties=ties)
        before = searchsorted_cuda.launches
        got = searchsorted_cuda.searchsorted_cuda(a, v, side)
        assert searchsorted_cuda.launches == before
        assert got.dtype == torch.int32 and got.shape == (64, 64)
        torch.testing.assert_close(got, searchsorted(a, v, side), rtol=0, atol=0)
        # The TPU kernel's compare-and-count, for the record.
        count = (v[:, :, None] >= a[:, None, :]) if side == "right" else (v[:, :, None] > a[:, None, :])
        torch.testing.assert_close(got, count.sum(-1, dtype=torch.int32), rtol=0, atol=0)

    @pytest.mark.parametrize("bad,exc", [
        (lambda a, v: (a, v, "middle"), ValueError),
        (lambda a, v: (a[0], v, "left"), ValueError),
        (lambda a, v: (a[:1], v, "left"), ValueError),  # K4 does not broadcast
        (lambda a, v: (a.double(), v, "left"), TypeError),
        (lambda a, v: (a, v.to(torch.int32), "left"), TypeError),
        (lambda a, v: (a, v.to("meta"), "left"), ValueError),
        (lambda a, v: (a.to("meta"), v.to("meta"), "left"), ValueError),
    ])
    def test_rejects_what_the_kernel_does_not_take(self, bad, exc):
        with pytest.raises(exc):
            searchsorted_cuda.searchsorted_cuda(*bad(*_sorted_rows(4, 9, 5)))


def _field_inputs(n, s, cfg, *, seed=0, device="cpu"):
    """Weights of ``cfg`` from a seed, random points, unit view directions."""
    params = nerf.init_nerf_mlp(cfg, generator=torch.Generator().manual_seed(seed),
                                device=device)
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return params, torch.from_numpy(pts).to(device), torch.from_numpy(vd).to(device)


class TestK3CpuRoute:
    def test_cpu_tensor_takes_plain_twin(self):
        cfg = nerf.NeRFConfig()
        params, pts, vd = _field_inputs(3, 7, cfg)
        before = mlp_cuda.launches
        got = mlp_cuda.fused_query_field(params, cfg, pts, vd)
        assert mlp_cuda.launches == before
        assert got.shape == (3, 7, 4)
        torch.testing.assert_close(got, nerf.query_field(params, cfg, pts, vd), rtol=0, atol=0)

    @pytest.mark.parametrize("fields", [
        dict(depth=4), dict(width=128), dict(skips=(3,)), dict(use_viewdirs=False),
        dict(multires=mlp_cuda.MAX_FREQS + 1), dict(multires_views=-1),
    ])
    def test_unsupported_config_raises(self, fields):
        cfg = nerf.NeRFConfig(**fields)
        params, pts, vd = _field_inputs(2, 3, nerf.NeRFConfig())
        with pytest.raises(ValueError):
            mlp_cuda.fused_query_field(params, cfg, pts, vd)

    @pytest.mark.parametrize("what", ["pts_rank", "viewdirs_rows", "weight_shape", "float64",
                                      "meta", "mixed_devices", "requires_grad"])
    def test_rejects_what_the_kernel_does_not_take(self, what):
        cfg = nerf.NeRFConfig()
        params, pts, vd = _field_inputs(2, 3, cfg)
        exc = ValueError
        if what == "pts_rank":
            pts = pts[0]
        elif what == "viewdirs_rows":
            vd = vd[:1]
        elif what == "weight_shape":
            params["views"]["w"] = params["views"]["w"][:-1]
        elif what == "float64":
            pts, exc = pts.double(), TypeError
        elif what == "meta":
            params = bridge.tree_to_torch(bridge.tree_to_numpy(params), device="meta")
            pts, vd = pts.to("meta"), vd.to("meta")
        elif what == "mixed_devices":
            pts = pts.to("meta")
        else:
            params["pts"][0]["w"].requires_grad_()
        with pytest.raises(exc):
            mlp_cuda.fused_query_field(params, cfg, pts, vd)

    def test_forward_only_under_no_grad(self):
        cfg = nerf.NeRFConfig()
        params, pts, vd = _field_inputs(2, 3, cfg)
        params["rgb"]["w"].requires_grad_()
        with torch.no_grad():
            assert mlp_cuda.fused_query_field(params, cfg, pts, vd).shape == (2, 3, 4)


def _cpu_calls():
    """One call of each kernel's wrapper on CPU tensors."""
    bins, weights, u = _inputs(8, 5, 4, det=True)
    a, v = _sorted_rows(4, 9, 5)
    cfg = nerf.NeRFConfig()
    params, pts, vd = _field_inputs(2, 3, cfg)
    return {
        "K1": lambda: pdf_cuda.sample_pdf_core(bins, weights, u),
        "K2": lambda: pdf_cuda.sample_pdf_diff(bins, weights, u, "nerfpp"),
        "K3": lambda: mlp_cuda.fused_query_field(params, cfg, pts, vd),
        "K4": lambda: searchsorted_cuda.searchsorted_cuda(a, v, "right"),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_cpu_tensors_never_reach_the_launch_helper(kernel, monkeypatch):
    """The host launch paths (_build.launch: the raw stream, the device
    guard; _build.load_ops: K1's and K2's operators) are the card's alone;
    CPU tensors take the twin first."""
    def refuse(*args):
        raise AssertionError("the launch helper was called for CPU tensors")

    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "load_ops", refuse)
    pdf_cuda._ops.cache_clear()
    out = _cpu_calls()[kernel]()
    assert out.device.type == "cpu"


def test_package_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports in a fresh
    interpreter without pulling in jax or the JAX package, nor any of the
    optional libraries the card's machine lacks (imageio, PIL, cv2, orbax,
    wandb, matplotlib, transformers, safetensors, huggingface_hub): those
    are imported only where they are used, or not at all."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import scnerf_tpu_torch as p\n"
        "import chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'scnerf_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'scnerf_tpu.')) or m == 'scnerf_tpu')\n"
        "optional = sorted(m for m in sys.modules\n"
        "                  if m.split('.')[0] in ('imageio', 'PIL', 'cv2', 'orbax', 'wandb',\n"
        "                                         'matplotlib', 'transformers', 'safetensors',\n"
        "                                         'huggingface_hub'))\n"
        "assert len(names) >= 90, names\n"
        "assert {'scnerf_tpu_torch.kernels.mlp_cuda', 'scnerf_tpu_torch.kernels.searchsorted_cuda',\n"
        "        'scnerf_tpu_torch.losses.prd', 'scnerf_tpu_torch.train.step',\n"
        "        'scnerf_tpu_torch.core.config', 'scnerf_tpu_torch.core.imaging',\n"
        "        'scnerf_tpu_torch.data.noise', 'scnerf_tpu_torch.data.llff',\n"
        "        'scnerf_tpu_torch.data.batching', 'scnerf_tpu_torch.matching.pairs',\n"
        "        'scnerf_tpu_torch.matching.provider', 'scnerf_tpu_torch.geometry.alignment',\n"
        "        'scnerf_tpu_torch.metrics.ssim', 'scnerf_tpu_torch.losses.prd_eval',\n"
        "        'scnerf_tpu_torch.train.logging_utils', 'scnerf_tpu_torch.train.profiling',\n"
        "        'scnerf_tpu_torch.train.checkpoint', 'scnerf_tpu_torch.train.driver',\n"
        "        'scnerf_tpu_torch.cli.train', 'scnerf_tpu_torch.cli.render',\n"
        "        'scnerf_tpu_torch.data.nerfpp_split', 'scnerf_tpu_torch.data.blender',\n"
        "        'scnerf_tpu_torch.train.nerfpp_driver', 'scnerf_tpu_torch.metrics.lpips',\n"
        "        'scnerf_tpu_torch.tools.video', 'scnerf_tpu_torch.tools.convert',\n"
        "        'scnerf_tpu_torch.matching.superpoint', 'scnerf_tpu_torch.matching.superglue',\n"
        "        'scnerf_tpu_torch.matching.superglue_hf',\n"
        "        'scnerf_tpu_torch.tools.calibration_baselines', 'scnerf_tpu_torch.tools.visualize',\n"
        "        'scnerf_tpu_torch.tools.colmap', 'scnerf_tpu_torch.tools.colmap_db',\n"
        "        'scnerf_tpu_torch.tools.colmap_runner', 'scnerf_tpu_torch.cli.export',\n"
        "        'scnerf_tpu_torch.native', 'scnerf_tpu_torch.distributed',\n"
        "        'scnerf_tpu_torch.distributed.init', 'scnerf_tpu_torch.distributed.mesh',\n"
        "        'scnerf_tpu_torch.distributed.reduce', 'scnerf_tpu_torch.scripts._analytic_scene',\n"
        "        'scnerf_tpu_torch.scripts.soak_nerf', 'scnerf_tpu_torch.scripts.ablation_curriculum',\n"
        "        'scnerf_tpu_torch.scripts.polish_calibration',\n"
        "        'scnerf_tpu_torch.examples.calibration_ablation',\n"
        "        'scnerf_tpu_torch.examples.distortion_discovery',\n"
        "        'scnerf_tpu_torch.examples.from_scratch_calibration',\n"
        "        'scnerf_tpu_torch.examples.self_calibration_demo'} <= set(names), names\n"
        "assert not bad, bad\n"
        "assert not optional, optional\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("b", [63, 62, 64, 2, 200, 1024])
    @pytest.mark.parametrize("det", [True, False])
    def test_matches_plain_twin(self, cuda, b, det):
        bins, weights, u = _inputs(8192, b, 64, det=det, device=cuda)
        before = pdf_cuda.launches
        got = pdf_cuda.sample_pdf_core(bins, weights, u)
        torch.cuda.synchronize()
        assert pdf_cuda.launches == before + 1
        assert_resample_close(got, pdf_cuda.sample_pdf_plain(bins, weights, u), bins)

    def test_ragged_sizes(self, cuda):
        """Ray counts off the block size, sample counts off the warp width."""
        for n, s in ((1, 1), (5, 33), (1027, 100)):
            bins, weights, u = _inputs(n, 17, s, det=False, device=cuda)
            got = pdf_cuda.sample_pdf_core(bins, weights, u)
            torch.cuda.synchronize()
            assert_resample_close(got, pdf_cuda.sample_pdf_plain(bins, weights, u), bins)

    def test_rejects_on_card(self, cuda):
        bins, weights, u = _inputs(64, 9, 8, det=True, device=cuda)
        with pytest.raises(ValueError, match="contiguous"):
            pdf_cuda.sample_pdf_core(bins, torch.cat([weights, weights], -1)[:, ::2], u)
        big = _inputs(4, pdf_cuda.MAX_BINS + 1, 8, det=True, device=cuda)
        with pytest.raises(ValueError, match="bins"):
            pdf_cuda.sample_pdf_core(*big)
        with pytest.raises(ValueError, match="different devices"):
            pdf_cuda.sample_pdf_core(bins, weights, u.cpu())
        with pytest.raises(ValueError, match="shapes disagree"):
            pdf_cuda.sample_pdf_core(bins, weights[:, :-1].contiguous(), u)
        with pytest.raises(ValueError, match="2D"):
            pdf_cuda.sample_pdf_core(bins, weights, u[0])
        with pytest.raises(TypeError, match="u must be float32"):
            pdf_cuda.sample_pdf_core(bins, weights, u.double())

    @pytest.mark.parametrize("fill", [0.0, 1.0])
    def test_u_at_the_ends_and_empty_rows(self, cuda, fill):
        """u = 0 and u = 1 everywhere, on rows of all-zero weights (the eps
        makes them uniform) and on the usual rows."""
        bins, weights, _ = _inputs(4096, 63, 64, det=True, device=cuda)
        weights[:2048] = 0.0
        u = torch.full((4096, 64), fill, device=cuda)
        got = pdf_cuda.sample_pdf_core(bins, weights, u)
        torch.cuda.synchronize()
        assert_resample_close(got, pdf_cuda.sample_pdf_plain(bins, weights, u), bins)

    def test_runs_on_the_current_stream(self, cuda):
        """Launched on a side stream behind a long sleep and a copy that
        makes the weights valid: run on any other stream, the operator would
        read the zeros before the copy."""
        bins, weights, u = _inputs(8192, 63, 64, det=False, device=cuda)
        pending = torch.zeros_like(weights)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda._sleep(200_000_000)
            pending.copy_(weights)
            got = pdf_cuda.sample_pdf_core(bins, pending, u)
        side.synchronize()
        assert torch.equal(got, pdf_cuda.sample_pdf_core(bins, weights, u))

    def test_another_card_current(self, cuda):
        """Tensors on card 0 while card 1 is current: the operator's device
        guard makes card 0 current for the launch."""
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards")
        bins, weights, u = _inputs(1027, 63, 100, det=False, device="cuda:0")
        with torch.cuda.device(1):
            got = pdf_cuda.sample_pdf_core(bins, weights, u)
        torch.cuda.synchronize(0)
        assert got.device == bins.device
        assert_resample_close(got, pdf_cuda.sample_pdf_plain(bins, weights, u), bins)


def _count_on(cdf, u, variant):
    """Compare-and-count over the searched entries of ``cdf``: the TPU
    kernel's way to the search counts."""
    searched = cdf[:, :-1] if variant == "nerfpp" else cdf
    return (u[:, :, None] >= searched[:, None, :]).sum(-1, dtype=torch.int32)


def _lerp_from(bins, cdf, u, inds, variant):
    """The depths from given counts and CDF, op for op as the kernel rounds
    them (each op of the twin's inverse_cdf, on the kernel's CDF)."""
    eps = 1e-6 if variant == "nerfpp" else 1e-5
    below, above = bracket(inds, bins.shape[-1], variant)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    width = torch.gather(bins, -1, above) - torch.gather(bins, -1, below)
    if variant == "nerfpp":
        width = width + eps
    return torch.gather(bins, -1, below) + (u - cdf_b) / denom * width


@pytest.mark.cuda
class TestK2OnCard:
    @pytest.mark.parametrize("b", [63, 62, 64, 2, 200])
    @pytest.mark.parametrize("det", [True, False])
    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    def test_matches_plain_twin(self, cuda, b, det, variant):
        """Depths by the flip criterion; the CDF against the twin's to 1e-6
        (the scan sums in another order than torch.cumsum); the search
        counts equal the twin's except where u lies within 1e-6 of every
        CDF entry that one counted and the other did not (with det u,
        u = 1.0 against the top of the CDF, where empty bins make several
        entries round to within an ulp of 1)."""
        bins, weights, u = _inputs(4096, b, 128, det=det, device=cuda)
        before = pdf_cuda.diff_launches
        out, inds, cdf = pdf_cuda.sample_pdf_fwd(bins, weights, u, variant, with_cdf=True)
        torch.cuda.synchronize()
        assert pdf_cuda.diff_launches == before + 1
        want_out, want_inds, want_cdf = inverse_cdf(bins, weights, u, variant)
        assert_resample_close(out, want_out, bins)
        torch.testing.assert_close(cdf, want_cdf, rtol=0, atol=1e-6)
        off = inds != want_inds
        first = torch.minimum(inds, want_inds).clamp(max=b - 1).long()
        last = (torch.maximum(inds, want_inds) - 1).clamp(0, b - 1).long()
        for j in (first, last):  # the CDF is sorted: the ends bound the rest
            assert ((u - torch.gather(want_cdf, -1, j)).abs()[off] < 1e-6).all()

    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    def test_ties_on_the_cdf(self, cuda, variant):
        """u set exactly to CDF entries, flat runs from zero weights
        included. On the kernel's own CDF the binary search's counts are the
        compare-and-count's on every row whose CDF is non-decreasing, and the
        depths are what the counts give, bit for bit; on a row where the
        scan's rounding inverted two neighbours the count still brackets u
        (cdf[k-1] <= u < cdf[k]). On the twin's CDF (another summation
        order) the counts are the twin's except where u lies within 1e-6 of
        an entry one counted and the other did not."""
        n, b, s = 4096, 63, 128
        bins, weights, u = _inputs(n, b, s, det=False, device=cuda)
        weights[: n // 2, 20:40] = 0.0  # long flat runs
        cdf = pdf_cuda.sample_pdf_fwd(bins, weights, u, variant, with_cdf=True)[2]
        gen = torch.Generator(device=cuda).manual_seed(3)
        picks = torch.randint(0, b, (n, s), generator=gen, device=cuda)
        u = torch.gather(cdf, -1, picks).contiguous()
        out, inds, cdf_again = pdf_cuda.sample_pdf_fwd(bins, weights, u, variant, with_cdf=True)
        torch.cuda.synchronize()
        assert torch.equal(cdf, cdf_again)
        monotone = (cdf.diff(dim=-1) >= 0).all(-1)
        assert monotone.float().mean() > 0.99
        count = _count_on(cdf, u, variant)
        assert torch.equal(inds[monotone], count[monotone])
        n_search = b - 1 if variant == "nerfpp" else b
        ext = torch.cat([torch.full((n, 1), -1.0, device=cuda), cdf[:, :n_search],
                         torch.full((n, 1), 2.0, device=cuda)], -1)
        low = torch.gather(ext, -1, inds.long())
        high = torch.gather(ext, -1, inds.long() + 1)
        assert bool(((low <= u) & (u < high)).all())
        assert torch.equal(out, _lerp_from(bins, cdf, u, inds, variant))

        twin_out, twin_inds, twin_cdf = inverse_cdf(bins, weights, u, variant)
        u_twin = torch.gather(twin_cdf, -1, picks).contiguous()
        inds = pdf_cuda.sample_pdf_fwd(bins, weights, u_twin, variant)[1]
        want = inverse_cdf(bins, weights, u_twin, variant)[1]
        off = inds != want
        first = torch.minimum(inds, want).clamp(max=b - 1).long()
        last = (torch.maximum(inds, want) - 1).clamp(0, b - 1).long()
        for j in (first, last):
            assert ((u_twin - torch.gather(twin_cdf, -1, j)).abs()[off] < 1e-6).all()

    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    @pytest.mark.parametrize("b", [2, 1024])
    def test_shortest_and_longest_rows(self, cuda, variant, b):
        """B = 2 (one weight, one searched entry for NeRF++) and B = 1024
        (32 pieces of the scan), u = 1.0 in the last column among random u,
        all-zero rows. The random columns hold to the twin. At B = 1024 the
        CDF's last entry may round a few ulps below 1; NeRF++, which does not
        search it, then carries u = 1.0 past the last edge along the last
        bin's slope, by the CDF's shortfall and no further (the twin's CDF,
        summed in another order, falls short elsewhere). Every depth is the
        lerp of its count on the kernel's own CDF, bit for bit."""
        bins, weights, u = _inputs(1027, b, 100, det=False, device=cuda)
        u[:, -1] = 1.0
        out, inds, cdf = pdf_cuda.sample_pdf_fwd(bins, weights, u, variant, with_cdf=True)
        torch.cuda.synchronize()
        want_out, _, want_cdf = inverse_cdf(bins, weights, u, variant)
        assert_resample_close(out[:, :-1], want_out[:, :-1], bins)
        torch.testing.assert_close(cdf, want_cdf, rtol=0, atol=1e-6)
        monotone = (cdf.diff(dim=-1) >= 0).all(-1)
        assert torch.equal(inds[monotone], _count_on(cdf, u, variant)[monotone])
        assert torch.equal(out, _lerp_from(bins, cdf, u, inds, variant))
        last = out[:, -1]
        assert float(last.min()) >= float(bins.min()) - 1e-5
        if variant == "nerf":
            assert float(last.max()) <= float(bins.max()) + 1e-5
        else:
            eps = 1e-6
            slope = ((bins[:, -1] - bins[:, -2] + eps)
                     / (cdf[:, -1] - cdf[:, -2]).clamp(min=eps))
            shortfall = (1.0 - cdf[:, -1]).clamp(min=0.0)
            assert bool((last - bins[:, -1] <= shortfall * slope + 1e-5).all())

    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    def test_runs_on_the_current_stream(self, cuda, variant):
        """As K1's: a side stream behind a sleep and the copy of the weights."""
        bins, weights, u = _inputs(4096, 63, 128, det=False, device=cuda)
        pending = torch.zeros_like(weights)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda._sleep(200_000_000)
            pending.copy_(weights)
            got = pdf_cuda.sample_pdf_fwd(bins, pending, u, variant, with_cdf=True)
        side.synchronize()
        want = pdf_cuda.sample_pdf_fwd(bins, weights, u, variant, with_cdf=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_another_card_current(self, cuda):
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards")
        bins, weights, u = _inputs(1027, 63, 100, det=False, device="cuda:0")
        with torch.cuda.device(1):
            out = pdf_cuda.sample_pdf_fwd(bins, weights, u, "nerfpp")[0]
        torch.cuda.synchronize(0)
        assert out.device == bins.device
        assert_resample_close(out, inverse_cdf(bins, weights, u, "nerfpp")[0], bins)

    def test_no_autograd_function_under_inference_mode(self, cuda, monkeypatch):
        """The serving path's call: one operator call, no autograd function."""
        def refuse(*args):
            raise AssertionError("entered _SamplePdfDiff under inference_mode")

        monkeypatch.setattr(pdf_cuda._SamplePdfDiff, "apply", refuse)
        bins, weights, u = _inputs(4096, 63, 128, det=True, device=cuda)
        before = pdf_cuda.diff_launches
        with torch.inference_mode():
            got = pdf_cuda.sample_pdf_diff(bins, weights, u, "nerfpp")
        torch.cuda.synchronize()
        assert pdf_cuda.diff_launches == before + 1
        assert torch.equal(got, pdf_cuda.sample_pdf_fwd(bins, weights, u, "nerfpp")[0])

    @pytest.mark.parametrize("grad_input", [0, 1, 2], ids=["bins", "weights", "u"])
    @pytest.mark.parametrize("which", ["K1", "K2"])
    def test_forward_only(self, cuda, which, grad_input):
        """The operators have no derivative: an input that requires grad
        under grad mode raises before a launch; under no_grad the depths
        have no grad_fn."""
        call = _forward_only_calls(cuda)
        before = pdf_cuda.launches + pdf_cuda.diff_launches
        with pytest.raises(ValueError, match="forward only"):
            call(which, grad_input)
        assert pdf_cuda.launches + pdf_cuda.diff_launches == before
        with torch.no_grad():
            out = call(which, grad_input)
        assert out.grad_fn is None and not out.requires_grad

    def test_nerf_variant_is_k1(self, cuda):
        """K2's NeRF instantiation computes K1's depths bit for bit."""
        bins, weights, u = _inputs(4096, 63, 64, det=False, device=cuda)
        k1 = pdf_cuda.sample_pdf_core(bins, weights, u)
        k2 = pdf_cuda.sample_pdf_fwd(bins, weights, u, "nerf")[0]
        torch.cuda.synchronize()
        assert torch.equal(k1, k2)

    @pytest.mark.parametrize("det", [True, False])
    @pytest.mark.parametrize("variant", ["nerf", "nerfpp"])
    def test_grads_match_plain_autograd(self, cuda, det, variant):
        bins, weights, u = _inputs(4096, 63, 128, det=det, device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(0)
        cot = torch.randn(u.shape, generator=gen, device=cuda)
        before = pdf_cuda.diff_launches
        got = _k2_grads(lambda b, w, uu: pdf_cuda.sample_pdf_diff(b, w, uu, variant),
                        bins, weights, u, cot)
        assert pdf_cuda.diff_launches == before + 1
        want = _k2_grads(lambda b, w, uu: sample_pdf(None, b, w, 128, u=uu, variant=variant),
                         bins, weights, u, cot)
        for g, w in zip(got, want):
            assert_grads_close(g, w)

    def test_ragged_sizes(self, cuda):
        """Ray counts off the block size, sample counts off the warp width."""
        for n, b, s in ((1, 2, 1), (5, 17, 33), (1027, 63, 100)):
            bins, weights, u = _inputs(n, b, s, det=False, device=cuda)
            out = pdf_cuda.sample_pdf_fwd(bins, weights, u, "nerfpp")[0]
            torch.cuda.synchronize()
            assert_resample_close(out, inverse_cdf(bins, weights, u, "nerfpp")[0], bins)

    def test_rejects_on_card(self, cuda):
        bins, weights, u = _inputs(64, 9, 8, det=True, device=cuda)
        with pytest.raises(ValueError, match="contiguous"):
            pdf_cuda.sample_pdf_diff(bins, torch.cat([weights, weights], -1)[:, ::2], u)
        with pytest.raises(ValueError, match="different devices"):
            pdf_cuda.sample_pdf_diff(bins, weights, u.cpu())
        with pytest.raises(ValueError, match="variant"):
            pdf_cuda.sample_pdf_fwd(bins, weights, u, "nerf++")
        with pytest.raises(TypeError, match="bins must be float32"):
            pdf_cuda.sample_pdf_fwd(bins.double(), weights, u)
        big = _inputs(4, pdf_cuda.MAX_BINS + 1, 8, det=True, device=cuda)
        with pytest.raises(ValueError, match="bins"):
            pdf_cuda.sample_pdf_fwd(*big)


@pytest.mark.cuda
class TestK4OnCard:
    @pytest.mark.parametrize("side", ["left", "right"])
    @pytest.mark.parametrize("rows,n,m,ties", [
        (8192, 63, 64, False), (4096, 63, 128, False),  # the resamplers' shapes
        (1, 1, 1, False), (5, 17, 33, False), (1027, 200, 100, False),  # ragged
        (8192, 63, 64, True), (3, 0, 5, False),
    ])
    def test_matches_plain_twin(self, cuda, side, rows, n, m, ties):
        """Exactly the twin's indices, repeated values and queries equal to
        row entries included."""
        a, v = _sorted_rows(rows, n, m, ties=ties, device=cuda)
        before = searchsorted_cuda.launches
        got = searchsorted_cuda.searchsorted_cuda(a, v, side)
        torch.cuda.synchronize()
        assert searchsorted_cuda.launches == before + 1
        assert torch.equal(got, searchsorted(a, v, side))

    def test_longest_row(self, cuda):
        a, v = _sorted_rows(3, searchsorted_cuda.MAX_ROW, 300, device=cuda)
        got = searchsorted_cuda.searchsorted_cuda(a, v, "right")
        torch.cuda.synchronize()
        assert torch.equal(got, searchsorted(a, v, "right"))
        a, v = _sorted_rows(2, searchsorted_cuda.MAX_ROW + 1, 4, device=cuda)
        with pytest.raises(ValueError, match=str(searchsorted_cuda.MAX_ROW)):
            searchsorted_cuda.searchsorted_cuda(a, v)

    def test_runs_on_the_current_stream(self, cuda):
        """Launched on a side stream behind a long sleep and a copy that
        makes the rows valid: run on any other stream, it would read the
        zeros before the copy."""
        a, v = _sorted_rows(8192, 63, 64, device=cuda)
        rows = torch.zeros_like(a)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda._sleep(200_000_000)
            rows.copy_(a)
            got = searchsorted_cuda.searchsorted_cuda(rows, v, "right")
        side.synchronize()
        assert torch.equal(got, searchsorted(a, v, "right"))

    def test_another_card_current(self, cuda):
        """Tensors on card 0 while card 1 is current: the wrapper makes card
        0 current for the launch."""
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards")
        a, v = _sorted_rows(1027, 63, 100, device="cuda:0")
        with torch.cuda.device(1):
            got = searchsorted_cuda.searchsorted_cuda(a, v, "left")
        torch.cuda.synchronize(0)
        assert torch.equal(got, searchsorted(a, v, "left"))

    def test_rejects_on_card(self, cuda):
        a, v = _sorted_rows(8, 9, 6, device=cuda)
        with pytest.raises(ValueError, match="contiguous"):
            searchsorted_cuda.searchsorted_cuda(a, torch.cat([v, v], -1)[:, ::2])
        with pytest.raises(ValueError, match="different devices"):
            searchsorted_cuda.searchsorted_cuda(a, v.cpu())


def assert_field_close(got, want):
    """3xTF32 products (about 2^-22 of each left out) and another summation
    order over K <= 320 in each of ten layers: median |err| under 1e-5, max
    under 2e-4 (tests/test_kernels.py's tolerance for the TPU kernel)."""
    err = (got - want).abs()
    assert float(err.median()) < 1e-5
    assert float(err.max()) < 2e-4


@pytest.mark.cuda
class TestK3OnCard:
    @pytest.mark.parametrize("n,s,multires,multires_views", [
        (64, 64, 10, 4), (1027, 33, 10, 4), (1, 1, 10, 4), (37, 19, 6, 2),
        (37, 19, 0, 0), (37, 19, 16, 16), (5, 7, 10, 4),
    ])
    def test_matches_plain_twin(self, cuda, n, s, multires, multires_views):
        """The twin in full float32 (TF32 off) on the same card."""
        cfg = nerf.NeRFConfig(multires=multires, multires_views=multires_views)
        params, pts, vd = _field_inputs(n, s, cfg, device=cuda)
        with fp32_inference():
            before = mlp_cuda.launches
            got = mlp_cuda.fused_query_field(params, cfg, pts, vd)
            want = mlp_cuda.fused_query_field_plain(params, cfg, pts, vd)
        torch.cuda.synchronize()
        assert mlp_cuda.launches == before + 1
        assert got.shape == (n, s, 4)
        assert_field_close(got, want)

    def test_points_far_out(self, cuda):
        """NDC-sized and larger coordinates: sin/cos of 2^9 |x| in the
        hundreds and thousands."""
        cfg = nerf.NeRFConfig()
        params, pts, vd = _field_inputs(128, 64, cfg, device=cuda)
        pts = pts * 8.0
        with fp32_inference():
            got = mlp_cuda.fused_query_field(params, cfg, pts, vd)
            want = mlp_cuda.fused_query_field_plain(params, cfg, pts, vd)
        torch.cuda.synchronize()
        assert_field_close(got, want)

    def test_ptxas_reports_no_spills(self, cuda):
        """The build's -Xptxas -v report: the kernel's registers hold its
        accumulators and fragments, nothing goes to local memory."""
        _build.load("fused_mlp")
        report = (_build.BUILD_DIR / "fused_mlp.log").read_text()
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
        assert spills and all(st == "0" and ld == "0" for st, ld in spills), report

    def test_rejects_on_card(self, cuda):
        cfg = nerf.NeRFConfig()
        params, pts, vd = _field_inputs(4, 8, cfg, device=cuda)
        with torch.no_grad():
            with pytest.raises(ValueError, match="contiguous"):
                mlp_cuda.fused_query_field(params, cfg, pts.transpose(0, 1), torch.cat([vd, vd]))
            params["feature"]["w"] = params["feature"]["w"].t().contiguous().t()
            with pytest.raises(ValueError, match="contiguous"):
                mlp_cuda.fused_query_field(params, cfg, pts, vd)
            with pytest.raises(ValueError, match="different devices"):
                mlp_cuda.fused_query_field(params, cfg, pts, vd.cpu())
