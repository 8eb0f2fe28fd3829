"""The K1 wrapper (``scnerf_tpu_torch/kernels/pdf_cuda.py``) and its build.

On the CPU the wrapper takes the plain twin and launches nothing. The tests
marked ``cuda`` hold the CUDA kernel against the twin on the card; they skip
without one. This file needs no JAX, so the card's machine runs it with
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from scnerf_tpu_torch.kernels import _build, pdf_cuda
from scnerf_tpu_torch.sampling.pdf import pdf_uniforms

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


def test_package_imports_no_jax():
    """Every module of the port imports, in a fresh interpreter, without
    pulling in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import scnerf_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'scnerf_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'scnerf_tpu.')) or m == 'scnerf_tpu')\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
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
    @pytest.mark.parametrize("b", [63, 62, 64, 2, 200])
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
