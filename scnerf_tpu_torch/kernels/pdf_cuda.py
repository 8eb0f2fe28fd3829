"""K1: the NeRF inverse-CDF resampler as a CUDA kernel.

Replaces ``scnerf_tpu/kernels/pdf_pallas.py:sample_pdf_pallas_core``. The
kernel is ``csrc/sample_pdf.cu`` (one warp per ray; its header says what
bounds it and how the design answers); the plain twin is
``sampling/pdf.py:sample_pdf(..., u=u, variant="nerf")``.

The tensor's device decides the route: a CUDA tensor always goes to the
kernel (injected ``u`` included) or raises, a CPU tensor takes the twin.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from scnerf_tpu_torch.sampling.pdf import sample_pdf

MAX_BINS = 1024

# Kernel launches in this process; the wrapper adds one per launch and
# nowhere else, so a run can show that its main path went through the kernel.
launches = 0


@functools.cache
def _library():
    from scnerf_tpu_torch.kernels import _build

    lib = _build.load("sample_pdf")
    fn = lib.scnerf_sample_pdf
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sample_pdf_plain(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch twin, on any device."""
    return sample_pdf(None, bins, weights, u.shape[-1], u=u, variant="nerf")


def _check(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> None:
    if bins.ndim != 2 or weights.ndim != 2 or u.ndim != 2:
        raise ValueError(
            f"expected 2D bins, weights, u; got {tuple(bins.shape)}, "
            f"{tuple(weights.shape)}, {tuple(u.shape)}")
    n, b = bins.shape
    if weights.shape != (n, b - 1) or u.shape[0] != n:
        raise ValueError(
            f"shapes disagree: bins {tuple(bins.shape)} needs weights "
            f"{(n, b - 1)} and u ({n}, S); got {tuple(weights.shape)}, "
            f"{tuple(u.shape)}")
    for name, x in (("bins", bins), ("weights", weights), ("u", u)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    devices = {bins.device, weights.device, u.device}
    if len(devices) != 1:
        raise ValueError(f"bins, weights and u lie on different devices: {devices}")


def sample_pdf_core(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF transform of pre-drawn ``u``.

    Args:
      bins: ``(N, B)`` float32 bin edges.
      weights: ``(N, B-1)`` float32 unnormalised weights.
      u: ``(N, S)`` float32 uniforms.
    Returns:
      ``(N, S)`` depths. On CUDA: launched on the current stream, not
      synchronised; inputs must be contiguous and ``2 <= B <= 1024``.
    """
    global launches
    _check(bins, weights, u)
    device = bins.device
    if device.type == "cpu":
        return sample_pdf_plain(bins, weights, u)
    if device.type != "cuda":
        raise ValueError(f"sample_pdf_core runs on cpu or cuda, not {device}")
    n, b = bins.shape
    if not 2 <= b <= MAX_BINS:
        raise ValueError(f"the kernel takes 2 <= B <= {MAX_BINS} bins, got {b}")
    for name, x in (("bins", bins), ("weights", weights), ("u", u)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(u.shape, dtype=torch.float32, device=device)
    fn = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(bins.data_ptr(), weights.data_ptr(), u.data_ptr(), out.data_ptr(),
                 n, b, u.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"sample_pdf kernel launch failed: CUDA error {err}")
    launches += 1
    return out
