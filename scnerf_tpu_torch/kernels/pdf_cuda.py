"""K1 and K2: the inverse-CDF resampler as CUDA kernels.

- K1, :func:`sample_pdf_core`, replaces
  ``scnerf_tpu/kernels/pdf_pallas.py:sample_pdf_pallas_core``: the NeRF
  variant, forward only. Plain twin: ``sampling/pdf.py:sample_pdf(..., u=u,
  variant="nerf")``.
- K2, :func:`sample_pdf_fwd` under the autograd function
  :func:`sample_pdf_diff`, replaces ``pdf_pallas.py:_pallas_fwd`` under the
  custom VJP ``sample_pdf_pallas_diff``: either variant, and the search counts
  (and, for the backward, the CDF) besides the depths. Plain twin:
  ``sampling/pdf.py:inverse_cdf``. The backward is PyTorch ops, as JAX's is
  XLA ops: gathers, scatter-adds and a reverse cumsum.

Both kernels are instantiations of one template in ``csrc/sample_pdf.cu``
(one warp per ray; its header says what bounds it and how the design
answers). The tensor's device decides the route: a CUDA tensor always goes
to the kernel (injected ``u`` included) or raises, a CPU tensor takes the
twin. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from scnerf_tpu_torch.sampling.pdf import bracket, inverse_cdf, pdf_eps, sample_pdf

MAX_BINS = 1024
VARIANTS = ("nerf", "nerfpp")

# Kernel launches in this process, K1's and K2's; each wrapper adds one per
# launch and nowhere else, so a run can show that its main path went through
# the kernel.
launches = 0
diff_launches = 0


@functools.cache
def _entry(name: str, n_pointers: int):
    """The C entry ``name`` of ``csrc/sample_pdf.cu``: ``n_pointers`` device
    pointers, then n_rays, n_bins, n_samples and the stream."""
    from scnerf_tpu_torch.kernels import _build

    fn = getattr(_build.load("sample_pdf"), name)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sample_pdf_plain(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K1's plain PyTorch twin, on any device."""
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


def _check_cuda(name: str, bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> None:
    """What the kernels take beyond :func:`_check`; raises on the rest."""
    device = bins.device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    if not 2 <= bins.shape[1] <= MAX_BINS:
        raise ValueError(f"the kernel takes 2 <= B <= {MAX_BINS} bins, got {bins.shape[1]}")
    for arg, x in (("bins", bins), ("weights", weights), ("u", u)):
        if not x.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")


def _raise_on(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"sample_pdf kernel launch failed: CUDA error {err}")


def sample_pdf_core(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K1: NeRF inverse-CDF transform of pre-drawn ``u``.

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
    if bins.device.type == "cpu":
        return sample_pdf_plain(bins, weights, u)
    _check_cuda("sample_pdf_core", bins, weights, u)
    device = bins.device
    n, b = bins.shape
    out = torch.empty(u.shape, dtype=torch.float32, device=device)
    fn = _entry("scnerf_sample_pdf", 4)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(bins.data_ptr(), weights.data_ptr(), u.data_ptr(), out.data_ptr(),
                 n, b, u.shape[1], stream)
    _raise_on(err)
    launches += 1
    return out


def sample_pdf_fwd(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
                   variant: str = "nerfpp", *, with_cdf: bool = False):
    """K2: inverse-CDF transform of pre-drawn ``u`` with the search counts.

    Args as :func:`sample_pdf_core`, plus ``variant`` (``"nerf"`` or
    ``"nerfpp"``) and ``with_cdf``.
    Returns:
      ``(out (N, S) float32, inds (N, S) int32, cdf (N, B) float32 or
      None)``; ``cdf`` only when ``with_cdf``. On CUDA: launched on the
      current stream, not synchronised.
    """
    global diff_launches
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    _check(bins, weights, u)
    if bins.device.type == "cpu":
        out, inds, cdf = inverse_cdf(bins, weights, u, variant)
        return out, inds, cdf if with_cdf else None
    _check_cuda("sample_pdf_fwd", bins, weights, u)
    device = bins.device
    n, b = bins.shape
    out = torch.empty(u.shape, dtype=torch.float32, device=device)
    inds = torch.empty(u.shape, dtype=torch.int32, device=device)
    cdf = torch.empty((n, b), dtype=torch.float32, device=device) if with_cdf else None
    fn = _entry(f"scnerf_sample_pdf_fwd_{variant}", 6)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(bins.data_ptr(), weights.data_ptr(), u.data_ptr(), out.data_ptr(),
                 inds.data_ptr(), cdf.data_ptr() if with_cdf else None,
                 n, b, u.shape[1], stream)
    _raise_on(err)
    diff_launches += 1
    return out, inds, cdf


def sample_pdf_diff_backward(g, bins, weights, u, inds, cdf, variant: str):
    """Gradients of ``out`` into ``(bins, weights, u)`` for the cotangent
    ``g``; port of ``pdf_pallas.py:_diff_bwd``.

    ``cdf`` must be the forward's own CDF: near the guard (``denom`` within
    rounding of eps) a CDF that rounds differently would take the other
    branch than the forward did. The gathers' transposes are scatter-adds;
    guarded denominators pass no gradient, as ``torch.where`` passes none.
    """
    eps = pdf_eps(variant)
    below, above = bracket(inds, bins.shape[-1], variant)
    w = weights + eps
    wsum = torch.sum(w, dim=-1, keepdim=True)
    pdf = w / wsum

    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom_raw = cdf_a - cdf_b
    guard = (denom_raw >= eps).to(bins.dtype)
    denom = torch.where(denom_raw < eps, torch.ones_like(denom_raw), denom_raw)
    t = (u - cdf_b) / denom
    width = bins_a - bins_b
    if variant == "nerfpp":
        width = width + eps

    # out = bins_b + t * width, t = (u - cdf_b) / denom,
    # denom = where(guard, cdf_a - cdf_b, 1)
    g_t = g * width
    g_u = g_t / denom
    g_cdf_b = g_t * (-1.0 / denom + guard * t / denom)
    g_cdf_a = g_t * (-guard * t / denom)
    g_bins = (torch.zeros_like(bins).scatter_add_(-1, below, g * (1.0 - t))
              .scatter_add_(-1, above, g * t))
    g_cdf = (torch.zeros_like(cdf).scatter_add_(-1, below, g_cdf_b)
             .scatter_add_(-1, above, g_cdf_a))
    # cdf = [0, cumsum(pdf)]: g_pdf is the reverse cumsum of g_cdf[..., 1:].
    g_pdf = torch.flip(torch.cumsum(torch.flip(g_cdf[..., 1:], [-1]), -1), [-1])
    # pdf = w / sum(w): g_w = (g_pdf - <g_pdf, pdf>) / sum(w).
    g_w = (g_pdf - torch.sum(g_pdf * pdf, dim=-1, keepdim=True)) / wsum
    return g_bins, g_w, g_u


class _SamplePdfDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bins, weights, u, variant):
        want_grad = any(ctx.needs_input_grad[:3])
        out, inds, cdf = sample_pdf_fwd(bins, weights, u, variant, with_cdf=want_grad)
        ctx.variant = variant
        if want_grad:
            ctx.save_for_backward(bins, weights, u, inds, cdf)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        bins, weights, u, inds, cdf = ctx.saved_tensors
        grads = sample_pdf_diff_backward(g, bins, weights, u, inds, cdf, ctx.variant)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad[:3])), None)


def sample_pdf_diff(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
                    variant: str = "nerfpp") -> torch.Tensor:
    """Differentiable inverse CDF: K2's forward (the plain twin on the CPU)
    and :func:`sample_pdf_diff_backward`. Values and gradients equal
    ``sampling/pdf.py:sample_pdf(..., u=u, variant=variant)`` up to the
    rounding of the CDF. ``(N, S)`` depths."""
    return _SamplePdfDiff.apply(bins, weights, u, variant)
