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

A NeRF++ train step (``train/nerfpp_step.py``, through
``render/nerfpp_renderer.py``) calls K2 twice per later cascade level: the
fg resample through the autograd function, which saves the CDF (its bins
come from the rays and require grad), and the bg resample forward only,
without a CDF (its bins are uniforms that never require grad, and the
weights are detached); the fg's backward runs once, in the span
``"scnerf.kernels.sample_pdf_diff_backward"`` (``train/profiling.py``).
``diff_launches`` counts both launches, ``cdf_launches`` the ones that saved
the CDF.

Both kernels are instantiations of one template in ``csrc/sample_pdf.cu``
(one warp per ray, a binary search over the CDF; its header says what bounds
it and how the design answers), built into a plain-C library and launched
through registered PyTorch operators, as K3 is (``mlp_cuda.py``). Their
schemas, fake (shape-only) implementations and CUDA implementations are
defined here, at import, so that ``torch.export`` and ``meta`` tensors can
trace them anywhere and a loaded program that calls them needs only this
module: each CUDA implementation checks its operands
(:func:`_check_operands`), allocates the outputs and launches the library's
entry on the current stream through ctypes (``_build.launch``); the library
is built and loaded at the first launch. No CPU implementation is
registered. The tensor's device decides the route: a CUDA tensor always
goes to the operator (injected ``u`` included) or raises, a CPU tensor takes
the twin after the same checks. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from scnerf_tpu_torch.kernels import _build
from scnerf_tpu_torch.sampling.pdf import bracket, inverse_cdf, pdf_eps, sample_pdf
from scnerf_tpu_torch.train.profiling import span

MAX_BINS = 1024
VARIANTS = ("nerf", "nerfpp")

# Kernel launches in this process, K1's and K2's; the operators' CUDA
# implementations add one per launch and nowhere else, so a run can show that
# its main path went through the kernel, launches inside a loaded serving
# artifact included.
launches = 0
diff_launches = 0
cdf_launches = 0  # the K2 launches that wrote the CDF (a part of diff_launches)

# The operators' schemas; ``mlp_cuda.py`` adds K3's to the namespace.
OPS_NAMESPACE = "scnerf_tpu_torch"
_LIB = torch.library.Library(OPS_NAMESPACE, "DEF")
_LIB.define("sample_pdf(Tensor bins, Tensor weights, Tensor u) -> Tensor")
_LIB.define("sample_pdf_fwd(Tensor bins, Tensor weights, Tensor u, str variant, "
            "bool with_cdf) -> (Tensor, Tensor, Tensor?)")


@torch.library.register_fake(f"{OPS_NAMESPACE}::sample_pdf", lib=_LIB)
def _sample_pdf_fake(bins, weights, u):
    return torch.empty_like(u)


@torch.library.register_fake(f"{OPS_NAMESPACE}::sample_pdf_fwd", lib=_LIB)
def _sample_pdf_fwd_fake(bins, weights, u, variant, with_cdf):
    cdf = torch.empty_like(bins) if with_cdf else None
    return torch.empty_like(u), torch.empty_like(u, dtype=torch.int32), cdf


@functools.cache
def _entry(name: str):
    """``csrc/sample_pdf.cu``'s entry ``name``: ``scnerf_sample_pdf(bins,
    weights, u, out, n_rays, n_bins, n_samples, stream)`` (K1), or
    ``scnerf_sample_pdf_fwd_<variant>(bins, weights, u, out, inds, cdf,
    n_rays, n_bins, n_samples, stream)`` (K2)."""
    fn = getattr(_build.load("sample_pdf"), name)
    pointers = 4 if name == "scnerf_sample_pdf" else 6
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sample_pdf_cuda(bins, weights, u):
    """K1's operator on the card: the kernel launched on the current stream,
    not synchronised, after the checks (every route, a loaded artifact's
    included, passes through)."""
    global launches
    _check_operands("sample_pdf_core", bins, weights, u)
    out = torch.empty_like(u)
    (n, b), s = bins.shape, u.shape[1]
    err = _build.launch(_entry("scnerf_sample_pdf"), bins.get_device(), bins.data_ptr(),
                        weights.data_ptr(), u.data_ptr(), out.data_ptr(), n, b, s)
    if err != 0:
        raise RuntimeError(f"sample_pdf kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _sample_pdf_fwd_cuda(bins, weights, u, variant, with_cdf):
    """K2's operator on the card, as K1's; ``inds`` always, ``cdf`` only
    when ``with_cdf``."""
    global diff_launches, cdf_launches
    _check_variant(variant)
    _check_operands("sample_pdf_fwd", bins, weights, u)
    out = torch.empty_like(u)
    inds = torch.empty_like(u, dtype=torch.int32)
    cdf = torch.empty_like(bins) if with_cdf else None
    (n, b), s = bins.shape, u.shape[1]
    err = _build.launch(_entry(f"scnerf_sample_pdf_fwd_{variant}"), bins.get_device(),
                        bins.data_ptr(), weights.data_ptr(), u.data_ptr(), out.data_ptr(),
                        inds.data_ptr(), None if cdf is None else cdf.data_ptr(), n, b, s)
    if err != 0:
        raise RuntimeError(f"sample_pdf_fwd kernel launch failed: CUDA error {err}")
    diff_launches += 1
    cdf_launches += with_cdf
    return out, inds, cdf


_LIB.impl("sample_pdf", _sample_pdf_cuda, "CUDA")
_LIB.impl("sample_pdf_fwd", _sample_pdf_fwd_cuda, "CUDA")


def sample_pdf_plain(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K1's plain PyTorch twin, on any device."""
    return sample_pdf(None, bins, weights, u.shape[-1], u=u, variant="nerf")


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def _check_operands(name: str, bins: torch.Tensor, weights: torch.Tensor,
                    u: torch.Tensor) -> None:
    """Raise on operands K1 or K2 (``name``'s) does not take, on either
    route: not 2-D, shapes that disagree, not float32, not all on one CPU or
    CUDA device; on the card also what the kernel does not take: ``B``
    outside ``[2, MAX_BINS]``, an operand not contiguous, 2^30 rays or more
    or 2^31 samples or more."""
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
    for arg, x in (("bins", bins), ("weights", weights), ("u", u)):
        if x.dtype != torch.float32:
            raise TypeError(f"{arg} must be float32, got {x.dtype}")
    devices = {bins.device, weights.device, u.device}
    if len(devices) != 1:
        raise ValueError(f"bins, weights and u lie on different devices: {devices}")
    if bins.device.type == "cpu":
        return
    if bins.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {bins.device}")
    if not 2 <= b <= MAX_BINS:
        raise ValueError(f"the kernel takes 2 <= B <= {MAX_BINS} bins, got {b}")
    for arg, x in (("bins", bins), ("weights", weights), ("u", u)):
        if not x.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    if n > 2**30 - 1 or u.shape[1] > 2**31 - 1:
        raise ValueError(f"the kernel takes fewer than 2^30 rays and 2^31 samples, got {n} "
                         f"and {u.shape[1]}")


def _forward_only(name: str, bins: torch.Tensor, weights: torch.Tensor,
                  u: torch.Tensor) -> None:
    """K1 and K2's forward have no derivative on either device: refuse an
    input that requires grad under grad mode, rather than return depths
    whose backward passes nothing. :func:`sample_pdf_diff` is the
    differentiable route."""
    if torch.is_grad_enabled() and (bins.requires_grad or weights.requires_grad
                                    or u.requires_grad):
        raise ValueError(f"{name} is forward only; call it under torch.no_grad(), "
                         "or call sample_pdf_diff for gradients")


def sample_pdf_core(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K1: NeRF inverse-CDF transform of pre-drawn ``u``.

    Args:
      bins: ``(N, B)`` float32 bin edges.
      weights: ``(N, B-1)`` float32 unnormalised weights, ``>= 0``.
      u: ``(N, S)`` float32 uniforms.
    Returns:
      ``(N, S)`` depths. On CUDA: ``torch.ops.scnerf_tpu_torch.sample_pdf``,
      launched on the current stream, not synchronised; inputs must be
      contiguous and ``2 <= B <= 1024``. Forward only: an input that
      requires grad under grad mode raises ``ValueError``.
    """
    _forward_only("sample_pdf_core", bins, weights, u)
    if not bins.is_cuda:
        _check_operands("sample_pdf_core", bins, weights, u)
        return sample_pdf_plain(bins, weights, u)
    return torch.ops.scnerf_tpu_torch.sample_pdf.default(bins, weights, u)


def sample_pdf_fwd(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
                   variant: str = "nerfpp", *, with_cdf: bool = False):
    """K2: inverse-CDF transform of pre-drawn ``u`` with the search counts.

    Args as :func:`sample_pdf_core`, plus ``variant`` (``"nerf"`` or
    ``"nerfpp"``) and ``with_cdf``.
    Returns:
      ``(out (N, S) float32, inds (N, S) int32, cdf (N, B) float32 or
      None)``; ``cdf`` only when ``with_cdf``. On CUDA:
      ``torch.ops.scnerf_tpu_torch.sample_pdf_fwd``, launched on the current
      stream, not synchronised. Forward only, as :func:`sample_pdf_core`.
    """
    _forward_only("sample_pdf_fwd", bins, weights, u)
    if not bins.is_cuda:
        _check_variant(variant)
        _check_operands("sample_pdf_fwd", bins, weights, u)
        out, inds, cdf = inverse_cdf(bins, weights, u, variant)
        return out, inds, cdf if with_cdf else None
    return torch.ops.scnerf_tpu_torch.sample_pdf_fwd.default(bins, weights, u, variant, with_cdf)


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
        with span("scnerf.kernels.sample_pdf_diff_backward"):
            grads = sample_pdf_diff_backward(g, bins, weights, u, inds, cdf, ctx.variant)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad[:3])), None)


def sample_pdf_diff(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
                    variant: str = "nerfpp") -> torch.Tensor:
    """Differentiable inverse CDF: K2's forward (the plain twin on the CPU)
    and :func:`sample_pdf_diff_backward`. Values and gradients equal
    ``sampling/pdf.py:sample_pdf(..., u=u, variant=variant)`` up to the
    rounding of the CDF. ``(N, S)`` depths. Where no gradient can be asked
    for (grad mode off, as under ``inference_mode``, or no input requiring
    grad) it calls the forward alone, without the autograd function."""
    if torch.is_grad_enabled() and (bins.requires_grad or weights.requires_grad
                                    or u.requires_grad):
        return _SamplePdfDiff.apply(bins, weights, u, variant)
    return sample_pdf_fwd(bins, weights, u, variant)[0]
