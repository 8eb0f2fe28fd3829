"""Hierarchical inverse-CDF resampling (NeRF "fine" sampling).

Port of ``scnerf_tpu/sampling/pdf.py:sample_pdf``, both variants, with
``u=`` injection. This is the plain twin of the K1 CUDA kernel
(``kernels/pdf_cuda.py``): the kernel's wrapper runs it for tensors on the
CPU, and the tests and ``chip_smoke.py`` hold the kernel against it.
Gathers are ``torch.gather``; the JAX package's one-hot contractions were a
TPU workaround.
"""
from __future__ import annotations

import torch

from scnerf_tpu_torch.sampling.searchsorted import searchsorted


def pdf_uniforms(generator: torch.Generator | None, n_rays: int, n_samples: int,
                 det: bool, *, device: torch.device | str) -> torch.Tensor:
    """The ``(n_rays, n_samples)`` uniforms of the inverse CDF: evenly spaced
    in ``[0, 1]`` when ``det``, else drawn from ``generator`` (which must live
    on ``device``). Contiguous, as the kernel takes it."""
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, device=device)
        return u.expand(n_rays, n_samples).contiguous()
    return torch.rand((n_rays, n_samples), generator=generator, device=device)


def sample_pdf(
    generator: torch.Generator | None,
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    u: torch.Tensor | None = None,
    variant: str = "nerf",
) -> torch.Tensor:
    """Draw ``n_samples`` depths per ray from the piecewise-constant PDF
    defined by ``weights`` over ``bins``.

    Args:
      generator: used only when neither ``det`` nor ``u`` is given.
      bins: ``(N, B)`` bin edges.
      weights: ``(N, B-1)`` unnormalised interval weights.
      det: evenly spaced ``u`` instead of uniform random.
      u: optional injected ``(N, n_samples)`` uniforms; overrides ``det``.
      variant: ``"nerf"`` (eps 1e-5, search over the full CDF) or
        ``"nerfpp"`` (eps 1e-6, search over the first B-1 CDF entries, bin
        width widened by eps).
    Returns:
      ``(N, n_samples)`` depths (not detached).
    """
    eps = 1e-6 if variant == "nerfpp" else 1e-5
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (N, B)

    if u is None:
        u = pdf_uniforms(generator, cdf.shape[0], n_samples, det, device=cdf.device)

    if variant == "nerfpp":
        above = torch.clamp(searchsorted(cdf[..., :-1], u, side="right"), min=1)
        below = above - 1
    else:
        inds = searchsorted(cdf, u, side="right")
        below = torch.clamp(inds - 1, min=0)
        above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    below = below.long()
    above = above.long()

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    width = bins_above - bins_below
    if variant == "nerfpp":
        width = width + eps
    return bins_below + t * width
