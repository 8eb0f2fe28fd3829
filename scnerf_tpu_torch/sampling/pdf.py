"""Hierarchical inverse-CDF resampling (NeRF "fine" sampling).

Port of ``scnerf_tpu/sampling/pdf.py:sample_pdf``, both variants, with
``u=`` injection. This is the plain twin of the K1 and K2 CUDA kernels
(``kernels/pdf_cuda.py``): their wrappers run it for tensors on the CPU, and
the tests and ``chip_smoke.py`` hold the kernels against it.
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


def pdf_eps(variant: str) -> float:
    """The variant's eps: added to the weights and the denominator guard."""
    if variant not in ("nerf", "nerfpp"):
        raise ValueError(f"variant must be nerf or nerfpp, got {variant!r}")
    return 1e-6 if variant == "nerfpp" else 1e-5


def bracket(inds: torch.Tensor, n_bins: int, variant: str):
    """The bracketing CDF indices ``(below, above)`` (int64) of the search
    counts ``inds``: NeRF clamps ``inds - 1`` and ``inds`` into ``[0, B-1]``;
    NeRF++ takes ``above = max(inds, 1)``, ``below = above - 1``."""
    inds = inds.long()
    if variant == "nerfpp":
        above = torch.clamp(inds, min=1)
        return above - 1, above
    return torch.clamp(inds - 1, min=0), torch.clamp(inds, max=n_bins - 1)


def inverse_cdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
                variant: str = "nerf"):
    """Inverse-CDF transform of given ``u``, with what a backward needs.

    Args:
      bins: ``(N, B)`` bin edges.
      weights: ``(N, B-1)`` unnormalised interval weights.
      u: ``(N, S)`` uniforms.
      variant: ``"nerf"`` (eps 1e-5, search over the full CDF) or
        ``"nerfpp"`` (eps 1e-6, search over the first B-1 CDF entries, bin
        width widened by eps).
    Returns:
      ``(out (N, S), inds (N, S) int32, cdf (N, B))``: the depths, the
      search counts ``#{j : u >= cdf[j]}`` over the searched entries, and
      ``cdf = [0, cumsum(pdf)]``.
    """
    eps = pdf_eps(variant)
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (N, B)

    searched = cdf[..., :-1] if variant == "nerfpp" else cdf
    inds = searchsorted(searched, u, side="right")
    below, above = bracket(inds, cdf.shape[-1], variant)

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
    return bins_below + t * width, inds, cdf


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
      variant: ``"nerf"`` or ``"nerfpp"``, as in :func:`inverse_cdf`.
    Returns:
      ``(N, n_samples)`` depths (not detached).
    """
    if u is None:
        u = pdf_uniforms(generator, bins.shape[0], n_samples, det, device=bins.device)
    return inverse_cdf(bins, weights, u, variant)[0]
