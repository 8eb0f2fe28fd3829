"""NeRF++ cascaded renderer.

Port of ``scnerf_tpu/render/nerfpp_renderer.py``. Level 0 samples uniformly
(fg: linear in depth from ``min_depth`` to the unit-sphere exit; bg: linear
in inverse depth on [0, 1]); each later level resamples both from the
previous level's weights with the NeRF++ inverse CDF and sort-merges the new
depths with the previous ones.

Resampling goes through the K2 wrapper (``kernels/pdf_cuda.py:
sample_pdf_diff``), which launches the CUDA kernel for tensors on the card
and runs its plain twin for tensors on the CPU, whatever ``pdf_impl`` says:
the name picks an implementation of one function in the JAX package, and
the device picks it here. ``"pallas_stopgrad"`` detaches the bins first. It
runs the NeRF++ variant, like every other name; the JAX package's TPU branch
for that name runs the NeRF variant by mistake.
"""
from __future__ import annotations

import dataclasses

import torch

from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, nerfpp_forward
from scnerf_tpu_torch.geometry.sphere import intersect_sphere
from scnerf_tpu_torch.kernels.pdf_cuda import sample_pdf_diff
from scnerf_tpu_torch.render.renderer import pad_edge
from scnerf_tpu_torch.sampling.pdf import pdf_uniforms
from scnerf_tpu_torch.sampling.stratified import perturb_z_vals

PDF_IMPLS = ("xla", "pallas_vjp", "pallas_stopgrad")
LAST_LEVEL_MAPS = ("rgb", "fg_rgb", "bg_rgb", "fg_depth", "bg_depth", "bg_lambda")


@dataclasses.dataclass(frozen=True)
class NerfPPRenderConfig:
    cascade_samples: tuple = (64, 64)
    perturb: bool = True
    chunk: int = 4096  # render_chunked_nerfpp's rays per chunk
    pdf_impl: str = "xla"  # one of PDF_IMPLS; see the module docstring


def _resample(render_cfg: NerfPPRenderConfig, generator, depth, weights, n_samp, u):
    """New depths from ``weights (N, S)`` over the midpoints of ``depth``,
    merged with ``depth`` in ascending order -> ``(N, S + n_samp)``."""
    # Resampling takes no gradient through the weights; the kernel wants
    # contiguous rows, and weights[..., 1:-1] and the midpoints are views.
    w = weights.detach()[..., 1:-1].contiguous()
    mid = (0.5 * (depth[..., 1:] + depth[..., :-1])).contiguous()
    if render_cfg.pdf_impl == "pallas_stopgrad":
        mid = mid.detach()
    if u is None:
        u = pdf_uniforms(generator, depth.shape[0], n_samp, det=not render_cfg.perturb,
                         device=depth.device)
    new = sample_pdf_diff(mid, w, u.contiguous(), "nerfpp")
    return torch.sort(torch.cat([depth, new], dim=-1), dim=-1).values


def render_rays_nerfpp(
    level_params: list,
    model_cfg: NerfPPConfig,
    render_cfg: NerfPPRenderConfig,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    min_depth: torch.Tensor,
    generator: torch.Generator | None = None,
    rands: list | None = None,
) -> list[dict[str, torch.Tensor]]:
    """Run every cascade level; returns the per-level outputs of
    :func:`nerfpp_forward`.

    Args:
      level_params: one ``{"fg", "bg"}`` param dict per cascade level.
      ray_o, ray_d: ``(N, 3)``.
      min_depth: ``(N,)`` fg near depths.
      generator: the random draws' source (on the rays' device); unused in
        eval mode and for the draws ``rands`` covers.
      rands: optional injected uniforms, as in the JAX package: one
        ``(fg, bg)`` pair per level, the jitter ``t_rand`` ``(N, S_0)`` at
        level 0 (applied even when ``perturb`` is off) and the inverse-CDF
        ``u`` ``(N, S_m)`` at the later levels.
    """
    if render_cfg.pdf_impl not in PDF_IMPLS:
        raise ValueError(f"pdf_impl must be one of {PDF_IMPLS}, got {render_cfg.pdf_impl!r}")
    n = ray_o.shape[0]
    fg_far = intersect_sphere(ray_o, ray_d)  # (N,)
    outs = []
    fg_depth = bg_depth = ret = None
    for m, n_samp in enumerate(render_cfg.cascade_samples):
        r_fg, r_bg = rands[m] if rands is not None else (None, None)
        if m == 0:
            t = torch.linspace(0.0, 1.0, n_samp, device=ray_o.device)
            fg_depth = min_depth[..., None] * (1.0 - t) + fg_far[..., None] * t
            bg_depth = t.expand(n, n_samp)
            if render_cfg.perturb or r_fg is not None:
                fg_depth = perturb_z_vals(generator, fg_depth, t_rand=r_fg)
                bg_depth = perturb_z_vals(generator, bg_depth, t_rand=r_bg)
        else:
            fg_depth = _resample(render_cfg, generator, fg_depth, ret["fg_weights"],
                                 n_samp, r_fg)
            bg_depth = _resample(render_cfg, generator, bg_depth, ret["bg_weights"],
                                 n_samp, r_bg)
        ret = nerfpp_forward(level_params[m], model_cfg, ray_o, ray_d, fg_far,
                             fg_depth, bg_depth)
        outs.append(ret)
    return outs


def render_chunked_nerfpp(
    level_params: list,
    model_cfg: NerfPPConfig,
    render_cfg: NerfPPRenderConfig,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    min_depth: torch.Tensor,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Render any number of rays in edge-padded chunks of
    ``render_cfg.chunk`` under ``torch.inference_mode()``; returns the last
    level's maps (:data:`LAST_LEVEL_MAPS`)."""
    n = ray_o.shape[0]
    chunk = min(render_cfg.chunk, n) if n > 0 else render_cfg.chunk
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    ro, rd, md = (pad_edge(x, pad) for x in (ray_o, ray_d, min_depth))
    outs = []
    with torch.inference_mode():
        for i in range(n_chunks):
            c = slice(i * chunk, (i + 1) * chunk)
            last = render_rays_nerfpp(level_params, model_cfg, render_cfg,
                                      ro[c], rd[c], md[c], generator)[-1]
            outs.append({k: last[k] for k in LAST_LEVEL_MAPS})
    return {k: torch.cat([o[k] for o in outs])[:n] for k in LAST_LEVEL_MAPS}
