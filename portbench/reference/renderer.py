"""Frozen copy of ``scnerf_tpu_torch/render/renderer.py``'s ``render_rays``
(the benchmark's plain reference): the coarse and fine cascade of the NeRF
pipeline, with the fine depths resampled by the plain inverse CDF
(``pdf.sample_pdf``) in place of K1. Random draws are taken from
``generator`` in the order the port takes them.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.reference.nerf import NeRFConfig, query_field
from portbench.reference.composite import raw2outputs
from portbench.reference.pdf import pdf_uniforms, sample_pdf
from portbench.reference.stratified import stratified_z_vals


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_samples: int = 64
    n_importance: int = 64
    perturb: bool = True
    lindisp: bool = False
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    use_viewdirs: bool = True
    near: float = 0.0
    far: float = 1.0
    chunk: int = 8192  # render_chunked's rays per chunk

    def eval_mode(self) -> "RenderConfig":
        """Test-time overrides: no jitter, no sigma noise."""
        return dataclasses.replace(self, perturb=False, raw_noise_std=0.0)


def _per_ray(x, n: int, device) -> torch.Tensor:
    if isinstance(x, (int, float)):  # filled on the device: no copy to wait for
        return torch.full((n,), float(x), device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n)


def render_rays(
    params: dict,
    model_cfg: NeRFConfig,
    render_cfg: RenderConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor | None,
    near,
    far,
    generator: torch.Generator | None = None,
    rands: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Render a batch of rays with the coarse(+fine) cascade.

    Args:
      params: ``{"coarse": mlp_params, "fine": mlp_params | None}``.
      rays_o, rays_d: ``(N, 3)`` (possibly NDC-warped).
      viewdirs: ``(N, 3)`` unit world-space view directions or None.
      near, far: scalars or ``(N,)``.
      generator: the random draws' source (on the rays' device); unused in
        eval mode.
      rands: optional injected randoms, as in the JAX package: ``t`` (N, S)
        jitter uniforms, ``noise0`` (N, S) and ``noise1`` (N, S+S_imp)
        standard normals, ``u`` (N, S_imp) inverse-CDF uniforms.
    Returns:
      dict: rgb, disp, acc, depth (+ rgb0/disp0/acc0/z_std when fine active).
    """
    n = rays_o.shape[0]
    device = rays_o.device
    rands = rands or {}
    near = _per_ray(near, n, device)
    far = _per_ray(far, n, device)

    z_vals = stratified_z_vals(
        generator, near, far, render_cfg.n_samples,
        lindisp=render_cfg.lindisp, perturb=render_cfg.perturb,
        t_rand=rands.get("t"),
    )
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = query_field(params["coarse"], model_cfg, pts, viewdirs)
    coarse = raw2outputs(
        raw, z_vals, rays_d,
        raw_noise_std=render_cfg.raw_noise_std,
        white_bkgd=render_cfg.white_bkgd,
        generator=generator,
        noise=rands.get("noise0"),
    )
    out = {k: coarse[k] for k in ("rgb", "disp", "acc", "depth")}
    if render_cfg.n_importance > 0:
        # Resampling takes no gradient; the kernel wants contiguous rows,
        # and weights[..., 1:-1] is a strided view.
        z_mid = (0.5 * (z_vals[..., 1:] + z_vals[..., :-1])).detach().contiguous()
        w_mid = coarse["weights"][..., 1:-1].detach().contiguous()
        u = rands.get("u")
        if u is None:
            u = pdf_uniforms(generator, n, render_cfg.n_importance,
                             det=not render_cfg.perturb, device=device)
        z_samples = sample_pdf(None, z_mid, w_mid, u.shape[-1], u=u, variant="nerf")
        z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
        fine_params = params.get("fine") or params["coarse"]
        raw = query_field(fine_params, model_cfg, pts, viewdirs)
        fine = raw2outputs(
            raw, z_all, rays_d,
            raw_noise_std=render_cfg.raw_noise_std,
            white_bkgd=render_cfg.white_bkgd,
            generator=generator,
            noise=rands.get("noise1"),
        )
        out.update(
            rgb=fine["rgb"], disp=fine["disp"], acc=fine["acc"], depth=fine["depth"],
            rgb0=coarse["rgb"], disp0=coarse["disp"], acc0=coarse["acc"],
            # ddof 0, as jnp.std
            z_std=torch.std(z_samples, dim=-1, correction=0),
        )
    return out
