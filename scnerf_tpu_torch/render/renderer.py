"""Coarse-to-fine volume renderer (NeRF pipeline).

Port of ``scnerf_tpu/render/renderer.py``: :func:`render_rays` renders one
batch of rays through the coarse and fine MLPs, resampling the fine depths
with the K1 wrapper (``kernels/pdf_cuda.py``), which launches the CUDA kernel
for tensors on the card and runs its plain twin for tensors on the CPU.
:func:`render_chunked` renders any number of rays as a Python loop over
edge-padded chunks under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from scnerf_tpu_torch.fields.nerf import NeRFConfig, query_field
from scnerf_tpu_torch.kernels.pdf_cuda import sample_pdf_core
from scnerf_tpu_torch.render.composite import raw2outputs
from scnerf_tpu_torch.sampling.pdf import pdf_uniforms
from scnerf_tpu_torch.sampling.stratified import stratified_z_vals
from scnerf_tpu_torch.serve import pad_edge


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
    *,
    query: Callable | None = None,
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
      query: the field, ``query(mlp_params, model_cfg, pts, viewdirs) ->
        raw (N, S, 4)``, called with ``params["coarse"]`` and then the fine
        MLP's; ``query_field`` where not given (the NeRF serve function
        routes it to K3).
    Returns:
      dict: rgb, disp, acc, depth (+ rgb0/disp0/acc0/z_std when fine active).
    """
    n = rays_o.shape[0]
    device = rays_o.device
    rands = rands or {}
    query = query or query_field
    near = _per_ray(near, n, device)
    far = _per_ray(far, n, device)

    z_vals = stratified_z_vals(
        generator, near, far, render_cfg.n_samples,
        lindisp=render_cfg.lindisp, perturb=render_cfg.perturb,
        t_rand=rands.get("t"),
    )
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = query(params["coarse"], model_cfg, pts, viewdirs)
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
        z_samples = sample_pdf_core(z_mid, w_mid, u.contiguous())
        z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
        fine_params = params.get("fine") or params["coarse"]
        raw = query(fine_params, model_cfg, pts, viewdirs)
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


def render_chunked(
    params: dict,
    model_cfg: NeRFConfig,
    render_cfg: RenderConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor | None,
    near,
    far,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Render any number of rays in chunks of ``render_cfg.chunk``.

    The ray count is edge-padded to a multiple of the chunk, every chunk is
    rendered by :func:`render_rays`, and the padding is cut off again.
    """
    n = rays_o.shape[0]
    device = rays_o.device
    chunk = min(render_cfg.chunk, n) if n > 0 else render_cfg.chunk
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    ro = pad_edge(rays_o, pad)
    rd = pad_edge(rays_d, pad)
    vd = pad_edge(viewdirs, pad) if viewdirs is not None else None
    nr = pad_edge(_per_ray(near, n, device), pad)
    fr = pad_edge(_per_ray(far, n, device), pad)

    outs = []
    with torch.inference_mode():
        for i in range(n_chunks):
            c = slice(i * chunk, (i + 1) * chunk)
            outs.append(render_rays(
                params, model_cfg, render_cfg, ro[c], rd[c],
                vd[c] if vd is not None else None, nr[c], fr[c], generator,
            ))
    return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}
