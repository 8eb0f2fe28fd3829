"""Serving: a fixed-batch render function and a service that pads requests
onto it.

Port of ``scnerf_tpu/serve.py``'s ``make_nerf_serve_fn`` and
``RenderService``, for one device. The serve function bakes in the eval-path
semantics: viewdirs from the world rays, the optional NDC warp with the
learned focal (near/far then 0/1), eval-mode rendering (deterministic
resampling, no jitter, no sigma noise) and the rgb clamp at 1.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from scnerf_tpu_torch.geometry.ndc import ndc_rays
from scnerf_tpu_torch.render.renderer import pad_edge, render_rays


def make_nerf_serve_fn(
    params: dict,
    model_cfg,
    render_cfg,
    *,
    ndc: tuple | None = None,
    outputs: Sequence[str] = ("rgb", "depth", "acc", "disp"),
) -> Callable:
    """Build ``fn(rays_o, rays_d, near, far) -> {maps}``.

    Args:
      params: ``{"coarse": ..., "fine": ...}`` on the device the rays will
        come on (closed over).
      ndc: optional ``(H, W, fx, fy)``: warp the world rays into NDC with
        this focal before rendering; near/far become 0/1.
      outputs: which maps to return.
    """
    eval_cfg = render_cfg.eval_mode()

    def fn(rays_o, rays_d, near, far):
        # Full float32 on the card, as the JAX reference computes: TF32 would
        # keep about three decimal digits in the MLP's matmuls.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            viewdirs = None
            if eval_cfg.use_viewdirs:
                viewdirs = rays_d / (
                    torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True) + 1e-10)
            if ndc is not None:
                H, W, fx, fy = ndc
                rays_o, rays_d = ndc_rays(H, W, fx, fy, 1.0, rays_o, rays_d)
                near = torch.zeros_like(near)
                far = torch.ones_like(far)
            out = render_rays(params, model_cfg, eval_cfg, rays_o, rays_d, viewdirs,
                              near, far)
            out["rgb"] = torch.clamp(out["rgb"], max=1.0)
            return {k: out[k] for k in outputs}

    return fn


class RenderService:
    """Serves ray batches of any size through a fixed-batch serve function.

    A request is moved to ``device`` as float32, edge-padded to a multiple of
    ``batch`` and run slice by slice; slices queue on the device without a
    host sync, and the maps come back to the host once, as numpy.
    """

    def __init__(self, fn: Callable, batch: int, *, device: torch.device | str):
        self.fn = fn
        self.batch = batch
        self.device = torch.device(device)

    def __call__(self, *arrays) -> dict[str, np.ndarray]:
        n = arrays[0].shape[0]
        if n == 0:
            raise ValueError("empty request")
        b = self.batch
        n_slices = -(-n // b)
        pad = n_slices * b - n
        padded = [
            pad_edge(torch.as_tensor(x, dtype=torch.float32).to(self.device), pad)
            for x in arrays
        ]
        outs = [self.fn(*(x[i * b:(i + 1) * b] for x in padded))
                for i in range(n_slices)]
        return {k: torch.cat([o[k] for o in outs])[:n].cpu().numpy() for k in outs[0]}
