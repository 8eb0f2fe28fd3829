"""Serving: fixed-batch render functions and a service that pads requests
onto them.

Port of ``scnerf_tpu/serve.py``'s ``make_nerf_serve_fn``,
``make_nerfpp_serve_fn`` and ``RenderService``, for one device. The serve
functions bake in the eval-path semantics: deterministic resampling and no
jitter; for NeRF also viewdirs from the world rays, the optional NDC warp
with the learned focal (near/far then 0/1), no sigma noise and the rgb clamp
at 1. They run under ``inference_mode`` in full float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from scnerf_tpu_torch.geometry.ndc import ndc_rays
from scnerf_tpu_torch.render.nerfpp_renderer import render_rays_nerfpp
from scnerf_tpu_torch.render.renderer import pad_edge, render_rays


@contextlib.contextmanager
def fp32():
    """Full float32, as the JAX reference computes: TF32 off for matmuls
    and cuDNN for the block, the caller's flags restored after (TF32 keeps
    about three decimal digits). The serve functions and the train step run
    under it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def fp32_inference():
    """:func:`fp32` under ``inference_mode``: the serve functions'
    context."""
    with fp32(), torch.inference_mode():
        yield


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
        with fp32_inference():
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


NERFPP_OUTPUTS = ("rgb", "fg_depth", "bg_lambda")


def make_nerfpp_serve_fn(level_params: list, model_cfg, render_cfg) -> Callable:
    """Build ``fn(ray_o, ray_d, min_depth) -> {maps}``: the last cascade
    level's ``NERFPP_OUTPUTS``, as the JAX package's NeRF++ serve function
    returns by default.

    Args:
      level_params: one ``{"fg", "bg"}`` param dict per cascade level, on
        the device the rays will come on (closed over).
    """
    eval_cfg = dataclasses.replace(render_cfg, perturb=False)

    def fn(ray_o, ray_d, min_depth):
        with fp32_inference():
            last = render_rays_nerfpp(level_params, model_cfg, eval_cfg, ray_o, ray_d,
                                      min_depth)[-1]
            return {k: last[k] for k in NERFPP_OUTPUTS}

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
