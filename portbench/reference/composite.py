"""Frozen copy of ``scnerf_tpu_torch/render/composite.py`` (the benchmark's plain reference).

Alpha compositing of raw field outputs along rays.

Port of ``scnerf_tpu/render/composite.py:raw2outputs``:
``alpha = 1 - exp(-act(sigma) * dist)``, exclusive-cumprod transmittance with
the ``+1e-10`` guard, depth/disparity/accumulation maps, optional white
background.
"""
from __future__ import annotations

import torch


class _CumprodPositive(torch.autograd.Function):
    """``torch.cumprod`` over the last axis of positive factors. Its backward
    is the one ``torch.cumprod`` takes when no factor is zero, ``reversed
    cumsum(grad * out) / x``, without first asking the device whether one is
    (a read-back that stalls the host twice a train step)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(grad * out, [-1]), dim=-1), [-1]) / x


def cumprod_positive(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumprod(x, dim=-1)`` for factors known to be positive, with a
    backward that never waits for the device."""
    return _CumprodPositive.apply(x)


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    generator: torch.Generator | None = None,
    sigma_activation: str = "relu",
    noise: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Composite raw ``(N, S, 4)`` samples at depths ``(N, S)`` into per-ray
    maps: rgb ``(N, 3)``, disp/acc/depth ``(N,)``, weights ``(N, S)``.

    ``noise``: injected standard normals ``(N, S)``, scaled by
    ``raw_noise_std``; else drawn from ``generator`` when that std is > 0.
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if noise is not None:
        sigma = sigma + noise * raw_noise_std
    elif raw_noise_std > 0.0:
        sigma = sigma + torch.randn(
            sigma.shape, generator=generator, device=sigma.device) * raw_noise_std
    if sigma_activation == "relu":
        sigma = torch.relu(sigma)
    elif sigma_activation == "abs":
        sigma = torch.abs(sigma)
    else:
        raise ValueError(sigma_activation)

    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = cumprod_positive(1.0 - alpha + 1e-10)  # factors >= 1e-10
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / (acc_map + 1e-10), min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {
        "rgb": rgb_map,
        "disp": disp_map,
        "acc": acc_map,
        "weights": weights,
        "depth": depth_map,
    }
