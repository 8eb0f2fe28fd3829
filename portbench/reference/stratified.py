"""Frozen copy of ``scnerf_tpu_torch/sampling/stratified.py`` (the benchmark's plain reference).

Stratified depth sampling along rays.

Port of ``scnerf_tpu/sampling/stratified.py``: linspace depths per ray, with
optional jitter inside each interval drawn from a ``torch.Generator`` or
injected as ``t_rand``.
"""
from __future__ import annotations

import torch


def stratified_z_vals(
    generator: torch.Generator | None,
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    lindisp: bool = False,
    perturb: bool = True,
    t_rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coarse depths ``(N, n_samples)`` between ``near`` and ``far``
    (``(N,)`` or ``(N, 1)``). ``t_rand`` jitters even when ``perturb`` is
    off, as in the JAX package."""
    near = near.reshape(-1, 1)
    far = far.reshape(-1, 1)
    t = torch.linspace(0.0, 1.0, n_samples, device=near.device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    z = z.expand(near.shape[0], n_samples)
    if perturb or t_rand is not None:
        z = perturb_z_vals(generator, z, t_rand=t_rand)
    return z


def perturb_z_vals(generator: torch.Generator | None, z_vals: torch.Tensor,
                   t_rand: torch.Tensor | None = None) -> torch.Tensor:
    """Jitter each depth uniformly within its surrounding interval.

    ``generator`` must live on ``z_vals``' device; it is unused when
    ``t_rand`` (of ``z_vals.shape``) is given.
    """
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if t_rand is None:
        t_rand = torch.rand(z_vals.shape, generator=generator, device=z_vals.device)
    return lower + (upper - lower) * t_rand
