"""Sim(3) trajectory alignment (Umeyama / ATE-style).

Port of ``scnerf_tpu/geometry/alignment.py``: the Umeyama (1991) closed form
in float32, on the tensors' device. The reflection fix is a ``torch.where``
on the device, as JAX's is: a branch on ``det < 0`` read on the host would
wait for the device (the 3x3 SVD runs in cuSOLVER on the card).
"""
from __future__ import annotations

import torch


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True):
    """Least-squares similarity transform aligning ``src`` points to ``dst``.

    Finds ``s, R, t`` minimizing ``|| dst - (s * R @ src + t) ||^2``.

    Args:
      src, dst: ``(N, 3)``.
    Returns:
      (s: 0-d, R: ``(3, 3)``, t: ``(3,)``).
    """
    mu_s = src.mean(dim=0)
    mu_d = dst.mean(dim=0)
    xs = src - mu_s
    xd = dst - mu_d
    n = src.shape[0]
    cov = (xd.T @ xs) / n
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    diag = torch.ones(3, dtype=src.dtype, device=src.device)
    diag = torch.cat([diag[:2], torch.where(det < 0, -diag[2], diag[2]).reshape(1)])
    R = U @ torch.diag(diag) @ Vt
    var_s = torch.sum(xs * xs) / n
    s = torch.sum(D * diag) / var_s if with_scale else torch.ones((), dtype=src.dtype,
                                                                    device=src.device)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def align_c2w_trajectories(poses_a: torch.Tensor, poses_b: torch.Tensor):
    """Sim(3) aligning camera-to-world trajectory ``a`` onto ``b``: the
    similarity from the camera centres, applied to the full 4x4 poses.

    Args:
      poses_a, poses_b: ``(N, 4, 4)`` c2w.
    Returns:
      (aligned_a ``(N, 4, 4)``, (s, R, t)).
    """
    s, R, t = umeyama(poses_a[:, :3, 3], poses_b[:, :3, 3])
    return apply_sim3(poses_a, s, R, t), (s, R, t)


def apply_sim3(poses: torch.Tensor, s, R, t) -> torch.Tensor:
    """Apply a Sim(3) to c2w poses: rotation composes, translation maps."""
    out = poses.clone()
    out[:, :3, :3] = torch.einsum("ij,njk->nik", R, poses[:, :3, :3])
    out[:, :3, 3] = s * torch.einsum("ij,nj->ni", R, poses[:, :3, 3]) + t
    return out


def ate_rmse(poses_a: torch.Tensor, poses_b: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error (RMSE of centres) after Sim(3) alignment."""
    aligned, _ = align_c2w_trajectories(poses_a, poses_b)
    err = aligned[:, :3, 3] - poses_b[:, :3, 3]
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1)))
