"""The joint camera + NeRF++ cascade train step.

Port of ``scnerf_tpu/train/nerfpp_step.py``: rays from the learnable camera
(or given), every cascade level rendered (``render/nerfpp_renderer.py``),
the per-level photometric loss (with the optional auto-exposure correction
and its regulariser), optionally PRD with the NeRF++ geometry in the same
backward pass (distortion-aware with ``prd_undistort`` on a distortion
camera), the curriculum's camera masks and the optimizer; the step itself is
the NeRF step's (``train/step.py:make_step_fn``: full float32, one
``autograd.grad``, metrics as detached 0-d tensors, no wait on the device).

K2 resamples both fg and bg at every later level; the fg resample carries
the gradient of its bins into the camera (the renderer's docstring says
which calls a step makes).
"""
from __future__ import annotations

import dataclasses

import torch

from scnerf_tpu_torch.camera.model import (
    Camera, get_distortion, get_extrinsic, get_intrinsic,
)
from scnerf_tpu_torch.camera.rays import pixels_to_rays
from scnerf_tpu_torch.distributed.reduce import batch_mean
from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, autoexpo_params
from scnerf_tpu_torch.losses.photometric import img2mse, masked_mse, mse2psnr
from scnerf_tpu_torch.losses.prd import prd_loss
from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig, render_rays_nerfpp
from scnerf_tpu_torch.train.curriculum import Curriculum, prd_active
from scnerf_tpu_torch.train.optim import Optimizer
from scnerf_tpu_torch.train.step import make_step_fn


@dataclasses.dataclass(frozen=True)
class NerfPPTrainConfig:
    # The schedule and L2 decay of the optimizer, built from this config by
    # ``Optimizer.from_config`` (with ``lr_floor = 0.01 * lr_init``, as the
    # NeRF++ driver builds it); the step itself reads the rest.
    lr_init: float = 5e-4
    lr_decay_steps: float = 750_000
    lr_decay_factor: float = 0.1
    weight_decay: float = 0.0
    autoexpo: bool = False
    lambda_autoexpo: float = 1.0
    prd_threshold: float = 5.0
    # Distortion-aware PRD on a camera with distortion: the projections go
    # through the inverse-distortion lookup before the comparison.
    prd_undistort: bool = False


def make_nerfpp_train_step(
    model_cfg: NerfPPConfig,
    render_cfg: NerfPPRenderConfig,
    train_cfg: NerfPPTrainConfig,
    curriculum: Curriculum,
    optimizer: Optimizer,
    with_prd: bool = False,
    group=None,
):
    """Build ``step(state, batch, generator) -> (state, metrics)``.

    ``state`` is a ``train/step.py:TrainState`` whose params are ``{"levels":
    [{"fg", "bg", "autoexpo"?}, ...], "camera": Camera | None}``.

    ``batch`` holds either rays (``rays_o``, ``rays_d``) or pixel requests
    (``px``, ``py``, ``img_idx``: an int, a 0-d or an ``(N,)`` index
    tensor), plus ``target`` ``(N, 3)``, ``min_depth`` ``(N,)``, optional
    ``mask`` ``(N,)``, optional injected uniforms ``rands`` (see
    ``render_rays_nerfpp``) and, with ``with_prd``, a padded correspondence
    batch (``kps0``, ``kps1`` ``(M, 2)``, ``pair_idx`` ``(2,)``, ``kp_mask``
    ``(M,)``). With ``autoexpo`` the batch needs ``img_idx`` in either case.
    ``generator`` (on the params' device) draws what ``rands`` does not
    give.

    ``metrics``: ``mse_{m}`` per level, ``psnr`` of the last level,
    ``loss``, and with PRD ``prd`` and ``prd_matches``, as detached 0-d
    tensors.

    ``group``: data-parallel over a process group, as ``make_train_step``'s.
    """

    def loss_fn(params, batch, generator, step):
        camera: Camera | None = params.get("camera")
        if "rays_o" in batch:
            rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        else:
            rays_o, rays_d = pixels_to_rays(camera, batch["px"], batch["py"],
                                            image_idx=batch["img_idx"])
        outs = render_rays_nerfpp(params["levels"], model_cfg, render_cfg, rays_o, rays_d,
                                  batch["min_depth"], generator, rands=batch.get("rands"))
        target, mask = batch["target"], batch.get("mask")
        loss = 0.0
        metrics = {}
        for m, ret in enumerate(outs):
            pred, reg = ret["rgb"], None
            if train_cfg.autoexpo:
                scale, shift = autoexpo_params(params["levels"][m], batch["img_idx"])
                if scale.ndim:  # one image per ray
                    scale, shift = scale[..., None], shift[..., None]
                pred = (pred - shift) / scale
                reg = train_cfg.lambda_autoexpo * (
                    batch_mean(torch.abs(scale - 1.0)) + batch_mean(torch.abs(shift)))
            mse = img2mse(pred, target) if mask is None else masked_mse(pred, target, mask)
            loss = loss + mse if reg is None else loss + mse + reg
            metrics[f"mse_{m}"] = mse
        metrics["psnr"] = mse2psnr(metrics[f"mse_{len(outs) - 1}"])

        if with_prd:
            if camera is None:
                raise ValueError("PRD needs the camera model")
            # Rays are cast at the floored keypoints (the reference's .long()
            # pixel, the camera adding the 0.5 centre offset), and the targets
            # are the keypoints + 0.5. The pair's poses are decoded once:
            # indexing the camera with a 0-d device tensor would wait.
            kps0, kps1 = torch.floor(batch["kps0"]), torch.floor(batch["kps1"])
            E_pair = get_extrinsic(camera, batch["pair_idx"])
            r0 = pixels_to_rays(camera, kps0[:, 0], kps0[:, 1], c2w=E_pair[0])
            r1 = pixels_to_rays(camera, kps1[:, 0], kps1[:, 1], c2w=E_pair[1])
            dist_k = image_wh = None
            if train_cfg.prd_undistort and camera.config.use_distortion:
                dist_k, image_wh = get_distortion(camera), (camera.config.W, camera.config.H)
            prd, n_match = prd_loss(
                batch["kps0"] + 0.5, batch["kps1"] + 0.5, r0, r1, get_intrinsic(camera),
                E_pair, mask=batch.get("kp_mask"), threshold=train_cfg.prd_threshold,
                method="NeRF++", mode="train", distortion_k=dist_k, image_wh=image_wh)
            # A pair with no valid match contributes nothing.
            safe_prd = torch.where(n_match > 0, prd, prd.new_zeros(()))
            loss = loss + prd_active(step, curriculum) * safe_prd
            metrics["prd"] = safe_prd
            metrics["prd_matches"] = n_match
        metrics["loss"] = loss
        return loss, metrics

    return make_step_fn(loss_fn, curriculum, optimizer, group=group)
