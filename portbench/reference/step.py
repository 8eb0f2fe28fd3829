"""Frozen copy of the port's two train steps (the benchmark's plain
reference): ``scnerf_tpu_torch/train/step.py`` (``TrainConfig``,
``TrainState``, the NeRF ``loss_fn`` of ``make_train_step`` and
``make_step_fn`` on one device), ``scnerf_tpu_torch/train/nerfpp_step.py``
(``NerfPPTrainConfig`` and its ``loss_fn``) and
``scnerf_tpu_torch/train/driver.py:step_generator``.

``make_step_fn`` takes ``tf32``: False computes in full float32, as the
port's ``serve.fp32`` block does; True lets matmuls and cuDNN round their
inputs to TF32, the control that the benchmark's limits must catch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from portbench.reference.camera import Camera, get_distortion, get_extrinsic, get_intrinsic
from portbench.reference.curriculum import Curriculum, mask_camera_grads, prd_active
from portbench.reference.ndc import ndc_rays
from portbench.reference.nerf import NeRFConfig
from portbench.reference.nerfpp import NerfPPConfig, autoexpo_params
from portbench.reference.nerfpp_renderer import NerfPPRenderConfig, render_rays_nerfpp
from portbench.reference.optim import Optimizer, OptState, apply_updates, trainable_leaves
from portbench.reference.photometric import img2mse, masked_mse, mse2psnr
from portbench.reference.prd import prd_loss
from portbench.reference.rays import pixels_to_rays
from portbench.reference.reduce import batch_mean
from portbench.reference.renderer import RenderConfig, render_rays


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on (``tf32``) or off for matmuls and cuDNN inside the block; the
    caller's flags restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def step_generator(seed: int, it: int, device) -> torch.Generator:
    """Step ``it``'s generator on ``device``, seeded from ``(seed + 1, it)``."""
    mixed = np.random.SeedSequence([seed + 1, it]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) >> 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_init: float = 5e-4
    lr_decay_steps: float = 250_000
    lr_decay_factor: float = 0.1
    weight_decay: float = 0.0
    use_ndc: bool = False
    near: float = 0.0
    far: float = 1.0
    prd_method: str = "NeRF"
    prd_threshold: float = 5.0


@dataclasses.dataclass(frozen=True)
class NerfPPTrainConfig:
    lr_init: float = 5e-4
    lr_decay_steps: float = 750_000
    lr_decay_factor: float = 0.1
    weight_decay: float = 0.0
    autoexpo: bool = False
    lambda_autoexpo: float = 1.0
    prd_threshold: float = 5.0
    prd_undistort: bool = False


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: OptState


def nerf_loss_fn(model_cfg: NeRFConfig, render_cfg: RenderConfig, train_cfg: TrainConfig,
                 curriculum: Curriculum, with_prd: bool = False):
    def loss_fn(params, batch, generator, step):
        camera: Camera | None = params.get("camera")
        if "rays_o" in batch:
            rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        else:
            rays_o, rays_d = pixels_to_rays(camera, batch["px"], batch["py"],
                                            image_idx=batch["img_idx"])
        viewdirs = rays_d / (torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True) + 1e-10)
        if train_cfg.use_ndc:
            if camera is not None:
                K = get_intrinsic(camera)
                fx, fy = K[0, 0], K[1, 1]
                H, W = camera.config.H, camera.config.W
            else:
                fx = fy = batch["focal"]
                H, W = batch["H"], batch["W"]
            rays_o, rays_d = ndc_rays(H, W, fx, fy, 1.0, rays_o, rays_d)

        out = render_rays(
            params, model_cfg, render_cfg, rays_o, rays_d,
            viewdirs if render_cfg.use_viewdirs else None,
            train_cfg.near, train_cfg.far, generator, rands=batch.get("rands"),
        )
        target = batch["target"]
        one = target.new_ones(())
        mse = img2mse(torch.minimum(out["rgb"], one), target)
        loss = mse
        metrics = {"mse": mse, "psnr": mse2psnr(mse)}
        if "rgb0" in out:
            mse0 = img2mse(torch.minimum(out["rgb0"], one), target)
            loss = loss + mse0
            metrics["mse0"] = mse0

        if with_prd:
            kps0, kps1 = batch["kps0"], batch["kps1"]
            E_pair = get_extrinsic(camera, batch["pair_idx"])
            r0 = pixels_to_rays(camera, kps0[:, 0], kps0[:, 1], c2w=E_pair[0])
            r1 = pixels_to_rays(camera, kps1[:, 0], kps1[:, 1], c2w=E_pair[1])
            prd, n_match = prd_loss(
                kps0, kps1, r0, r1, get_intrinsic(camera), E_pair,
                mask=batch.get("kp_mask"), threshold=train_cfg.prd_threshold,
                method=train_cfg.prd_method, mode="train",
            )
            safe_prd = torch.where(n_match > 0, prd, prd.new_zeros(()))
            loss = loss + prd_active(step, curriculum) * safe_prd
            metrics["prd"] = safe_prd
            metrics["prd_matches"] = n_match
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def nerfpp_loss_fn(model_cfg: NerfPPConfig, render_cfg: NerfPPRenderConfig,
                   train_cfg: NerfPPTrainConfig, curriculum: Curriculum,
                   with_prd: bool = False):
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
                if scale.ndim:
                    scale, shift = scale[..., None], shift[..., None]
                pred = (pred - shift) / scale
                reg = train_cfg.lambda_autoexpo * (
                    batch_mean(torch.abs(scale - 1.0)) + batch_mean(torch.abs(shift)))
            mse = img2mse(pred, target) if mask is None else masked_mse(pred, target, mask)
            loss = loss + mse if reg is None else loss + mse + reg
            metrics[f"mse_{m}"] = mse
        metrics["psnr"] = mse2psnr(metrics[f"mse_{len(outs) - 1}"])

        if with_prd:
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
            safe_prd = torch.where(n_match > 0, prd, prd.new_zeros(()))
            loss = loss + prd_active(step, curriculum) * safe_prd
            metrics["prd"] = safe_prd
            metrics["prd_matches"] = n_match
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_step_fn(loss_fn, curriculum: Curriculum, optimizer: Optimizer, *, tf32: bool = False):
    """``step(state, batch, generator) -> (state, metrics)``: one
    ``autograd.grad`` over the trainable leaves, the curriculum's camera
    masks, the optimizer's update in place."""

    def step_fn(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        leaves = trainable_leaves(state.params)
        with precision(tf32):
            loss, metrics = loss_fn(state.params, batch, generator, state.step)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                         allow_unused=True)))
            grads = mask_camera_grads(grads, state.step, curriculum)
            apply_updates(leaves, optimizer.update(grads, state.opt_state, leaves))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step_fn
