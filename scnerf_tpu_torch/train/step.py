"""The joint camera + NeRF train step.

Port of ``scnerf_tpu/train/step.py``: rays from the learnable camera (or
given), the coarse+fine render with stratified jitter and sigma noise, the
photometric loss on ``minimum(rgb, 1)`` plus the coarse term, optionally the
PRD loss in the same backward pass, the curriculum's camera-gradient masks,
and the optimizer chain of ``train/optim.py``. The step runs in full float32
(``serve.fp32``: TF32 off) and never waits for the device: the metrics come
back as 0-d tensors.

K1 resamples the fine depths on every step, forward only; its inputs are
detached (``render/renderer.py``), as the JAX step stops the gradient there.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from scnerf_tpu_torch.camera.model import Camera, get_extrinsic, get_intrinsic
from scnerf_tpu_torch.camera.rays import pixels_to_rays
from scnerf_tpu_torch.fields.nerf import NeRFConfig
from scnerf_tpu_torch.geometry.ndc import ndc_rays
from scnerf_tpu_torch.losses.photometric import img2mse, mse2psnr
from scnerf_tpu_torch.losses.prd import prd_loss
from scnerf_tpu_torch.render.renderer import RenderConfig, render_rays
from scnerf_tpu_torch.serve import fp32
from scnerf_tpu_torch.train.curriculum import Curriculum, mask_camera_grads, prd_active
from scnerf_tpu_torch.train.optim import OptState, Optimizer, apply_updates, trainable_leaves
from scnerf_tpu_torch.train.profiling import span


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # The schedule and L2 decay of the optimizer, built from this config by
    # ``Optimizer.from_config``; the step itself reads the rest.
    lr_init: float = 5e-4
    lr_decay_steps: float = 250_000
    lr_decay_factor: float = 0.1
    weight_decay: float = 0.0
    use_ndc: bool = False
    near: float = 0.0
    far: float = 1.0
    # PRD geometry method ("NeRF" negates fx; "NeRF++" does not).
    prd_method: str = "NeRF"
    prd_threshold: float = 5.0


@dataclasses.dataclass
class TrainState:
    """``params``: ``{"coarse": mlp, "fine": mlp | None, "camera": Camera |
    None}``, trainable leaves requiring grad (``bridge.train_params_to_torch``).
    The step updates them in place and advances ``opt_state``."""

    step: int
    params: Any
    opt_state: OptState


def create_train_state(params: Any, optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def make_train_step(
    model_cfg: NeRFConfig,
    render_cfg: RenderConfig,
    train_cfg: TrainConfig,
    curriculum: Curriculum,
    optimizer: Optimizer,
    with_prd: bool = False,
    group=None,
):
    """Build ``step(state, batch, generator) -> (state, metrics)``.

    ``batch`` holds either rays (``rays_o``, ``rays_d``; with ``use_ndc`` and
    no camera also ``focal``, ``H``, ``W``) or pixel requests (``px``,
    ``py``, ``img_idx``), plus ``target`` RGB ``(N, 3)``, optional injected
    randoms ``rands`` (see ``render_rays``) and, with ``with_prd``, a padded
    correspondence batch (``kps0``, ``kps1`` ``(M, 2)``, ``pair_idx``
    ``(2,)``, ``kp_mask`` ``(M,)``). ``generator`` (on the params' device)
    draws the jitter, sigma noise and fine-sample uniforms that ``rands``
    does not give.

    ``metrics``: ``loss``, ``mse``, ``psnr``, ``mse0`` (with a fine net),
    and with PRD ``prd`` and ``prd_matches``, as detached 0-d tensors.

    With a process ``group`` (``torch.distributed.group.WORLD`` for the
    default one) the step is data-parallel (:func:`make_step_fn`): ``batch`` is this rank's shard
    (``distributed.shard_batch``, with ``pair_idx`` replicated), ``rands``
    its slice of the whole batch's draws, and the metrics are the whole
    batch's.
    """

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
        # minimum(), not clamp(): the reference clamps rgb >= 1 to 1 before
        # the loss, and at a tie minimum() passes half the gradient, as JAX's.
        one = target.new_ones(())
        mse = img2mse(torch.minimum(out["rgb"], one), target)
        loss = mse
        metrics = {"mse": mse, "psnr": mse2psnr(mse)}
        if "rgb0" in out:
            mse0 = img2mse(torch.minimum(out["rgb0"], one), target)
            loss = loss + mse0
            metrics["mse0"] = mse0

        if with_prd:
            with span("scnerf.step.prd"):
                if camera is None:
                    raise ValueError("PRD needs the camera model")
                kps0, kps1 = batch["kps0"], batch["kps1"]
                # The pair's poses decoded once; indexing the camera with a 0-d
                # device tensor would wait for the device.
                E_pair = get_extrinsic(camera, batch["pair_idx"])
                r0 = pixels_to_rays(camera, kps0[:, 0], kps0[:, 1], c2w=E_pair[0])
                r1 = pixels_to_rays(camera, kps1[:, 0], kps1[:, 1], c2w=E_pair[1])
                prd, n_match = prd_loss(
                    kps0, kps1, r0, r1, get_intrinsic(camera), E_pair,
                    mask=batch.get("kp_mask"), threshold=train_cfg.prd_threshold,
                    method=train_cfg.prd_method, mode="train",
                )
                # A pair with no valid match contributes nothing (the
                # reference's NaN skip).
                safe_prd = torch.where(n_match > 0, prd, prd.new_zeros(()))
                loss = loss + prd_active(step, curriculum) * safe_prd
                metrics["prd"] = safe_prd
                metrics["prd_matches"] = n_match
        metrics["loss"] = loss
        return loss, metrics

    return make_step_fn(loss_fn, curriculum, optimizer, group=group)


def make_step_fn(loss_fn, curriculum: Curriculum, optimizer: Optimizer, *, group=None):
    """The step around ``loss_fn(params, batch, generator, step) -> (loss,
    metrics)``, shared by the NeRF and NeRF++ steps: ``step(state, batch,
    generator=None) -> (state, metrics)`` takes one ``autograd.grad`` over
    the trainable leaves under :func:`fp32`, masks the camera's gradients by
    the curriculum, updates the leaves in place and returns the metrics
    detached.

    With a process ``group`` (``torch.distributed.group.WORLD`` for the
    default one), the loss is
    computed under ``distributed.reduce.data_parallel``, so that its value is
    the whole batch's and each rank holds its share of the gradient, and
    every trainable leaf's gradient, the camera's included, is summed over
    the ranks between ``autograd.grad`` and the optimizer: every rank then
    takes the same update."""
    if group is not None:
        from scnerf_tpu_torch.distributed import reduce

    def step_fn(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        leaves = trainable_leaves(state.params)
        scope = contextlib.nullcontext() if group is None else reduce.data_parallel(group)
        with fp32(), scope:
            with span("scnerf.step.forward"):
                loss, metrics = loss_fn(state.params, batch, generator, state.step)
            # The backward's kernels are launched from autograd's own thread
            # on the card: this span names the host's time only.
            with span("scnerf.step.backward"):
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                             allow_unused=True)))
            if group is not None:
                grads = reduce.all_reduce_grads(grads, group)
            with span("scnerf.step.optimizer"):
                grads = mask_camera_grads(grads, state.step, curriculum)
                apply_updates(leaves, optimizer.update(grads, state.opt_state, leaves))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step_fn
