"""NeRF++ pipeline training driver.

Port of ``scnerf_tpu/train/nerfpp_driver.py``: the split-directory data
(``data/nerfpp_split.py``), one fg/bg net pair per cascade level, the
learnable OpenCV camera, the two train steps (photometric, and photometric
+ PRD), the host loop with its hooks (``i_print`` metrics, ``i_testset``
held-out PSNR/SSIM[/LPIPS] and PRD, ``i_img`` render panels, ``i_weights``
checkpoints, ``camera_log``), and the held-out evaluation.

As the JAX driver, it restores nothing but the ``load_camera_path``
transfer: a run does not resume from its own checkpoints, and the last step
is saved only when it falls on ``i_weights``.

The loop never waits for the device outside the steps of its hooks. Each
step draws its randoms from ``driver.step_generator(seed, it)`` (the JAX
loop's ``fold_in(key(seed + 1), it)``); the host batch is drawn from
``exp.rng`` in the JAX order (image, pixels, then on PRD steps the pair) and
goes to the device as one packed copy (``driver.to_device``).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from scnerf_tpu_torch.camera.model import (
    OPENCV,
    CameraConfig,
    camera_log_dict,
    camera_log_images,
    get_extrinsics,
    get_intrinsic,
    init_camera,
    trainable_camera,
)
from scnerf_tpu_torch.camera.rays import full_image_pixels, pixels_to_rays, rays_opencv
from scnerf_tpu_torch.core.config import ExperimentConfig, resolved_noise_scales
from scnerf_tpu_torch.core.imaging import colorize_depth
from scnerf_tpu_torch.data.batching import sample_pixels
from scnerf_tpu_torch.data.nerfpp_split import (
    NerfPPSplit,
    check_cameras_in_unit_sphere,
    load_nerfpp_split,
)
from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, init_nerfpp_net
from scnerf_tpu_torch.geometry.so3 import K_inverse_3x3
from scnerf_tpu_torch.losses.prd_eval import prd_evaluation
from scnerf_tpu_torch.matching.pairs import flatten_pairs, image_pair_candidates
from scnerf_tpu_torch.matching.provider import (
    PrecomputedMatches,
    SIFTMatcher,
    build_match_cache,
    matcher_from_config,
    pad_matches,
    sift_available,
)
from scnerf_tpu_torch.metrics.lpips import load_weights, lpips, lpips_available
from scnerf_tpu_torch.metrics.ssim import ssim
from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig, render_chunked_nerfpp
from scnerf_tpu_torch.serve import fp32, fp32_inference
from scnerf_tpu_torch.train.checkpoint import (
    optim_knobs,
    restore_camera_partial,
    restore_checkpoint,
    save_checkpoint,
)
from scnerf_tpu_torch.train.curriculum import Curriculum, prd_cadence_at
from scnerf_tpu_torch.train.device_sampling import make_nerfpp_device_sampling_step
from scnerf_tpu_torch.train.driver import _psnr, step_generator, to_device
from scnerf_tpu_torch.train.logging_utils import MetricLogger
from scnerf_tpu_torch.train.nerfpp_step import NerfPPTrainConfig, make_nerfpp_train_step
from scnerf_tpu_torch.train.optim import Optimizer, named_leaves
from scnerf_tpu_torch.train.profiling import span
from scnerf_tpu_torch.train.step import TrainState, create_train_state


@dataclass
class NerfPPExperiment:
    cfg: ExperimentConfig
    state: TrainState
    step_fn: Any
    step_prd_fn: Any | None
    optimizer: Optimizer
    model_cfg: NerfPPConfig
    render_cfg: NerfPPRenderConfig
    train_cfg: NerfPPTrainConfig
    curriculum: Curriculum
    train_data: NerfPPSplit
    match_cache: PrecomputedMatches | None
    pair_list: np.ndarray | None
    device: torch.device
    rng: np.random.RandomState
    eval_data: Any = None  # the held-out split, loaded on first use ("" = tried, absent)
    device_step: Any = None  # (state, generator) step sampling on the device
    logger: MetricLogger | None = None


def build_nerfpp_experiment(cfg: ExperimentConfig, expdir: str | None = None, *,
                            device: torch.device | str = "cuda") -> NerfPPExperiment:
    """The NeRF++ experiment of ``cfg`` on ``device`` (with the camera
    transfer of ``load_camera_path``; no resume)."""
    if cfg.camera.prd_on_fisheye and not (cfg.camera.prd_undistort
                                          and cfg.camera.use_distortion):
        # A distortion-blind PRD against keypoints in distorted fisheye
        # pixels biases the camera's gradients; the only supported
        # fisheye-PRD combination is the distortion-aware one.
        raise ValueError(
            "camera.prd_on_fisheye requires camera.prd_undistort and "
            "camera.use_distortion (distortion-aware PRD); a distortion-"
            "blind PRD on fisheye keypoints biases the camera gradients.")
    if cfg.model.compute_dtype != "float32":
        raise ValueError(f"the port computes in float32, not {cfg.model.compute_dtype}")
    device = torch.device(device)
    rng = np.random.RandomState(cfg.logging.seed)
    train = load_nerfpp_split(cfg.dataset.datadir, "train",
                              normalize_factor=cfg.dataset.normalize_factor)
    check_cameras_in_unit_sphere(train.poses)

    model_cfg = NerfPPConfig(
        depth=cfg.model.netdepth, width=cfg.model.netwidth,
        max_freq_log2=cfg.model.multires,
        max_freq_log2_viewdirs=cfg.model.multires_views,
    )
    render_cfg = NerfPPRenderConfig(cascade_samples=tuple(cfg.model.cascade_samples),
                                    chunk=cfg.sampling.chunk)
    train_cfg = NerfPPTrainConfig(
        lr_init=cfg.optim.lrate,
        lr_decay_steps=float(cfg.optim.lrate_decay_steps),
        lr_decay_factor=cfg.optim.lrate_decay_factor,
        weight_decay=cfg.optim.non_linear_weight_decay if cfg.optim.use_custom_optim else 0.0,
        autoexpo=cfg.model.autoexpo,
        lambda_autoexpo=cfg.model.lambda_autoexpo,
        prd_threshold=cfg.camera.proj_ray_dist_threshold,
        prd_undistort=cfg.camera.prd_undistort,
    )
    curriculum = Curriculum(
        add_ie=cfg.camera.add_ie, add_od=cfg.camera.add_od,
        add_radial=cfg.camera.add_radial, add_prd=cfg.camera.add_prd,
        i_ray_dist_loss=cfg.camera.i_ray_dist_loss,
        ray_dist_loss_weight=cfg.camera.ray_dist_loss_weight,
        prd_anneal_until=cfg.camera.prd_anneal_until,
        ray_dist_loss_weight_after=cfg.camera.ray_dist_loss_weight_after,
        i_ray_dist_loss_after=cfg.camera.i_ray_dist_loss_after,
    )

    gen = torch.Generator().manual_seed(cfg.logging.seed)
    n_imgs = train.poses.shape[0]
    params = {"levels": [
        init_nerfpp_net(model_cfg, n_images=n_imgs, autoexpo=cfg.model.autoexpo,
                        generator=gen, device=device)
        for _ in range(cfg.model.cascade_level)
    ]}
    for x in named_leaves(params).values():
        x.requires_grad_(True)
    if cfg.camera.use_camera:
        cam_cfg = CameraConfig(
            H=train.H, W=train.W, grid_size=cfg.camera.grid_size,
            convention=OPENCV, pixel_offset=0.5,
            use_distortion=cfg.camera.use_distortion,
            # The reference's distortion camera registers its ray_o and ray_d
            # noise from one shared tensor: fisheye runs train one tied grid.
            tied_ray_noise=cfg.camera.use_distortion,
            multiplicative_noise=cfg.camera.multiplicative_noise,
            intrinsics_noise_scale=cfg.camera.intrinsics_noise_scale,
            distortion_noise_scale=cfg.camera.distortion_noise_scale,
            **resolved_noise_scales(cfg.camera, "nerfpp"),
        )
        k = train.k[0] if (train.k is not None and cfg.camera.use_distortion) else None
        params["camera"] = trainable_camera(
            init_camera(train.intrinsics[0], train.poses, cam_cfg, k=k, device=device))

    optimizer = Optimizer.from_config(
        train_cfg,
        # NeRF++ clamps the decayed rate at 1% of the initial one; the NeRF
        # schedule has no floor.
        lr_floor=0.01 * train_cfg.lr_init,
        camera_lr_mult=cfg.optim.camera_lrate_mult,
        camera_lr_mult_until=cfg.optim.camera_lrate_mult_until,
        camera_lr_mult_hold=cfg.optim.camera_lrate_mult_hold,
        distortion_lr_mult=cfg.optim.distortion_lrate_mult,
        distortion_lr_mult_until=cfg.optim.distortion_lrate_mult_until,
        distortion_lr_mult_hold=cfg.optim.distortion_lrate_mult_hold,
    )
    state = create_train_state(params, optimizer)

    # Camera transfer (the reference's load_camera / load_test): the
    # calibrated camera fields of another experiment's checkpoint.
    transfer = cfg.optim.load_camera_path
    if transfer:
        restored = restore_checkpoint(transfer, state)
        if restored is not None and "camera" in params:
            params["camera"] = restore_camera_partial(
                params["camera"], restored.params["camera"],
                skip_extrinsics=not cfg.optim.load_test)
            state = create_train_state(params, optimizer)

    prd_on = (
        cfg.camera.use_camera
        and cfg.camera.ray_loss_type == "proj_ray_dist"
        # The reference skips PRD on fisheye runs (its PRD is distortion-
        # blind); prd_on_fisheye brings back the distortion-aware one.
        and (not cfg.camera.run_fisheye or cfg.camera.prd_on_fisheye)
    )
    step_fn = make_nerfpp_train_step(model_cfg, render_cfg, train_cfg, curriculum, optimizer)
    step_prd_fn = (make_nerfpp_train_step(model_cfg, render_cfg, train_cfg, curriculum,
                                          optimizer, with_prd=True) if prd_on else None)

    match_cache = None
    pair_list = None
    if prd_on:
        pair_list = flatten_pairs(
            image_pair_candidates(train.poses, cfg.camera.pairing_angle_threshold))
        if len(pair_list) == 0:
            print("[nerfpp] WARNING: PRD enabled but image_pair_candidates found 0 pairs at "
                  f"pairing_angle_threshold={cfg.camera.pairing_angle_threshold} deg: the PRD "
                  "loss will never fire", flush=True)
        cache_path = os.path.join(expdir, "matches.npz") if expdir else None
        if cache_path and os.path.exists(cache_path):
            match_cache = PrecomputedMatches(cache_path)
        elif train.images is not None:
            m = matcher_from_config(cfg.camera, device)  # SuperGlue, SIFT or None
            match_cache = (build_match_cache(train.images, pair_list, m, cache_path)
                           if m is not None else PrecomputedMatches(cache_path))
        else:
            match_cache = PrecomputedMatches(cache_path)

    device_step = None
    if cfg.sampling.device_sampling and train.images is not None:
        def tensor(x):
            return None if x is None else torch.from_numpy(x).to(device)

        fixed = {} if cfg.camera.use_camera else dict(
            intrinsics=tensor(train.intrinsics), poses=tensor(train.poses))
        device_step = make_nerfpp_device_sampling_step(
            step_fn, tensor(train.images), cfg.sampling.N_rand,
            masks=tensor(train.masks), min_depths=tensor(train.min_depths), **fixed)

    logger = MetricLogger(expdir, use_wandb=cfg.logging.use_wandb) if expdir else None
    if logger:
        logger.snapshot_config(cfg.to_json())
    return NerfPPExperiment(
        cfg=cfg, state=state, step_fn=step_fn, step_prd_fn=step_prd_fn, optimizer=optimizer,
        model_cfg=model_cfg, render_cfg=render_cfg, train_cfg=train_cfg,
        curriculum=curriculum, train_data=train, match_cache=match_cache,
        pair_list=pair_list, device=device, rng=rng, device_step=device_step, logger=logger,
    )


def _host_batch(exp: NerfPPExperiment) -> dict[str, np.ndarray]:
    """One step's batch as host arrays, drawn from ``exp.rng`` in the JAX
    order: the image, then the pixels."""
    cfg = exp.cfg
    train = exp.train_data
    n_rand = cfg.sampling.N_rand
    img_i = exp.rng.randint(0, train.poses.shape[0])
    px, py = sample_pixels(exp.rng, train.H, train.W, n_rand)
    pxi, pyi = px.astype(np.int64), py.astype(np.int64)
    arrays = {
        "px": px, "py": py,
        "img_idx": np.asarray(img_i, np.int64),
        "target": train.images[img_i, pyi, pxi].astype(np.float32),
        "min_depth": (train.min_depths[img_i, pyi, pxi] if train.min_depths is not None
                      else np.full((n_rand,), 1e-4, np.float32)),
    }
    if not cfg.camera.use_camera:
        # No learnable camera: the rays come from the dataset's K and pose.
        arrays["K"] = train.intrinsics[img_i]
        arrays["c2w"] = train.poses[img_i]
    if train.masks is not None and cfg.model.mask_train_loss:
        # The reference trains unmasked (its masks weigh only the eval
        # metrics); masked training is opt-in.
        arrays["mask"] = train.masks[img_i, pyi, pxi].astype(np.float32)
    return arrays


def _on_device(exp: NerfPPExperiment, arrays: dict[str, np.ndarray]) -> dict:
    """``arrays`` on the device by one copy; a dataset ``K`` and ``c2w``
    become the batch's rays."""
    batch = to_device(arrays, exp.device)
    if "K" in batch:
        K, c2w = batch.pop("K"), batch.pop("c2w")
        batch["rays_o"], batch["rays_d"] = rays_opencv(K, c2w, batch["px"], batch["py"])
    return batch


def nerfpp_sample_batch(exp: NerfPPExperiment) -> dict:
    """One step's ray batch, drawn on the host and sent as one copy:
    ``px``, ``py``, ``img_idx`` (0-d), ``target``, ``min_depth``, and
    ``rays_o``/``rays_d`` without a camera, ``mask`` under
    ``mask_train_loss``."""
    return _on_device(exp, _host_batch(exp))


def run_nerfpp_training(cfg: ExperimentConfig, expdir: str, n_steps: int | None = None,
                        exp: NerfPPExperiment | None = None, *,
                        device: torch.device | str = "cuda"):
    """The host loop. ``exp`` lets a caller pass a prebuilt experiment (its
    ``state`` tracks the loop); built from ``cfg`` on ``device`` when
    omitted, and its logger closed at the end. Returns the final state and
    the last step's metrics (0-d tensors on the device)."""
    own = exp is None
    if own:
        exp = build_nerfpp_experiment(cfg, expdir, device=device)
    try:
        return _loop(exp, expdir, n_steps if n_steps is not None else cfg.optim.N_iters)
    finally:
        if own and exp.logger:
            exp.logger.close()


def _loop(exp: NerfPPExperiment, expdir: str, n_steps: int):
    cfg = exp.cfg
    log = cfg.logging
    ckpt_dir = os.path.join(expdir, "ckpts")
    metrics = {}
    for it in range(exp.state.step, n_steps):
        with span("scnerf.loop.step", it):
            use_prd = (
                exp.step_prd_fn is not None
                and it >= exp.curriculum.add_prd
                and it % prd_cadence_at(it, exp.curriculum) == 0
                and exp.pair_list is not None and len(exp.pair_list) > 0
            )
            gen = step_generator(log.seed, it, exp.device)
            if not use_prd and exp.device_step is not None:
                exp.state, metrics = exp.device_step(exp.state, gen)
            elif use_prd:
                with span("scnerf.loop.draw"):
                    arrays = _host_batch(exp)
                # The pair's matches go to the device in the batch's copy.
                with span("scnerf.loop.prd_draw"):
                    i, j = exp.pair_list[exp.rng.randint(0, len(exp.pair_list))]
                    m = exp.match_cache.get(int(i), int(j)) if exp.match_cache else None
                    prd = m is not None and m.kps0.shape[0] > 0
                    if prd:
                        kps0, kps1, mask = pad_matches(m, cfg.camera.match_num)
                        arrays.update(kps0=kps0, kps1=kps1, kp_mask=mask,
                                      pair_idx=np.array([int(i), int(j)], np.int64))
                    batch = _on_device(exp, arrays)
                step = exp.step_prd_fn if prd else exp.step_fn
                exp.state, metrics = step(exp.state, batch, gen)
            else:
                with span("scnerf.loop.draw"):
                    batch = nerfpp_sample_batch(exp)
                exp.state, metrics = exp.step_fn(exp.state, batch, gen)
            # The step counter on the host: reading the device every step would
            # wait for it.
            step_now = it + 1
            with span("scnerf.loop.log"):
                if exp.logger and step_now % log.i_print == 0:
                    exp.logger.log(step_now, metrics)
                if exp.logger and step_now % log.i_testset == 0:
                    # Held-out render metrics and PRD, the reference's test protocol
                    # run in the loop.
                    res = evaluate_nerfpp(exp, max_views=2)
                    res.update(evaluate_nerfpp_prd(exp))
                    exp.logger.log(step_now, {f"test/{k}": v for k, v in res.items()})
                if exp.logger and step_now % log.i_img == 0:
                    _log_render_panel(exp, step_now)
                if step_now % log.i_weights == 0:
                    save_checkpoint(ckpt_dir, exp.state, optim_meta=optim_knobs(cfg))
                camera = exp.state.params.get("camera")
                if exp.logger and step_now % log.camera_log == 0 and camera is not None:
                    exp.logger.log(step_now,
                                   camera_log_dict(camera, gt_K=exp.train_data.intrinsics[0]))
                    exp.logger.log_images(step_now, camera_log_images(camera))
    return exp.state, metrics


def _log_render_panel(exp: NerfPPExperiment, step: int) -> None:
    """The reference's ``i_img`` hook: rgb, fg, bg and the colorized fg
    depth of one held-out view (else train view 0)."""
    data = _held_out_data(exp)
    if data is None:
        out = render_nerfpp_image(exp, img_idx=0)
    else:
        out = render_nerfpp_image(exp, c2w=data.poses[0], K=data.intrinsics[0],
                                  hw=(data.H, data.W))
    exp.logger.log_images(step, {
        "val/rgb": np.clip(out["rgb"], 0, 1),
        "val/fg_rgb": np.clip(out["fg_rgb"], 0, 1),
        "val/bg_rgb": np.clip(out["bg_rgb"], 0, 1),
        "val/fg_depth": colorize_depth(out["fg_depth"]),
    })


def _ray_path(exp: NerfPPExperiment, img_idx, c2w, resolution_level: int, hw):
    """Which rays a render takes, and at what size: ``"index"`` (the learned
    camera at train image ``img_idx``), ``"c2w"`` (the learned camera at a
    given pose) or ``"fixed"`` (the dataset K scaled by ``1 / L``)."""
    train = exp.train_data
    camera = exp.state.params.get("camera")
    if camera is not None and resolution_level == 1:
        if img_idx is not None:
            return "index", train.H, train.W
        if c2w is not None and (hw is None or tuple(hw) == (train.H, train.W)):
            return "c2w", train.H, train.W
    H0, W0 = hw if hw is not None else (train.H, train.W)
    return "fixed", H0 // resolution_level, W0 // resolution_level


def render_nerfpp_pixels(exp: NerfPPExperiment, px: torch.Tensor, py: torch.Tensor,
                         img_idx: int | None = None, c2w=None, K=None,
                         resolution_level: int = 1, hw: tuple | None = None,
                         ) -> dict[str, torch.Tensor]:
    """Eval-mode render of the pixels ``(px, py)`` (flat, on the device),
    along the ray path :func:`render_nerfpp_image` takes for the same
    arguments; the last level's flat maps on the device."""
    train = exp.train_data
    camera = exp.state.params.get("camera")
    path, _, _ = _ray_path(exp, img_idx, c2w, resolution_level, hw)

    def tensor(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
        return x.to(device=exp.device, dtype=torch.float32)

    with fp32_inference():
        if path == "index":
            rays_o, rays_d = pixels_to_rays(camera, px, py, image_idx=img_idx)
        elif path == "c2w":
            # A held-out pose through the learned camera: calibrated K and
            # noise, the distortion warp, the ray-noise grids, the given c2w.
            rays_o, rays_d = pixels_to_rays(camera, px, py, c2w=tensor(c2w))
        else:
            Kmat = np.array(K if K is not None else train.intrinsics[img_idx or 0], np.float32)
            Kmat[:2, :3] /= resolution_level
            pose = c2w if c2w is not None else train.poses[img_idx or 0]
            rays_o, rays_d = rays_opencv(tensor(Kmat), tensor(pose), px, py)
        return render_chunked_nerfpp(
            exp.state.params["levels"], exp.model_cfg,
            dataclasses.replace(exp.render_cfg, perturb=False),
            rays_o, rays_d, torch.full((rays_o.shape[0],), 1e-4, device=exp.device))


def render_nerfpp_image(exp: NerfPPExperiment, img_idx: int | None = None, c2w=None, K=None,
                        resolution_level: int = 1, hw: tuple | None = None,
                        ) -> dict[str, np.ndarray]:
    """Full-image eval-mode NeRF++ render: ``(H, W, ...)`` numpy maps of the
    last level (``LAST_LEVEL_MAPS``), each copied to the host once.

    With the camera model, rays come from the learned parameters at
    ``img_idx`` or, for a held-out ``c2w``, from the learned intrinsics and
    noise at that pose; otherwise from the given ``K``/``c2w``.
    ``resolution_level`` L renders ``H//L x W//L`` with K scaled by 1/L (the
    camera paths render at full resolution only: their grids are tied to H
    and W)."""
    _, Hr, Wr = _ray_path(exp, img_idx, c2w, resolution_level, hw)
    px, py = full_image_pixels(Hr, Wr, device=exp.device)
    out = render_nerfpp_pixels(exp, px, py, img_idx=img_idx, c2w=c2w, K=K,
                               resolution_level=resolution_level, hw=hw)
    return {k: v.cpu().numpy().reshape((Hr, Wr) + tuple(v.shape[1:])) for k, v in out.items()}


def _held_out_data(exp: NerfPPExperiment):
    """The validation (else test) split, loaded on first use; None if
    neither exists."""
    if exp.eval_data is None:
        exp.eval_data = ""
        for split in ("validation", "test"):
            try:
                exp.eval_data = load_nerfpp_split(
                    exp.cfg.dataset.datadir, split,
                    normalize_factor=exp.cfg.dataset.normalize_factor)
                break
            except (FileNotFoundError, OSError, ValueError):
                continue
    return exp.eval_data or None


def evaluate_nerfpp(exp: NerfPPExperiment, max_views: int | None = 2, data=None) -> dict:
    """PSNR, SSIM and, when LPIPS weights are given, LPIPS over held-out
    renders (the reference's test protocol). Held-out poses render through
    the learned camera when one exists, else the dataset K; without a
    held-out split the train views are evaluated, reported as ``split:
    "train"``."""
    data = data if data is not None else _held_out_data(exp)
    split = "heldout"
    if data is None or data is exp.train_data:
        data, split = exp.train_data, "train"
    n = data.poses.shape[0] if max_views is None else min(max_views, data.poses.shape[0])
    lpips_w = load_weights(device=exp.device) if lpips_available() else None
    psnrs, ssims, lpipss = [], [], []
    for i in range(n):
        if data is exp.train_data:
            out = render_nerfpp_image(exp, img_idx=i)
        else:
            out = render_nerfpp_image(exp, c2w=data.poses[i], K=data.intrinsics[i],
                                      hw=(data.H, data.W))
        target = data.images[i]
        psnrs.append(_psnr(out["rgb"], target))
        rgb_d, target_d = (torch.from_numpy(np.asarray(x, np.float32)).to(exp.device)
                           for x in (out["rgb"], target))
        ssims.append(float(ssim(rgb_d, target_d)))
        if lpips_w is not None:
            lpipss.append(float(lpips(rgb_d, target_d, lpips_w)))
    res = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
           "n_views": n, "split": split}
    if lpipss:
        res["lpips"] = float(np.mean(lpipss))
    return res


@torch.no_grad()
def evaluate_nerfpp_prd(exp: NerfPPExperiment) -> dict:
    """NeRF++ PRD evaluation: feasible pairs over the cameras,
    correspondences per pair, train-mode PRD (unclamped, no GT filter: NeRF++
    scenes treat their COLMAP poses as the camera under evaluation) with
    ``method="NeRF++"``. ``{}`` without a cache when SIFT is unavailable."""
    train = exp.train_data
    camera = exp.state.params.get("camera")
    with fp32():
        if camera is not None:
            K, E = get_intrinsic(camera), get_extrinsics(camera)
        else:
            K = torch.as_tensor(train.intrinsics[0], device=exp.device)
            E = torch.as_tensor(train.poses, device=exp.device)
        if exp.pair_list is not None and len(exp.pair_list) and exp.match_cache is not None:
            pair_list, cache = exp.pair_list, exp.match_cache
        else:
            if not sift_available():
                return {}
            pair_list = flatten_pairs(image_pair_candidates(
                E.cpu().numpy(), exp.cfg.camera.pairing_angle_threshold))
            if len(pair_list) == 0:
                return {}
            cache = build_match_cache(train.images, pair_list, SIFTMatcher())
            exp.pair_list, exp.match_cache = pair_list, cache

        # The eval rays are cast at the floored keypoint pixel (the
        # reference's .long() index; the 0.5 centre comes from the ray
        # generation); the loss targets stay the raw keypoints.
        if camera is not None:
            def rays_eval(kps, idx):
                kps = torch.floor(kps)
                return pixels_to_rays(camera, kps[:, 0], kps[:, 1], image_idx=idx)
        else:
            Kinv = K_inverse_3x3(K)

            def rays_eval(kps, idx):
                kps = torch.floor(kps)
                pix = torch.stack([kps[:, 0] + 0.5, kps[:, 1] + 0.5,
                                   torch.ones_like(kps[:, 0])], -1)
                c2w = E[idx]
                d = (pix @ Kinv.T) @ c2w[:3, :3].T
                return c2w[:3, 3].expand(d.shape), d

        val = prd_evaluation(
            pair_list, cache, rays_eval, K, E, mode="train", method="NeRF++",
            max_matches=exp.cfg.camera.match_num,
            threshold=exp.cfg.camera.proj_ray_dist_threshold, device=exp.device,
        )
    return {"prd": val} if np.isfinite(val) else {}
