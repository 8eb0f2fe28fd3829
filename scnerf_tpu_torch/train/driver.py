"""NeRF-pipeline training driver.

Port of ``scnerf_tpu/train/driver.py`` (LLFF): config tree in, trained state
and metrics out. Loads the dataset, builds the camera, the correspondence
cache and the two train steps (photometric, and photometric + PRD), and runs
the host loop with periodic logging, checkpoints and the ATE-aligned
test-view evaluation.

The loop never waits for the device outside the ``i_print`` steps (which
read the metrics) and the ``i_weights`` steps (which save a checkpoint).
Each step draws its randoms from a generator seeded by ``(seed + 1, it)``
alone (:func:`step_generator`), so a resumed run draws what an uninterrupted
one would. A batch drawn on the host goes to the device as one copy from
pinned memory (:func:`to_device`); with ``device_sampling`` the batch is
drawn on the device.

Not in this slice: the blender dataset, the ``i_video`` hook, LPIPS and the
reference ``.tar`` checkpoint migration; they raise ``NotImplementedError``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from scnerf_tpu_torch.camera.model import (
    OPENGL,
    Camera,
    CameraConfig,
    camera_log_dict,
    camera_log_images,
    get_extrinsics,
    get_intrinsic,
    init_camera,
    trainable_camera,
)
from scnerf_tpu_torch.camera.rays import full_image_pixels, pixels_to_rays, rays_no_camera
from scnerf_tpu_torch.core.config import ExperimentConfig, resolved_noise_scales
from scnerf_tpu_torch.core.imaging import to8b, write_png
from scnerf_tpu_torch.data.batching import PixelPool, RayPool, gather_target, sample_pixels
from scnerf_tpu_torch.data.llff import load_llff
from scnerf_tpu_torch.data.noise import NoiseConfig
from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp
from scnerf_tpu_torch.geometry.alignment import align_c2w_trajectories, apply_sim3
from scnerf_tpu_torch.geometry.ndc import ndc_rays
from scnerf_tpu_torch.losses.photometric import img2mse, mse2psnr
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
from scnerf_tpu_torch.metrics.ssim import ssim
from scnerf_tpu_torch.render.renderer import RenderConfig, render_chunked
from scnerf_tpu_torch.serve import fp32, fp32_inference
from scnerf_tpu_torch.train.checkpoint import optim_knobs, restore_checkpoint, save_checkpoint
from scnerf_tpu_torch.train.curriculum import Curriculum, prd_cadence_at
from scnerf_tpu_torch.train.device_sampling import make_device_sampling_step
from scnerf_tpu_torch.train.logging_utils import MetricLogger
from scnerf_tpu_torch.train.optim import Optimizer, named_leaves
from scnerf_tpu_torch.train.profiling import StepTimer
from scnerf_tpu_torch.train.step import (
    TrainConfig,
    TrainState,
    create_train_state,
    make_train_step,
)


@dataclass
class NerfExperiment:
    """Everything the loop needs, assembled once."""

    cfg: ExperimentConfig
    state: TrainState
    step_fn: Any
    step_prd_fn: Any | None
    optimizer: Optimizer
    model_cfg: NeRFConfig
    render_cfg: RenderConfig
    train_cfg: TrainConfig
    curriculum: Curriculum
    images: np.ndarray  # (N, H, W, 3) float32 on the host
    i_train: np.ndarray
    i_test: np.ndarray
    gt_intrinsic: np.ndarray
    gt_poses: np.ndarray
    noisy_poses: np.ndarray
    noisy_focal: float
    near: float
    far: float
    device: torch.device
    rng: np.random.RandomState
    H: int = 0
    W: int = 0
    match_cache: PrecomputedMatches | None = None
    pair_list: np.ndarray | None = None
    # Lazy eval-split correspondence cache (built on the first val/test PRD
    # evaluation).
    eval_match_cache: PrecomputedMatches | None = None
    eval_pair_list: np.ndarray | None = None
    render_poses: np.ndarray | None = None  # (R, 4, 4) spiral/spherical path
    ray_pool: RayPool | None = None
    pixel_pool: PixelPool | None = None  # use_batching + camera
    device_step: Any | None = None  # (state, generator) step sampling on the device
    logger: MetricLogger | None = None


def step_generator(seed: int, it: int, device) -> torch.Generator:
    """Step ``it``'s generator on ``device``, seeded from ``(seed + 1, it)``
    alone (the JAX loop's ``fold_in(key(seed + 1), it)``)."""
    mixed = np.random.SeedSequence([seed + 1, it]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) >> 1)


def to_device(arrays: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """numpy arrays -> tensors on ``device`` by one host-to-device copy: the
    arrays' bytes packed into one pinned buffer (each at an 8-byte offset),
    copied without waiting (the caching host allocator keeps the buffer
    until the copy has run), and viewed back as each array's dtype and
    shape. On the CPU the tensors share the arrays' memory."""
    device = torch.device(device)
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    if device.type == "cpu":
        return {k: torch.from_numpy(v) for k, v in arrays.items()}
    offsets, total = {}, 0
    for k, v in arrays.items():
        offsets[k] = total
        total += -(-v.nbytes // 8) * 8
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    flat = host.numpy()
    for k, v in arrays.items():
        flat[offsets[k]:offsets[k] + v.nbytes] = v.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return {k: dev[offsets[k]:offsets[k] + v.nbytes]
            .view(torch.from_numpy(np.empty(0, v.dtype)).dtype).reshape(v.shape)
            for k, v in arrays.items()}


def _load_dataset(cfg: ExperimentConfig, rng):
    ds = cfg.dataset
    noise = NoiseConfig(
        intrinsic_scale=ds.initial_noise_size_intrinsic,
        rotation_deg=ds.initial_noise_size_rotation,
        translation=ds.initial_noise_size_translation,
        run_without_colmap=ds.run_without_colmap,
    )
    if ds.dataset_type == "llff":
        d = load_llff(
            ds.datadir, factor=ds.factor, spherify=ds.spherify,
            llffhold=ds.llffhold, noise=noise, rng=rng,
        )
        if ds.no_ndc:
            near, far = float(d.bds.min() * 0.9), float(d.bds.max() * 1.0)
        else:
            near, far = 0.0, 1.0
        rp = np.broadcast_to(np.eye(4), (len(d.render_poses), 4, 4)).copy()
        rp[:, :3, :4] = d.render_poses[:, :3, :4]
        return (d.images, d.noisy_poses, d.gt_poses, d.gt_intrinsic, d.noisy_focal,
                d.i_train, d.i_test, near, far, d.H, d.W, rp.astype(np.float32))
    if ds.dataset_type == "blender":
        raise NotImplementedError(
            "dataset_type blender needs data/blender.py, which a later slice of the port brings")
    raise ValueError(f"unknown dataset_type {ds.dataset_type} for NeRF pipeline")


def build_experiment(cfg: ExperimentConfig, expdir: str | None = None, *,
                     device: torch.device | str = "cuda") -> NerfExperiment:
    """The experiment of ``cfg`` on ``device``, resumed from the latest
    checkpoint in ``expdir/ckpts`` (or ``ckpt_path``) unless ``no_reload``."""
    device = torch.device(device)
    rng = np.random.RandomState(cfg.logging.seed)
    (images, noisy_poses, gt_poses, gt_K, noisy_focal,
     i_train, i_test, near, far, H, W, render_poses) = _load_dataset(cfg, rng)

    if cfg.model.compute_dtype != "float32":
        raise ValueError(f"the port computes in float32, not {cfg.model.compute_dtype}")
    use_ndc = cfg.dataset.dataset_type == "llff" and not cfg.dataset.no_ndc
    model_cfg = NeRFConfig(
        depth=cfg.model.netdepth, width=cfg.model.netwidth,
        multires=cfg.model.multires, multires_views=cfg.model.multires_views,
        use_viewdirs=cfg.model.use_viewdirs,
    )
    render_cfg = RenderConfig(
        n_samples=cfg.sampling.N_samples, n_importance=cfg.sampling.N_importance,
        perturb=cfg.sampling.perturb, lindisp=cfg.dataset.lindisp,
        raw_noise_std=cfg.sampling.raw_noise_std, white_bkgd=cfg.dataset.white_bkgd,
        use_viewdirs=cfg.model.use_viewdirs, chunk=cfg.sampling.chunk,
    )
    train_cfg = TrainConfig(
        lr_init=cfg.optim.lrate,
        lr_decay_steps=cfg.optim.lrate_decay * 1000.0,
        weight_decay=cfg.optim.non_linear_weight_decay if cfg.optim.use_custom_optim else 0.0,
        use_ndc=use_ndc, near=near, far=far,
        prd_method="NeRF", prd_threshold=cfg.camera.proj_ray_dist_threshold,
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
    params = {
        "coarse": init_nerf_mlp(model_cfg, generator=gen, device=device),
        "fine": init_nerf_mlp(model_cfg, generator=gen, device=device)
        if cfg.sampling.N_importance > 0 else None,
    }
    for x in named_leaves(params).values():
        x.requires_grad_(True)

    if cfg.camera.use_camera:
        # The camera covers the TRAIN split only (the reference's i_map):
        # camera index c is image i_train[c].
        if cfg.dataset.run_without_colmap != "none":
            # fx=W, fy=H, cx=W/2, cy=H/2 init (the reference's create_nerf.py:95-123).
            K_init = np.array(
                [[W, 0, W / 2, 0], [0, H, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                np.float32,
            )
        else:
            K_init = gt_K.copy()
            K_init[0, 0] = K_init[1, 1] = noisy_focal
        cam_cfg = CameraConfig(
            H=H, W=W, grid_size=cfg.camera.grid_size, convention=OPENGL,
            use_distortion=cfg.camera.use_distortion,
            multiplicative_noise=cfg.camera.multiplicative_noise,
            intrinsics_noise_scale=cfg.camera.intrinsics_noise_scale,
            distortion_noise_scale=cfg.camera.distortion_noise_scale,
            **resolved_noise_scales(cfg.camera, "nerf"),
        )
        params["camera"] = trainable_camera(
            init_camera(K_init, noisy_poses[i_train], cam_cfg, device=device))

    optimizer = Optimizer.from_config(
        train_cfg,
        camera_lr_mult=cfg.optim.camera_lrate_mult,
        camera_lr_mult_until=cfg.optim.camera_lrate_mult_until,
        camera_lr_mult_hold=cfg.optim.camera_lrate_mult_hold,
        distortion_lr_mult=cfg.optim.distortion_lrate_mult,
        distortion_lr_mult_until=cfg.optim.distortion_lrate_mult_until,
        distortion_lr_mult_hold=cfg.optim.distortion_lrate_mult_hold,
    )
    state = create_train_state(params, optimizer)

    # Warm start / auto-resume (the reference's ft_path + latest-checkpoint
    # resume; disabled by no_reload).
    if not cfg.optim.no_reload:
        if cfg.optim.ckpt_path.endswith(".tar"):
            raise NotImplementedError(
                "restoring a reference .tar checkpoint needs tools/convert.py, which a later "
                "slice of the port brings")
        for source in ([cfg.optim.ckpt_path] if cfg.optim.ckpt_path else []) + (
            [os.path.join(expdir, "ckpts")] if expdir else []
        ):
            restored = restore_checkpoint(source, state, optim_meta=optim_knobs(cfg))
            if restored is not None:
                state = restored
                print(f"[resume] restored step {state.step} from {source}")
                break

    prd_on = cfg.camera.use_camera and cfg.camera.ray_loss_type == "proj_ray_dist"
    step_fn = make_train_step(model_cfg, render_cfg, train_cfg, curriculum, optimizer)
    step_prd_fn = (make_train_step(model_cfg, render_cfg, train_cfg, curriculum, optimizer,
                                   with_prd=True) if prd_on else None)

    match_cache = None
    pair_list = None
    if prd_on:
        pairs = image_pair_candidates(noisy_poses[i_train], cfg.camera.pairing_angle_threshold)
        pair_list = flatten_pairs(pairs)  # indices into the camera table
        cache_path = os.path.join(expdir, "matches.npz") if expdir else None
        if cache_path and os.path.exists(cache_path):
            match_cache = PrecomputedMatches(cache_path)
        elif len(pair_list):
            m = matcher_from_config(cfg.camera)  # sift / None
            match_cache = (
                build_match_cache(images[i_train], pair_list, m, cache_path)
                if m is not None else PrecomputedMatches(cache_path)
            )
        else:
            match_cache = PrecomputedMatches(cache_path)

    ray_pool, pixel_pool = None, None
    if cfg.sampling.use_batching and cfg.camera.use_camera:
        pixel_pool = PixelPool(len(i_train), H, W, rng=rng)
    if cfg.sampling.use_batching and not cfg.camera.use_camera:
        rays = [rays_no_camera(H, W, noisy_focal, torch.from_numpy(noisy_poses[i]).float())
                for i in i_train]
        ray_pool = RayPool(
            torch.cat([o for o, _ in rays]).numpy(), torch.cat([d for _, d in rays]).numpy(),
            np.concatenate([images[i].reshape(-1, 3) for i in i_train]),
            seed=cfg.logging.seed,
        )

    device_step = None
    if (
        cfg.sampling.device_sampling
        and cfg.camera.use_camera
        and not cfg.sampling.use_batching
        and cfg.sampling.precrop_iters == 0
    ):
        # The camera table covers the train split: the train images in
        # camera-table order.
        device_step = make_device_sampling_step(
            step_fn, torch.from_numpy(images[i_train]).to(device), n_rand=cfg.sampling.N_rand
        )

    logger = MetricLogger(expdir, use_wandb=cfg.logging.use_wandb) if expdir else None
    if logger:
        logger.snapshot_config(cfg.to_json())

    return NerfExperiment(
        cfg=cfg, state=state, step_fn=step_fn, step_prd_fn=step_prd_fn, optimizer=optimizer,
        model_cfg=model_cfg, render_cfg=render_cfg, train_cfg=train_cfg,
        curriculum=curriculum, images=images, i_train=i_train, i_test=i_test,
        gt_intrinsic=gt_K, gt_poses=gt_poses, noisy_poses=noisy_poses,
        noisy_focal=noisy_focal, near=near, far=far, device=device, rng=rng, H=H, W=W,
        match_cache=match_cache, pair_list=pair_list, render_poses=render_poses,
        ray_pool=ray_pool, pixel_pool=pixel_pool, device_step=device_step, logger=logger,
    )


def sample_batch(exp: NerfExperiment, step: int) -> dict:
    """Step ``step``'s ray batch, drawn on the host from ``exp.rng`` (or a
    pool) and sent to the device as one copy."""
    cfg = exp.cfg
    n_rand = cfg.sampling.N_rand
    if exp.ray_pool is not None:
        return to_device(exp.ray_pool.next_batch(n_rand), exp.device)
    if exp.pixel_pool is not None:
        # use_batching WITH camera (the reference's run_nerf.py:369-407):
        # per-ray image indices through the differentiable camera.
        ci, px, py = exp.pixel_pool.next_batch(n_rand)
        target = gather_target(exp.images, exp.i_train[ci], px, py)
        return to_device({"px": px, "py": py, "img_idx": ci,
                          "target": target.astype(np.float32)}, exp.device)
    precrop = cfg.sampling.precrop_frac if step < cfg.sampling.precrop_iters else None
    ci = exp.rng.randint(0, len(exp.i_train))  # camera-table index
    img_i = exp.i_train[ci]
    px, py = sample_pixels(exp.rng, exp.H, exp.W, n_rand, precrop)
    target = gather_target(exp.images, img_i, px, py).astype(np.float32)
    if exp.state.params.get("camera") is None:
        b = to_device({"px": px, "py": py, "target": target,
                       "c2w": exp.noisy_poses[img_i].astype(np.float32)}, exp.device)
        o, d = rays_no_camera(exp.H, exp.W, exp.noisy_focal, b["c2w"], b["px"], b["py"])
        return {"rays_o": o, "rays_d": d, "target": b["target"],
                "focal": exp.noisy_focal, "H": exp.H, "W": exp.W}
    return to_device({"px": px, "py": py, "img_idx": np.full((n_rand,), ci, np.int32),
                      "target": target}, exp.device)


def sample_prd_batch(exp: NerfExperiment) -> dict | None:
    """One random feasible pair with cached matches, padded, on the device
    (one copy)."""
    if exp.pair_list is None or len(exp.pair_list) == 0 or exp.match_cache is None:
        return None
    for _ in range(8):
        i, j = exp.pair_list[exp.rng.randint(0, len(exp.pair_list))]
        m = exp.match_cache.get(int(i), int(j))
        if m is not None and m.kps0.shape[0] > 0:
            kps0, kps1, mask = pad_matches(m, exp.cfg.camera.match_num)
            return to_device({"kps0": kps0, "kps1": kps1, "kp_mask": mask,
                              "pair_idx": np.array([int(i), int(j)], np.int64)}, exp.device)
    return None


def train_loop(
    exp: NerfExperiment,
    n_steps: int | None = None,
    ckpt_dir: str | None = None,
    eval_hooks: bool = False,
):
    """Run the optimization loop; returns the final state and the last
    step's metrics (0-d tensors on the device).

    With ``eval_hooks`` the reference's periodic side tasks run too:
    ``i_testset`` test-split metrics (+ PRD evaluation when a match cache
    exists), ``i_img`` one validation render, ``camera_log`` camera
    diagnostics. The ``i_video`` hook is not ported yet: ``eval_hooks``
    needs ``i_video = 0``.
    """
    cfg = exp.cfg
    if eval_hooks and cfg.logging.i_video > 0:
        raise NotImplementedError(
            "the i_video hook needs tools/video.py, which a later slice of the port brings; "
            "set i_video 0")
    n_steps = n_steps if n_steps is not None else cfg.optim.N_iters
    metrics = {}
    timer = StepTimer()
    for it in range(exp.state.step, n_steps):
        use_prd = (
            exp.step_prd_fn is not None
            and it >= exp.curriculum.add_prd
            and it % prd_cadence_at(it, exp.curriculum) == 0
        )
        batch = (None if (not use_prd and exp.device_step is not None)
                 else sample_batch(exp, it))
        gen = step_generator(cfg.logging.seed, it, exp.device)
        with timer:
            if batch is None:
                exp.state, metrics = exp.device_step(exp.state, gen)
            elif use_prd:
                prd_batch = sample_prd_batch(exp)
                if prd_batch is not None and "px" in batch:
                    exp.state, metrics = exp.step_prd_fn(exp.state, dict(batch, **prd_batch), gen)
                else:
                    exp.state, metrics = exp.step_fn(exp.state, batch, gen)
            else:
                exp.state, metrics = exp.step_fn(exp.state, batch, gen)

        step_now = it + 1
        if exp.logger and step_now % cfg.logging.i_print == 0:
            row = dict(metrics)
            row.update(timer.summary())
            exp.logger.log(step_now, row)
        if ckpt_dir and step_now % cfg.logging.i_weights == 0:
            save_checkpoint(ckpt_dir, exp.state, optim_meta=optim_knobs(cfg))
        if eval_hooks and exp.logger:
            _eval_hooks(exp, step_now)
    return exp.state, metrics


def _eval_hooks(exp: NerfExperiment, step_now: int) -> None:
    cfg = exp.cfg
    camera = exp.state.params.get("camera")
    if step_now % cfg.logging.i_testset == 0:
        res = evaluate_test_views(exp, max_views=2)
        res.update(evaluate_prd(exp))
        # The GT-filtered val-protocol PRD (the reference runs its full
        # projected_ray_distance_evaluation at every i_testset).
        res.update(evaluate_prd_split(exp, mode="val"))
        exp.logger.log(step_now, {f"test/{k}": v for k, v in res.items()})
    if step_now % cfg.logging.i_img == 0 and len(exp.i_test):
        # One validation render (the reference's i_img hook): PSNR logged,
        # PNG written.
        idx = int(exp.i_test[0])
        c2w = aligned_eval_extrinsic(exp, idx) if camera is not None else exp.gt_poses[idx]
        out = render_image(exp, c2w)
        exp.logger.log(step_now, {"val/psnr": _psnr(out["rgb"], exp.images[idx])})
        write_png(os.path.join(exp.logger.expdir, f"val_{step_now:08d}.png"), to8b(out["rgb"]))
    if step_now % cfg.logging.camera_log == 0 and camera is not None:
        exp.logger.log(step_now, camera_log_dict(camera, gt_K=exp.gt_intrinsic))
        exp.logger.log_images(step_now, camera_log_images(camera))


def render_training_video(exp: NerfExperiment, step: int, out_dir: str | None = None,
                          max_frames: int | None = None):
    """The ``i_video`` hook: not ported yet."""
    raise NotImplementedError(
        "render_training_video needs tools/video.py, which a later slice of the port brings")


@torch.no_grad()
def evaluate_prd(exp: NerfExperiment) -> dict:
    """Train-mode PRD over the train-split feasible pairs (the calibration
    signal logged during training, no GT involved)."""
    if exp.match_cache is None or exp.pair_list is None or len(exp.pair_list) == 0:
        return {}
    camera = exp.state.params.get("camera")
    if camera is None:
        return {}

    def rays_eval(kps, idx):
        return pixels_to_rays(camera, kps[:, 0], kps[:, 1], image_idx=idx)

    with fp32():
        val = prd_evaluation(
            exp.pair_list, exp.match_cache, rays_eval, get_intrinsic(camera),
            get_extrinsics(camera), mode="train", method="NeRF",
            max_matches=exp.cfg.camera.match_num,
            threshold=exp.cfg.camera.proj_ray_dist_threshold, device=exp.device,
        )
    return {"prd": val} if np.isfinite(val) else {}


def _eval_split_matches(exp: NerfExperiment, split: np.ndarray):
    """Feasible pairs + correspondences between the eval-split images,
    built once and cached on the experiment (split-local indices)."""
    if exp.eval_pair_list is not None:
        return exp.eval_pair_list, exp.eval_match_cache
    pairs = image_pair_candidates(exp.gt_poses[split], exp.cfg.camera.pairing_angle_threshold)
    pair_list = flatten_pairs(pairs)
    cache = PrecomputedMatches()
    if len(pair_list) and sift_available():
        cache = build_match_cache(exp.images[split], pair_list, SIFTMatcher())
    exp.eval_pair_list, exp.eval_match_cache = pair_list, cache
    return pair_list, cache


@torch.no_grad()
def evaluate_prd_split(exp: NerfExperiment, mode: str = "val",
                       split: np.ndarray | None = None) -> dict:
    """GT-filtered PRD over the held-out split, the reference's headline
    calibration-metric protocol (its ``model/prd_evaluation.py``):

    - feasible pairs among the split's images (GT poses, angle threshold);
    - keep only matches the GT camera triangulates to < 1 px reprojection
      error both ways with positive ray parameters;
    - PRD in clamp mode with the evaluated camera's intrinsics and noise but
      the GT extrinsic for each view.
    """
    if mode not in ("val", "test"):
        raise ValueError(f"mode must be val or test, got {mode!r}")
    split = np.asarray(exp.i_test if split is None else split)
    if len(split) < 2:
        return {}
    pair_list, cache = _eval_split_matches(exp, split)
    if len(pair_list) == 0 or cache is None:
        return {}

    camera = exp.state.params.get("camera")
    gt_E = torch.as_tensor(exp.gt_poses[split], dtype=torch.float32, device=exp.device)
    gt_focal = float(exp.gt_intrinsic[0, 0])

    def rays_gt(kps, local_idx):
        return rays_no_camera(exp.H, exp.W, gt_focal, gt_E[local_idx], kps[:, 0], kps[:, 1])

    with fp32():
        if camera is not None:
            K_eval = get_intrinsic(camera)

            def rays_eval(kps, local_idx):
                return pixels_to_rays(camera, kps[:, 0], kps[:, 1], c2w=gt_E[local_idx])
        else:
            K_eval = exp.gt_intrinsic

            def rays_eval(kps, local_idx):
                return rays_no_camera(exp.H, exp.W, exp.noisy_focal, gt_E[local_idx],
                                      kps[:, 0], kps[:, 1])

        val = prd_evaluation(
            pair_list, cache, rays_eval, K_eval, gt_E, mode=mode, method="NeRF",
            rays_gt=rays_gt, gt_K=exp.gt_intrinsic, gt_E=gt_E,
            max_matches=exp.cfg.camera.match_num,
            threshold=exp.cfg.camera.proj_ray_dist_threshold, device=exp.device,
        )
    return {f"prd_{mode}": val} if np.isfinite(val) else {}


@torch.no_grad()
def aligned_eval_extrinsic(exp: NerfExperiment, image_idx: int) -> torch.Tensor:
    """Pose for rendering a val/test view with the learned camera, ``(4, 4)``
    on the device: the learned train poses aligned to the GT train poses by
    a Sim(3) (ATE alignment), and the GT pose of ``image_idx`` carried into
    the learned frame (the reference's ``run_nerf.py:646-660``)."""
    camera: Camera = exp.state.params["camera"]

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=exp.device)

    with fp32():
        _, (s, R, t) = align_c2w_trajectories(tensor(exp.gt_poses[exp.i_train]),
                                              get_extrinsics(camera))
        return apply_sim3(tensor(exp.gt_poses[image_idx:image_idx + 1]), s, R, t)[0]


def render_pixels(exp: NerfExperiment, c2w, px: torch.Tensor, py: torch.Tensor,
                  camera_rays: bool = True) -> dict[str, torch.Tensor]:
    """Eval-mode render of the pixels ``(px, py)`` (flat, on the device) of
    the view ``c2w``: rays through the learned camera (or the fixed one),
    the NDC warp, the chunked coarse+fine render; flat maps on the device,
    rgb clamped at 1 (the reference's ``batchify_rays``)."""
    eval_cfg = exp.render_cfg.eval_mode()
    camera = exp.state.params.get("camera")
    if not isinstance(c2w, torch.Tensor):
        c2w = torch.from_numpy(np.array(c2w, np.float32))
    c2w = c2w.to(device=exp.device, dtype=torch.float32)
    with fp32_inference():
        if camera is not None and camera_rays:
            rays_o, rays_d = pixels_to_rays(camera, px, py, c2w=c2w)
        else:
            rays_o, rays_d = rays_no_camera(exp.H, exp.W, exp.noisy_focal, c2w, px, py)
        viewdirs = rays_d / (torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True) + 1e-10)
        if exp.train_cfg.use_ndc:
            if camera is not None:
                K = get_intrinsic(camera)
                fx, fy = K[0, 0], K[1, 1]
            else:
                fx = fy = exp.noisy_focal
            rays_o, rays_d = ndc_rays(exp.H, exp.W, fx, fy, 1.0, rays_o, rays_d)
        out = render_chunked(
            exp.state.params, exp.model_cfg, eval_cfg, rays_o, rays_d,
            viewdirs if eval_cfg.use_viewdirs else None, exp.near, exp.far,
        )
        for k in ("rgb", "rgb0"):
            if k in out:
                out[k] = torch.clamp(out[k], max=1.0)
    return out


def render_image(exp: NerfExperiment, c2w, camera_rays: bool = True) -> dict[str, np.ndarray]:
    """Full-image eval-mode render (:func:`render_pixels` on every pixel):
    ``(H, W, 3)`` rgb and the other maps, each copied to the host once."""
    px, py = full_image_pixels(exp.H, exp.W, device=exp.device)
    out = render_pixels(exp, c2w, px, py, camera_rays=camera_rays)
    return {k: v.cpu().numpy().reshape((exp.H, exp.W) + tuple(v.shape[1:]))
            for k, v in out.items()}


def _psnr(rgb: np.ndarray, target: np.ndarray) -> float:
    return float(mse2psnr(img2mse(torch.from_numpy(rgb), torch.from_numpy(target))))


def evaluate_test_views(exp: NerfExperiment, max_views: int | None = None) -> dict:
    """Mean PSNR and SSIM over the test split (ATE-aligned when a camera is
    learned), and the number of views. LPIPS is not ported yet; the JAX
    package reports none either without VGG weights."""
    psnrs, ssims = [], []
    views = exp.i_test[:max_views] if max_views else exp.i_test
    for idx in views:
        idx = int(idx)
        if exp.state.params.get("camera") is not None:
            c2w = aligned_eval_extrinsic(exp, idx)
        else:
            c2w = exp.gt_poses[idx]
        rgb = render_image(exp, c2w)["rgb"]
        target = exp.images[idx]
        psnrs.append(_psnr(rgb, target))
        ssims.append(float(ssim(torch.from_numpy(rgb).to(exp.device),
                                torch.from_numpy(target).to(exp.device))))
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
            "n_views": len(psnrs)}
