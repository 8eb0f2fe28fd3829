"""Typed experiment configuration with reference-flag compatibility.

Port of ``scnerf_tpu/core/config.py``, a copy of that pure-Python module
(the port imports nothing of the JAX package): one typed config tree for
both pipelines; :func:`parse_config_file` reads the reference's ``key =
value`` txt files, so the configs under ``configs/`` run unchanged, and
:func:`experiment_from_flags` translates reference flag names into the tree,
warning on unknown keys instead of failing. Every file under ``configs/``
resolves to the same fields on both sides (``tests/test_torch_data.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any


def _parse_value(v: str) -> Any:
    v = v.strip()
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v.lower() in ("none", "null"):
        return None
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if "," in v and all(p.strip().lstrip("-").isdigit() for p in v.split(",")):
        return [int(p) for p in v.split(",")]
    return v


def parse_config_file(path: str) -> dict:
    """configargparse-style ``key = value`` txt (comments with #)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip().lstrip("-")] = _parse_value(v)
    return out


@dataclass
class DatasetConfig:
    dataset_type: str = "llff"  # llff | blender | nerfpp
    datadir: str = ""
    factor: int = 8
    llffhold: int = 8
    spherify: bool = False
    no_ndc: bool = False
    lindisp: bool = False
    half_res: bool = False
    white_bkgd: bool = False
    testskip: int = 8
    normalize_factor: float = 1.0  # NeRF++
    # noise injection
    initial_noise_size_intrinsic: float = 0.0
    initial_noise_size_rotation: float = 0.0
    initial_noise_size_translation: float = 0.0
    run_without_colmap: str = "none"


@dataclass
class ModelConfig:
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    multires: int = 10
    multires_views: int = 4
    use_viewdirs: bool = True
    # NeRF++
    cascade_level: int = 2
    cascade_samples: tuple = (64, 64)
    autoexpo: bool = False
    lambda_autoexpo: float = 1.0  # reference default (config_argparser.py:48)
    compute_dtype: str = "float32"
    # Weight the NeRF++ TRAIN loss by dataset masks. The reference never
    # does (masks are eval-only there; ddp_train_nerf.py:485-489) — this is
    # an opt-in extension, hence default False.
    mask_train_loss: bool = False


@dataclass
class SamplingConfig:
    N_rand: int = 1024
    N_samples: int = 64
    N_importance: int = 64
    perturb: bool = True
    raw_noise_std: float = 0.0
    chunk: int = 8192
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    # Reference default: batching ON (``no_batching`` is a store_true flag,
    # config_argparse.py:38; blender configs opt out, LLFF configs do not).
    use_batching: bool = True
    det: bool = False  # deterministic sampling at render (NeRF++ flag)
    # Sample pixel batches inside the compiled step (device PRNG + gather)
    # instead of per-step numpy — removes host-side work from the hot loop.
    device_sampling: bool = False


@dataclass
class CameraFlags:
    camera_model: str = "none"  # none | pinhole_rot_noise_10k_rayo_rayd[_dist]
    grid_size: int = 10
    # The two reference pipelines ship DIFFERENT defaults for the noise
    # scales (NeRF config_argparse.py: ray 1e-4, extrinsics 1.0; NeRF++
    # config_argparser.py: ray 1e-3, extrinsics 1e-2). None = "user did not
    # set it"; the drivers resolve per pipeline (resolved_noise_scales).
    ray_o_noise_scale: float | None = None
    ray_d_noise_scale: float | None = None
    intrinsics_noise_scale: float = 1.0
    extrinsics_noise_scale: float | None = None
    distortion_noise_scale: float = 1e-2
    multiplicative_noise: bool = False
    # curriculum
    add_ie: int = 0
    add_od: int = 0
    add_radial: int = 0
    add_prd: int = 0
    # PRD
    ray_loss_type: str = "none"  # none | proj_ray_dist
    run_fisheye: bool = False  # disables PRD (reference fisheye runs)
    i_ray_dist_loss: int = 10
    ray_dist_loss_weight: float = 1e-4
    proj_ray_dist_threshold: float = 5.0
    # Calibration-phase anneal of the PRD protocol (train/curriculum.py
    # prd_active/prd_cadence_at): when prd_anneal_until > 0, at that step
    # the weight/cadence return to the *_after values (published protocol).
    prd_anneal_until: int = 0
    ray_dist_loss_weight_after: float = 1e-4
    i_ray_dist_loss_after: int = 10
    # Distortion-aware PRD (losses/prd.py): off by default — the reference
    # left the undistortion path commented out (ray_dist_loss.py:188-199).
    prd_undistort: bool = False
    # EXTENSION: keep PRD active on fisheye runs (the reference skips it
    # because its PRD is distortion-blind, ddp_train_nerf.py:497; with
    # prd_undistort the projections are mapped through the differentiable
    # inverse lookup, so correspondences can drive k — the from-scratch
    # k-recovery recipe, docs/calibration_convergence.md round-4f).
    prd_on_fisheye: bool = False
    pairing_angle_threshold: float = 30.0
    matcher: str = "precomputed"  # precomputed | sift | superglue
    match_num: int = 1024
    # SuperGlue knobs (reference flag surface, config_argparse.py:131-158;
    # consumed by matching/superglue_hf.py when matcher == "superglue").
    superglue_weight: str = "outdoor"  # outdoor | indoor
    max_keypoints: int = 1024
    nms_radius: int = 4
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2
    keypoint_threshold: float = 0.005

    @property
    def use_camera(self) -> bool:
        return self.camera_model != "none"

    @property
    def use_distortion(self) -> bool:
        return "dist" in self.camera_model or "fisheye" in self.camera_model


@dataclass
class OptimConfig:
    lrate: float = 5e-4
    lrate_decay: int = 250  # NeRF: decay steps in thousands
    lrate_decay_factor: float = 0.1
    lrate_decay_steps: int = 750_000  # NeRF++, DIRECT steps. The reference
    # FLAG of the same name is in thousands (ddp_train_nerf.py:387
    # multiplies by 1000); the txt-shim loader converts (_apply_special).
    use_custom_optim: bool = False
    non_linear_weight_decay: float = 0.0
    # EXTENSION (no reference analogue): update multiplier on the camera's
    # global calibration leaves (intrinsics/extrinsics/distortion noise).
    # 1.0 = reference-exact shared LR. See train/optim.py:make_optimizer.
    camera_lrate_mult: float = 1.0
    # Anneal the multiplier back to 1.0 after this step (0 = hold forever).
    # A held mult drifts post-convergence (docs/calibration_convergence.md
    # round-4c); 5000 ≈ the measured convergence horizon at mult=8.
    camera_lrate_mult_until: int = 0
    # Post-anneal HOLD multiplier (default 1.0 = reference-exact): once the
    # camera is inside the identifiability floor the photometric camera
    # gradient is valley-floor noise and the camera random-walks at the
    # shared LR over long horizons (200k soak: focal 1.0%→1.6% between 25k
    # and 50k); hold < 1 damps the calibration leaves post-convergence
    # while the PRD anchor keeps them centered (optim._annealed_scale).
    camera_lrate_mult_hold: float = 1.0
    # EXTENSION: extra update multiplier on the distortion_noise leaf ONLY,
    # composing with camera_lrate_mult (effective k mult = product). The
    # from-scratch fisheye protocol must traverse |k1|=0.12 = 12 noise-units
    # at scale 1e-2 while focal needs only 0.05 — a 240x longer trip at the
    # same Adam velocity (docs/calibration_convergence.md round-4d/4f).
    distortion_lrate_mult: float = 1.0
    distortion_lrate_mult_until: int = 0
    distortion_lrate_mult_hold: float = 1.0
    N_iters: int = 200_001
    # camera-transfer (reference load_camera/load_test): checkpoint dir to
    # pull calibrated camera fields from; load_test also copies extrinsics.
    load_camera_path: str = ""
    load_test: bool = False
    # warm start (reference ft_path/ckpt_path) and resume control (no_reload).
    ckpt_path: str = ""
    no_reload: bool = False


@dataclass
class LoggingConfig:
    expname: str = "exp"
    basedir: str = "./logs"
    i_print: int = 100
    i_img: int = 500
    i_weights: int = 10_000
    i_testset: int = 50_000
    i_video: int = 50_000
    camera_log: int = 20_000
    use_wandb: bool = False
    debug: bool = False
    seed: int = 777


@dataclass
class ExperimentConfig:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    camera: CameraFlags = field(default_factory=CameraFlags)
    optim: OptimConfig = field(default_factory=OptimConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)

    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            return o

        return json.dumps(dataclasses.asdict(self), default=enc, indent=2)


# Reference flag name -> (section, field) for names that differ or live in
# non-obvious sections. Identical names resolve automatically.
_ALIASES = {
    "chunk_size": ("sampling", "chunk"),
    "netchunk_per_gpu": ("sampling", "chunk"),
    "max_freq_log2": ("model", "multires"),
    "max_freq_log2_viewdirs": ("model", "multires_views"),
    "alternate_frequency": ("camera", "i_ray_dist_loss"),
    "lambda_autoexpo": ("model", "lambda_autoexpo"),
    "ft_path": ("optim", "ckpt_path"),
}

# Flags needing translation beyond a rename.
def _apply_special(cfg: "ExperimentConfig", k: str, v) -> bool:
    if k == "no_batching":
        cfg.sampling.use_batching = not _truthy(v)
        return True
    if k == "use_camera":
        # NeRF++ bool flag; the camera model name may come from another line.
        if _truthy(v) and cfg.camera.camera_model == "none":
            cfg.camera.camera_model = "pinhole_rot_noise_10k_rayo_rayd"
        return True
    if k == "lrate_decay_steps":
        # Reference flag is in THOUSANDS of steps (ddp_train_nerf.py:387:
        # decay_steps = args.lrate_decay_steps * 1000); our field is direct.
        cfg.optim.lrate_decay_steps = int(float(v)) * 1000
        return True
    return False


def _truthy(v) -> bool:
    return v is True or (isinstance(v, str) and v.lower() == "true") or v == 1


def experiment_from_flags(flags: dict, warn=print) -> ExperimentConfig:
    """Build the config tree from a flat reference-style flag dict."""
    cfg = ExperimentConfig()
    sections = {
        "dataset": cfg.dataset,
        "model": cfg.model,
        "sampling": cfg.sampling,
        "camera": cfg.camera,
        "optim": cfg.optim,
        "logging": cfg.logging,
    }
    index = {}
    for sname, obj in sections.items():
        for f in dataclasses.fields(obj):
            index.setdefault(f.name, (sname, f.name))
    index.update(_ALIASES)

    # NeRF++ splits the data path across two flags; the loaders join them
    # (``ddp_train_nerf.py:332``: load_data_split(args.datadir, args.scene)).
    scene = flags.pop("scene", None)

    for k, v in flags.items():
        if k == "config":
            continue
        if _apply_special(cfg, k, v):
            continue
        if k in index:
            sname, fname = index[k]
            obj = sections[sname]
            cur = getattr(obj, fname)
            if isinstance(cur, tuple) and isinstance(v, (list, str)):
                v = tuple(int(x) for x in (v.split(",") if isinstance(v, str) else v))
            elif isinstance(cur, bool) and isinstance(v, (int, str)):
                v = bool(v) if not isinstance(v, str) else v.lower() == "true"
            elif isinstance(cur, float) and isinstance(v, int):
                v = float(v)
            setattr(obj, fname, v)
        else:
            warn(f"[config] ignoring unknown flag: {k} = {v}")
    if scene:
        cfg.dataset.datadir = os.path.join(cfg.dataset.datadir, str(scene))
    return cfg


def load_experiment(config_path: str | None = None, overrides: dict | None = None,
                    warn=print) -> ExperimentConfig:
    flags = {}
    if config_path:
        flags.update(parse_config_file(config_path))
    if overrides:
        flags.update(overrides)
    return experiment_from_flags(flags, warn=warn)


def resolved_noise_scales(camera: "CameraFlags", pipeline: str) -> dict:
    """Per-pipeline camera noise-scale defaults (None = not user-set).

    The reference's two trainers default differently: NeRF
    (``config_argparse.py:302-304``, ``:267-278``) uses ray 1e-4 /
    extrinsics 1.0; NeRF++ (``config_argparser.py:68-80``) uses ray 1e-3 /
    extrinsics 1e-2.
    """
    nerf = pipeline == "nerf"
    return {
        "ray_o_noise_scale": camera.ray_o_noise_scale
        if camera.ray_o_noise_scale is not None else (1e-4 if nerf else 1e-3),
        "ray_d_noise_scale": camera.ray_d_noise_scale
        if camera.ray_d_noise_scale is not None else (1e-4 if nerf else 1e-3),
        "extrinsics_noise_scale": camera.extrinsics_noise_scale
        if camera.extrinsics_noise_scale is not None else (1.0 if nerf else 1e-2),
    }
