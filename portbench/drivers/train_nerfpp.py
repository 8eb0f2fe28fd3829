"""The NeRF++ training loop of the port,
``train/nerfpp_driver.py:run_nerfpp_training(cfg, expdir, n, exp=exp)``,
one step a call.

Set-up writes the seeded NeRF++ scene into the run's directory, builds the
experiment from the configuration's flags (``build_nerfpp_experiment``),
writes the seeded leaves into it, puts its step (and Adam's count, as a
resume would) at the mix's ``start_step``, runs the checked steps
(recorded) and the warm-up steps. The window then calls the loop until its
seconds are up. The reference (``portbench/reference``) follows the
checked steps from the same leaves, with the batches' image and pixel draws
and its own scene, camera and targets; the draws themselves are checked
apart (``training.py``).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from portbench import scene as scenes
from portbench import training
from portbench.harness import flags_of
from portbench.metrics import counts

K2 = "scnerf_tpu_torch::sample_pdf_fwd"
MIN_DEPTH = 1e-4  # the loader's fg near bound where a scene has no min_depth maps


def prd_at(flags: dict):
    """Whether the loop takes a PRD step at iteration ``it``."""
    on = flags["ray_loss_type"] == "proj_ray_dist"

    def at(it: int) -> bool:
        return on and it >= flags["add_prd"] and it % max(flags.get("i_ray_dist_loss", 10),
                                                          1) == 0
    return at


def prepare(run) -> dict:
    from scnerf_tpu_torch.core.config import experiment_from_flags
    from scnerf_tpu_torch.train import nerfpp_driver as program
    from scnerf_tpu_torch.train.optim import trainable_leaves

    flags = flags_of(run.config)
    if prd_at(flags)(run.mix["start_step"] + run.mix["checked_steps"]):
        raise ValueError("the NeRF++ reference here follows plain steps only")
    datadir = os.path.join(run.tmpdir, "scenes")
    scene = scenes.write_truck_scene(os.path.join(datadir, flags["scene"]),
                                     run.sub_seed("scene"), run.config["scene"])
    expdir = os.path.join(run.tmpdir, "exp")
    os.makedirs(expdir, exist_ok=True)
    program_seed = run.sub_seed("program")
    cfg = experiment_from_flags(
        {**flags, "datadir": datadir, "basedir": run.tmpdir, "expname": "exp",
         "seed": program_seed}, warn=lambda m: print(m, file=sys.stderr))
    exp = program.build_nerfpp_experiment(cfg, expdir, device=run.device)
    leaves = trainable_leaves(exp.state.params)
    weights = training.seeded_leaves({k: tuple(v.shape) for k, v in leaves.items()},
                                     run.sub_seed("weights"), run.mix["camera_noise"],
                                     run.device)
    training.write_leaves(leaves, weights)
    start = run.mix["start_step"]
    exp.state.step = exp.state.opt_state.count = start

    def call():
        program.run_nerfpp_training(cfg, expdir, exp.state.step + 1, exp=exp)

    recorder = training.Recorder(exp, run.mix["checked_steps"], trainable_leaves)
    for _ in range(run.mix["checked_steps"]):
        call()
    recorder.detach()
    for _ in range(run.mix["warmup_steps"]):
        call()
    training.sync(run.device)
    n_images, H, W = scene["images"].shape[:3]
    return {"exp": exp, "call": call, "flags": flags, "scene": scene, "weights": weights,
            "program_seed": program_seed, "start": start, "recorder": recorder,
            "draw": {"H": H, "W": W, "n_images": n_images}}


def reference_state(flags: dict, scene: dict, weights: dict, start: int, device, tf32: bool):
    """The reference's train state and plain step function, built from the
    configuration's flags, the scene's K and poses and the seeded leaves."""
    from portbench.reference import camera as rcam
    from portbench.reference import curriculum as rcur
    from portbench.reference import nerfpp as rnerfpp
    from portbench.reference import nerfpp_renderer as rrender
    from portbench.reference import optim as ropt
    from portbench.reference import step as rstep

    model_cfg = rnerfpp.NerfPPConfig(depth=flags["netdepth"], width=flags["netwidth"],
                                     max_freq_log2=flags["max_freq_log2"],
                                     max_freq_log2_viewdirs=flags["max_freq_log2_viewdirs"])
    render_cfg = rrender.NerfPPRenderConfig(
        cascade_samples=tuple(flags["cascade_samples"]), perturb=flags["perturb"],
        chunk=flags["chunk_size"])
    train_cfg = rstep.NerfPPTrainConfig(
        lr_init=flags["lrate"], lr_decay_steps=float(flags["lrate_decay_steps"] * 1000),
        lr_decay_factor=flags["lrate_decay_factor"], weight_decay=0.0,
        autoexpo=flags["autoexpo"])
    if flags["use_custom_optim"]:
        raise ValueError("the NeRF++ reference here takes no custom optimizer")
    curriculum = rcur.Curriculum(add_ie=flags["add_ie"], add_od=flags["add_od"],
                                 add_prd=flags["add_prd"])
    optimizer = ropt.Optimizer(train_cfg.lr_init, train_cfg.lr_decay_steps,
                               decay_factor=train_cfg.lr_decay_factor,
                               lr_floor=0.01 * train_cfg.lr_init)
    n_images = scene["poses"].shape[0]
    params = {"levels": [rnerfpp.init_nerfpp_net(model_cfg, n_images, device=device)
                         for _ in range(flags["cascade_level"])]}
    for x in ropt.named_leaves(params).values():
        x.requires_grad_(True)
    H, W = scene["images"].shape[1:3]
    cam_cfg = rcam.CameraConfig(
        H=H, W=W, grid_size=flags["grid_size"], convention=rcam.OPENCV, pixel_offset=0.5,
        multiplicative_noise=flags["multiplicative_noise"],
        intrinsics_noise_scale=flags["intrinsics_noise_scale"],
        ray_o_noise_scale=flags["ray_o_noise_scale"],
        ray_d_noise_scale=flags["ray_d_noise_scale"],
        extrinsics_noise_scale=flags["extrinsics_noise_scale"])
    params["camera"] = rcam.trainable_camera(rcam.init_camera(
        scene["K"].astype(np.float32), scene["poses"].astype(np.float32), cam_cfg,
        device=device))
    training.write_leaves(ropt.trainable_leaves(params), weights)
    state = rstep.TrainState(step=start, params=params, opt_state=optimizer.init(params))
    state.opt_state.count = start
    step = rstep.make_step_fn(
        rstep.nerfpp_loss_fn(model_cfg, render_cfg, train_cfg, curriculum),
        curriculum, optimizer, tf32=tf32)
    return state, step, optimizer


def reference_record(prep: dict, device, *, tf32: bool = False, fault=None) -> dict:
    """The reference over the checked steps: each step's image and pixels as
    the program drew them, its targets from the scene's images; losses,
    Adam's first moment after the first step, the leaves before and after.
    ``fault(batch) -> batch`` plants a fault in the reference's feed."""
    from portbench.reference import optim as ropt
    from portbench.reference import step as rstep

    flags, scene = prep["flags"], prep["scene"]
    state, step, optimizer = reference_state(flags, scene, prep["weights"], prep["start"],
                                             device, tf32)
    images = torch.from_numpy(scene["images"].astype(np.float32) / np.float32(255.0))
    losses, mu1 = [], None
    before = {k: v.detach().clone() for k, v in ropt.trainable_leaves(state.params).items()}
    for call in prep["calls"]:
        it = state.step
        b = call["batch"]
        px, py, img = (b[k].long().cpu() for k in ("px", "py", "img_idx"))
        batch = {"px": b["px"], "py": b["py"], "img_idx": b["img_idx"],
                 "target": images[img, py, px].to(device),
                 "min_depth": torch.full((px.shape[0],), MIN_DEPTH, device=device)}
        if fault is not None:
            batch = fault(batch)
        gen = rstep.step_generator(prep["program_seed"], it, device)
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        if mu1 is None:
            mu1 = {k: v.clone() for k, v in state.opt_state.mu.items()}
    after = {k: v.detach().clone() for k, v in ropt.trainable_leaves(state.params).items()}
    return {"losses": losses, "mu1": mu1, "before": before, "after": after,
            "b1": optimizer.b1}


def k2_bytes_per_step(flags: dict) -> int:
    """K2's bytes a train step: at each later level, the fg resample (which
    keeps its search counts and CDF for the backward) and the bg resample."""
    samples = list(flags["cascade_samples"])[:flags["cascade_level"]]
    n, total, depths = flags["N_rand"], 0, samples[0]
    for s in samples[1:]:
        total += counts.resample_bytes(n, depths, s, with_inds=True, with_cdf=True)
        total += counts.resample_bytes(n, depths, s)
        depths += s
    return total


def run(run) -> dict:
    prep = prepare(run)
    run.setup_done()
    flags = prep["flags"]
    return training.measure(
        run, prep, prd_at(flags),
        ray_flops=counts.train_flops_per_step(counts.nerfpp_ray_forward_flops(flags), 1),
        operator=K2, operator_bytes=k2_bytes_per_step(flags),
        reference_record=reference_record)
